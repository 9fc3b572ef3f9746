"""Read mapping from k-mer hashes already in host memory, as a caller of
kmer_mapper's ``map_kmers_to_graph_index(index, n_nodes, kmers)`` does
(the port's ``KmerIndex.map_kmers``): each request is the uint64 hashes
of one file's reads, both strands, handed to ``map_kmers``, which
uploads them, counts them by K2 and returns int64 node counts on the
host. No FASTA is parsed and nothing is hashed on the card."""
from __future__ import annotations

import numpy as np

from portbench.lib import mapping, reference


def _hash(run, item, reads):
    return reference.batch_hashes(reads).cpu().numpy().view(np.uint64)


def setup(run):
    state = mapping.MapState(run, _hash)
    mapping.warm_up(run, state, step)
    return state


def step(run, state, i: int) -> int:
    item = i % len(state.pool)
    with run.spans.span("map_kmers"):
        counts = state.idx.index.map_kmers(state.pool[item], state.n_nodes)
    state.keep(i, item, None, counts)
    return int(state.pool[item].shape[0])


def yardstick(run, state) -> None:
    """``map_kmers`` on a host array runs K2 once over all of it."""
    mapping.yardstick(run, state, launches=1, hashed=False)


finish = mapping.finish
check = mapping.check
