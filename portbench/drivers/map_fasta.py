"""Read mapping from FASTA files, as ``map_reads`` does after its index
load: each request is one file of reads under the run's temporary
directory, hashed by ``read_kmers.hash_fasta_file`` (host read and
parse, upload, K1 on the card) and counted by ``KmerIndex.map_kmers``
(K2) into int64 node counts on the host."""
from __future__ import annotations

from portbench.lib import genome as gen, mapping


def _write(run, item, reads):
    path = run.workdir / f"reads{item}.fa"
    gen.write_fasta(path, reads.cpu().numpy())
    return str(path)


def setup(run):
    state = mapping.MapState(run, _write)
    mapping.warm_up(run, state, step)
    return state


def step(run, state, i: int) -> int:
    from graph_kmer_index_tpu_torch.read_kmers import hash_fasta_file

    item = i % len(state.pool)
    stages = {} if run.trace else None
    with run.spans.span("hash_fasta_file"):
        kmers = hash_fasta_file(state.pool[item], gen.K, device=run.device,
                                include_reverse_complements=True,
                                stage_seconds=stages)
    with run.spans.span("map_kmers"):
        counts = state.idx.index.map_kmers(kmers, state.n_nodes)
    if stages is not None:
        run.program_stages.append(stages)
    state.keep(i, item, kmers, counts)
    return len(kmers)


def yardstick(run, state) -> None:
    """A file of one tape segment: K2 runs once on its forward k-mers and
    once on their reverse complements."""
    mapping.yardstick(run, state, launches=2, hashed=True)


finish = mapping.finish
check = mapping.check
