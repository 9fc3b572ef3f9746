"""The dense index of a chromosome's variant graph, as ``graph_kmer_index
index`` builds it, through the port's own build: the graph of the
generated reference and variants (in arrays, numbered as ``genome.py``
numbers its nodes, the graph that ``build_graph_from_vcf`` makes of them)
-> ``CriticalGraphPaths.from_graph`` -> ``PositionId.from_graph`` ->
``find_kmers_parallel_device`` (the native span walker in spawned
workers, the rows expanded on the card) -> ``KmerIndex.from_flat_kmers``
(the bucket layout and the frequencies) -> the packed table, made by one
``map_kmers`` call at the end of the build.

In a traced run the build is recorded in a ``torch.profiler`` session of
its own; the port's spans and its find's counters are kept on the run as
``run.dense_build`` for the ``dense.*`` metrics.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from portbench.lib import dense_reference
from portbench.lib import genome as gen
from portbench.lib import trace as tracing

# the port's counters that the build's metrics read
FIND_COUNTERS = ("find.chunks", "find.walk_us", "find.first_result_us")


def graph_arrays(genome: gen.Genome) -> dict:
    """The keyword arrays of the port's ``Graph`` for the genome: node
    ``3i + 1`` the reference before variant ``i``, ``3i + 2`` its
    reference allele and ``3i + 3`` its alternative (either may hold no
    bases), ``3n + 1`` the reference after the last variant; a segment
    leads to its reference allele, then its alternative, and both lead to
    the next segment; the segments and the reference alleles are the
    linear reference. Made on the genome's device, returned as numpy."""
    ref, pos = genome.ref, genome.pos
    dev = ref.device
    rl = genome.ref_len.to(torch.int64)
    al = genome.alt_len.to(torch.int64)
    n_var = genome.n_variants
    n = genome.n_nodes
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    seg_lo = torch.cat([zero, pos + rl])
    seg_hi = torch.cat([pos, torch.tensor([ref.shape[0]], device=dev)])
    sizes = torch.zeros(n, dtype=torch.int64, device=dev)
    sizes[1::3] = seg_hi - seg_lo
    sizes[2::3] = rl
    sizes[3::3] = al
    seq_start = torch.cat([zero, torch.cumsum(sizes, 0)])
    sequence = torch.empty(int(seq_start[-1]), dtype=torch.int8, device=dev)
    # a segment and the reference allele after it are one slice of the
    # reference; the alternative's bases come between that slice and
    # the next
    alt_lo = seq_start[3 * torch.arange(n_var, device=dev) + 3]
    lens = seg_hi - seg_lo
    lens[:-1] += rl
    ref_lo = seq_start[1::3][:n_var + 1]
    block = 1 << 24
    for lo in range(0, n_var + 1, block):
        hi = min(n_var + 1, lo + block)
        length = lens[lo:hi]
        at = torch.repeat_interleave(ref_lo[lo:hi] - seg_lo[lo:hi], length)
        src = torch.arange(int(seg_lo[lo]), int(seg_lo[lo]) + int(
            length.sum()), device=dev)
        sequence[src + at] = ref[src]
    for j in range(genome.alt_bases.shape[1]):
        m = al > j
        sequence[alt_lo[m] + j] = genome.alt_bases[m, j]
    counts = torch.ones(n, dtype=torch.int64, device=dev)
    counts[1::3] = 2
    counts[0] = counts[-1] = 0
    edge_index = torch.cat([zero, torch.cumsum(counts, 0)])
    v = 3 * torch.arange(n_var, device=dev)
    edge_targets = torch.stack([v + 2, v + 3, v + 4, v + 4], 1).reshape(-1)
    node = torch.arange(n, device=dev)
    linear_ref = node % 3 != 0
    offsets = torch.zeros(n, dtype=torch.int64, device=dev)
    offsets[1::3] = seg_lo
    offsets[2::3] = pos
    offsets[3::3] = pos

    def host(t, dtype):
        return t.cpu().numpy().astype(dtype)

    return dict(
        node_sizes=host(sizes, np.uint32), sequence=host(sequence, np.int8),
        seq_start=host(seq_start, np.int64),
        edge_targets=host(edge_targets, np.int32),
        edge_index=host(edge_index, np.int64),
        linear_ref_mask=host(linear_ref, bool),
        ref_dummy_mask=np.zeros(n, dtype=bool),
        node_to_ref_offset=host(offsets, np.int64),
        allele_frequencies=np.ones(n, dtype=np.float64),
        chromosome_start_nodes_array=np.array([1], dtype=np.int32))


def find_workers(config: dict) -> int:
    """The configuration's find workers, or the CPUs this process may run
    on where they are fewer."""
    return max(1, min(int(config["find_workers"]),
                      len(os.sched_getaffinity(0))))


class DenseIndex:
    def __init__(self, run):
        dev = run.device
        config = run.config
        self.run = run
        self.modulo = int(config["modulo"])
        # the inputs' generator; set-up drops it once the reads are drawn
        self.genome = gen.make_genome(config, run.seed, dev)
        self.n_nodes = self.genome.n_nodes
        self.workers = find_workers(config)
        if run.trace:
            run.dense_build = self._traced_build(dev)
        else:
            self._build(dev)

    def _build(self, dev):
        from graph_kmer_index_tpu_torch import (CriticalGraphPaths, Graph,
                                                KmerIndex, PositionId)
        from graph_kmer_index_tpu_torch.parallel.host_pool import (
            find_kmers_parallel_device)

        config = self.run.config
        k = int(config["k"])
        graph = Graph(**graph_arrays(self.genome))
        cpaths = CriticalGraphPaths.from_graph(graph, k)
        flat = find_kmers_parallel_device(
            graph, k, self.workers, critical_paths=cpaths,
            position_id=PositionId.from_graph(graph), mp_context="spawn",
            device=dev, require_native=True,
            max_variant_nodes=int(config["max_variant_nodes"]),
            only_save_one_node_per_kmer=bool(
                config["only_save_one_node_per_kmer"]))
        del graph, cpaths
        self.n_rows = len(flat)
        self.index = KmerIndex.from_flat_kmers(flat, self.modulo, device=dev)
        del flat
        # the packed table is made at the first lookup: here, in the build
        self.index.map_kmers(np.zeros(4, dtype=np.uint64), self.n_nodes)

    def _traced_build(self, dev) -> dict:
        """The build under a profiler session of its own, the build as its
        window: the port's spans (seconds by name) and the find's
        counters, which are zeroed again after, so that the window's
        counters start from nothing."""
        from graph_kmer_index_tpu_torch.utils import profiling

        profiling.reset_counters()
        prof = tracing.start_profiler()
        with torch.profiler.record_function(tracing.WINDOW_SPAN):
            self._build(dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        spans = tracing.read_trace(prof)["spans"]
        counts = profiling.counters(dev)
        profiling.reset_counters()
        return {"spans": spans, "workers": self.workers,
                "counters": {name: counts[name] for name in FIND_COUNTERS
                             if name in counts}}

    def reference_rows(self, dev):
        """The reference's rows, from the configuration and the seed made
        anew: nothing of what set-up handed the port."""
        config = self.run.config
        genome = gen.make_genome(config, self.run.seed, dev)
        return dense_reference.dense_rows(
            genome, int(config["max_variant_nodes"]), int(config["k"]))


def make(run) -> DenseIndex:
    return DenseIndex(run)
