"""Extra k-mer sampling from large structural-variant nodes (reference
structural_variants.py:6-42); the port's copy of
graph_kmer_index_tpu/structural_variants.py.

For every variant allele node longer than k+5: hash all node-interior
windows with the sliding-window kernel (the reference shells out to the
external ``bionumpy`` package here — our own kernel replaces it), keep
windows whose frequency in the supplied index is below ``max_frequency``,
then greedily choose non-overlapping windows (stride >= k).
"""
from __future__ import annotations

import numpy as np

from .flat_kmers import FlatKmers
from .hashing import sliding_window_hashes


def sample_kmers_from_structural_variants(graph, variant_to_nodes,
                                          kmer_index_with_frequencies, k,
                                          max_frequency=2):
    kmers_found = []
    nodes_found = []
    ref_offsets_found = []

    for ref_node, var_node in variant_to_nodes:
        for node in (int(ref_node), int(var_node)):
            if graph.get_node_size(node) <= k + 5:
                continue
            node_sequence = np.asarray(
                graph.get_numeric_node_sequence(node), dtype=np.uint64)
            node_kmers = sliding_window_hashes(node_sequence, k)
            kmer_frequencies = np.asarray(
                kmer_index_with_frequencies.get_frequencies(node_kmers))
            valid = np.where(kmer_frequencies < max_frequency)[0]

            # greedy non-overlapping selection
            chosen = []
            prev = -10000
            for v in valid:
                if v >= prev + k:
                    chosen.append(int(v))
                    prev = int(v)

            if chosen:
                kmers_found.extend(node_kmers[chosen])
                nodes_found.extend([node] * len(chosen))
                ref_offsets_found.extend([0] * len(chosen))

    return FlatKmers(np.array(kmers_found, dtype=np.uint64),
                     np.array(nodes_found, dtype=np.uint32),
                     np.array(ref_offsets_found, dtype=np.uint32))
