"""UniqueKmerIndex: SNPs whose both nodes carry only globally-unique
kmers -> dict kmer->nodes (reference unique_kmer_index.py:8-76),
with the reference's per-row Python loops vectorized. The port's copy of
graph_kmer_index_tpu/models/unique_index.py; its file is a pickle of a
plain dict, which either package reads.
"""
from __future__ import annotations

import logging
import pickle
from collections import defaultdict

import numpy as np


class UniqueKmerIndex:
    def __init__(self, index_dict):
        self._index_dict = index_dict

    def to_file(self, file_name):
        with open(file_name, "wb") as f:
            pickle.dump(self._index_dict, f)

    @classmethod
    def from_file(cls, file_name):
        with open(file_name, "rb") as f:
            return cls(pickle.load(f))

    def get(self, kmer):
        return self._index_dict[kmer]

    @classmethod
    def from_flat_kmers_and_snps_graph(cls, flat_kmers, graph, reverse_index):
        flat = flat_kmers
        hashes = np.asarray(flat._hashes)
        ref_pos = np.asarray(flat._ref_offsets)

        # unique (hash, ref_pos) pairs, keeping the hash once per position
        pairs = np.stack([hashes.astype(np.uint64),
                          ref_pos.astype(np.uint64)], axis=1)
        _, first_idx = np.unique(pairs, axis=0, return_index=True)
        no_duplicates = hashes[np.sort(first_idx)]

        # snps: nodes with exactly 2 outgoing edges -> the 2 successors
        snps = [list(graph.get_edges(node))
                for node in range(graph.n_nodes())
                if len(graph.get_edges(node)) == 2]

        unique_vals, counts = np.unique(no_duplicates, return_counts=True)
        unique_kmers = set(unique_vals[counts == 1].tolist())

        def node_kmers_unique(node):
            kmers = reverse_index.get_node_kmers(node)
            return len(kmers) < 4 and all(int(k) in unique_kmers for k in kmers)

        unique_index = defaultdict(list)
        for nodes in snps:
            if node_kmers_unique(nodes[0]) and node_kmers_unique(nodes[1]):
                for node in nodes:
                    for kmer in reverse_index.get_node_kmers(node):
                        unique_index[int(kmer)].append(int(node))
        return cls(unique_index)
