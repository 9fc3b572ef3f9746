"""ReverseKmerIndex: node -> its kmers (+ ref positions), CSR by node
(the port's copy of graph_kmer_index_tpu/models/reverse_index.py).

Same layout and file format as the reference (reverse_kmer_index.py:5-84):
argsort by node + ediff1d segment boundaries.
"""
from __future__ import annotations

import numpy as np


class ReverseKmerIndex:
    properties = {"nodes_to_index_positions", "nodes_to_n_hashes", "hashes",
                  "ref_positions"}

    def __init__(self, nodes_to_index_positions=None, nodes_to_n_hashes=None,
                 hashes=None, ref_positions=None):
        self.nodes_to_index_positions = nodes_to_index_positions
        self.nodes_to_n_hashes = nodes_to_n_hashes
        self.hashes = hashes
        self.ref_positions = ref_positions

    def __str__(self):
        return ("Nodes to index positions: %s\n"
                "Nodes to n hashes      : %s\n"
                "Hashes:                  %s\n"
                "Ref positions:                  %s\n" % (
                    self.nodes_to_index_positions, self.nodes_to_n_hashes,
                    self.hashes, self.ref_positions))

    def get_node_kmers(self, node):
        start = int(self.nodes_to_index_positions[node])
        n = int(self.nodes_to_n_hashes[node])
        if n == 0:
            return []
        return self.hashes[start:start + n]

    def get_node_kmers_and_ref_positions(self, node):
        start = int(self.nodes_to_index_positions[node])
        n = int(self.nodes_to_n_hashes[node])
        if n == 0:
            return [[], []]
        return (self.hashes[start:start + n],
                self.ref_positions[start:start + n])

    @classmethod
    def from_flat_kmers(cls, flat_kmers):
        nodes = np.asarray(flat_kmers._nodes)
        kmers = np.asarray(flat_kmers._hashes)
        ref_positions = np.asarray(flat_kmers._ref_offsets)

        if len(nodes) == 0:
            return cls(np.zeros(1, np.uint32), np.zeros(1, np.uint16),
                       kmers, ref_positions)
        max_node = int(np.max(nodes))
        order = np.argsort(nodes, kind="stable")
        nodes_s, kmers_s = nodes[order], kmers[order]
        ref_s = ref_positions[order]

        diffs = np.ediff1d(nodes_s, to_begin=nodes_s.dtype.type(1))
        starts = np.nonzero(diffs)[0]
        unique_nodes = nodes_s[starts].astype(np.int64)
        index = np.zeros(max_node + 1, dtype=np.uint32)
        n_kmers = np.zeros(max_node + 1, dtype=np.uint16)
        index[unique_nodes] = starts
        n_kmers[unique_nodes] = np.ediff1d(
            starts, to_end=len(nodes_s) - starts[-1])
        return cls(index, n_kmers, kmers_s, ref_s)

    def to_file(self, file_name):
        np.savez(file_name,
                 nodes_to_index_positions=self.nodes_to_index_positions,
                 nodes_to_n_hashes=self.nodes_to_n_hashes,
                 hashes=self.hashes, ref_positions=self.ref_positions)

    @classmethod
    def from_file(cls, file_name):
        try:
            data = np.load(file_name)
        except FileNotFoundError:
            data = np.load(str(file_name) + ".npz")
        return cls(data["nodes_to_index_positions"],
                   data["nodes_to_n_hashes"], data["hashes"],
                   data["ref_positions"])
