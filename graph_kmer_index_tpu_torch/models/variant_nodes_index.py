"""VariantNodesIndex — ref-position range -> variant nodes (the port's
copy of graph_kmer_index_tpu/models/variant_nodes_index.py).

The reference ships this as DEAD code: `variant_nodes_index.py:13-14`
has an empty method body (SyntaxError on import), `from_graph` is a
bare `pass`, and its own npz round-trip is broken (`to_file` writes the
key ``ref_position`` while `from_file` reads ``ref_positions``,
variant_nodes_index.py:11,21). This module implements the evident
intent so the component exists and works:

- rows are (ref_position, variant_node) pairs, kept sorted by position;
- ``get_variant_nodes_between_ref_positions(a, b)`` returns the variant
  nodes whose position falls in ``[a, b)`` via searchsorted;
- ``from_graph`` collects every non-linear-ref node (the variant
  alleles, including zero-length indel dummies off the reference path)
  with its reference start coordinate;
- file I/O accepts BOTH key spellings so npz files written by the
  reference's ``to_file`` load here.
"""
from __future__ import annotations

import numpy as np


class VariantNodesIndex:
    properties = {"ref_positions", "variant_nodes"}

    def __init__(self, ref_positions=None, variant_nodes=None):
        ref_positions = np.asarray(
            ref_positions if ref_positions is not None else [],
            dtype=np.uint64)
        variant_nodes = np.asarray(
            variant_nodes if variant_nodes is not None else [],
            dtype=np.uint32)
        order = np.argsort(ref_positions, kind="stable")
        self.ref_positions = ref_positions[order]
        self.variant_nodes = variant_nodes[order]

    def get_variant_nodes_between_ref_positions(self, ref_start, ref_end):
        """Variant nodes at reference positions in [ref_start, ref_end)."""
        lo = np.searchsorted(self.ref_positions, np.uint64(ref_start),
                             side="left")
        hi = np.searchsorted(self.ref_positions, np.uint64(ref_end),
                             side="left")
        return self.variant_nodes[lo:hi]

    @classmethod
    def from_graph(cls, graph):
        """Every node off the linear reference path, positioned at its
        reference start coordinate (graph.node_to_ref_offset)."""
        mask = ~(np.asarray(graph.linear_ref_mask, dtype=bool)
                 | np.asarray(graph.ref_dummy_mask, dtype=bool))
        mask[0] = False  # node ids are 1-based; slot 0 is padding
        nodes = np.flatnonzero(mask).astype(np.uint32)
        positions = np.asarray(graph.node_to_ref_offset)[nodes].astype(
            np.uint64)
        return cls(positions, nodes)

    def to_file(self, file_name):
        np.savez(file_name, ref_positions=self.ref_positions,
                 variant_nodes=self.variant_nodes)

    @classmethod
    def from_file(cls, file_name):
        try:
            data = np.load(file_name)
        except FileNotFoundError:
            data = np.load(str(file_name) + ".npz")
        # the reference's writer/reader disagree on this key
        # (variant_nodes_index.py:11 vs :21); accept both spellings
        key = ("ref_positions" if "ref_positions" in data
               else "ref_position")
        return cls(data[key], data["variant_nodes"])
