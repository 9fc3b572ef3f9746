"""Critical graph path positions (the port's copy of
graph_kmer_index_tpu/critical_paths.py).

A position (node, offset) is *critical* when every k-window ending there
sees a single path — i.e. the graph is locally linear for at least k bases.
Critical positions are the parallel-safe cut points: k-mer enumeration can
be sharded into independent segments between them with no halo exchange
(this is the multi-chip shard boundary, see SURVEY.md §5.7).

Semantics match the reference walk (critical_graph_paths.py:42-104),
pinned by tests/test_critical_graph_paths.py: walk the linear reference
per chromosome tracking bubble depth via in/out edge counts; when depth
returns to 0 on a non-dummy node and fewer than k bases have passed since
the last join, emit (node, k - bp_since_last_join - 1).
"""
from __future__ import annotations

import contextlib
import sys

import numpy as np


def _span(name: str):
    """The port's span ``name`` (utils/profiling.py) where torch is
    loaded. The host layer does not import torch, and without it no
    profiler session can be recording."""
    if "torch" not in sys.modules:
        return contextlib.nullcontext()
    from .utils import profiling
    return profiling.span(name)


class CriticalGraphPaths:
    def __init__(self, nodes, offsets, index=None):
        self.nodes = nodes
        self.offsets = offsets
        self._index = index
        self._dense_crit = None  # node -> offset (-1), length >= n_nodes
        self._seen_rev = None    # (nodes, offsets) int64, path order reversed

    @classmethod
    def empty(cls):
        return cls(np.array([], dtype=np.uint32), np.array([], dtype=np.uint16))

    def __len__(self):
        return len(self.nodes)

    def __iter__(self):
        return ((int(n), int(o)) for n, o in zip(self.nodes, self.offsets))

    def _make_index(self):
        if len(self.nodes) == 0:
            self._index = np.zeros(0, dtype=np.int32)
            return
        # node -> critical offset (-1 = none); at most one critical per node
        self._index = np.full(int(np.max(self.nodes)) + 1, -1, dtype=np.int32)
        self._index[self.nodes.astype(np.int64)] = self.offsets.astype(np.int32)

    def dense_index(self, n: int):
        """Dense node -> critical-offset map (-1 = none) covering at least
        ``n`` nodes, cached — the native walker consumes this every chunk,
        so a per-chunk np.full over the whole node space would make chunked
        finds O(n_nodes * n_chunks)."""
        if self._dense_crit is None or len(self._dense_crit) < n:
            if self._index is None:
                self._make_index()
            crit = np.full(max(n, len(self._index)), -1, dtype=np.int32)
            m = min(len(crit), len(self._index))
            crit[:m] = self._index[:m]
            self._dense_crit = crit
        return self._dense_crit

    def reversed_points(self):
        """(nodes, offsets) in reversed path order as int64 arrays, cached.
        This is the finder's seen-point set / worklist base; building it
        from python tuples per chunk was O(n_paths) per chunk."""
        if self._seen_rev is None:
            self._seen_rev = (
                np.ascontiguousarray(self.nodes[::-1], dtype=np.int64),
                np.ascontiguousarray(self.offsets[::-1], dtype=np.int64))
        return self._seen_rev

    def is_critical(self, node, offset) -> bool:
        if self._index is None:
            self._make_index()
        if node >= len(self._index):
            return False
        return self._index[node] == offset

    def to_file(self, file_name):
        np.savez(file_name, nodes=self.nodes, offsets=self.offsets)

    @classmethod
    def from_file(cls, file_name):
        try:
            data = np.load(file_name)
        except FileNotFoundError:
            data = np.load(str(file_name) + ".npz")
        return cls(data["nodes"], data["offsets"])

    @classmethod
    def from_graph(cls, graph, k):
        with _span("build.critical_paths"):
            return cls._from_graph(graph, k)

    @classmethod
    def _from_graph(cls, graph, k):
        critical_nodes: list[int] = []
        critical_offsets: list[int] = []

        node_sizes = graph.node_sizes
        for start_node in graph.chromosome_start_nodes.values():
            current = int(start_node)
            depth = 0
            bp_since_last_join = 0
            while True:
                prev_depth = depth
                depth -= graph.n_in_edges(current)
                if prev_depth > 1 and depth == 0:
                    bp_since_last_join = 0

                size = int(node_sizes[current])
                if depth == 0 and size != 0:
                    # NB: strictly < k. The reference uses <= k
                    # (critical_graph_paths.py:78), so bp == k yields
                    # offset -1 which silently wraps to 65535 in its
                    # uint16 array — a garbage duplicate cut point (the
                    # real one was already emitted at the previous node's
                    # last base). Newer numpy raises on the wrap.
                    if bp_since_last_join < k and bp_since_last_join + size >= k:
                        critical_nodes.append(current)
                        critical_offsets.append(k - bp_since_last_join - 1)

                next_nodes = graph.get_edges(current)
                depth += len(next_nodes)
                if len(next_nodes) == 0:
                    break
                if len(next_nodes) == 1:
                    bp_since_last_join += size
                    current = int(next_nodes[0])
                else:
                    # at a fork, follow the linear reference arm
                    ref_next = [int(v) for v in next_nodes
                                if graph.is_linear_ref_node_or_linear_ref_dummy_node(v)]
                    if len(ref_next) != 1:
                        raise ValueError(
                            "expected exactly 1 linear-ref successor of node "
                            f"{current}, got {ref_next} (edges {list(next_nodes)})")
                    current = ref_next[0]

        return cls(np.asarray(critical_nodes, dtype=np.uint32),
                   np.asarray(critical_offsets, dtype=np.uint16))
