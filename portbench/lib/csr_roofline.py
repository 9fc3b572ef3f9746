"""The bytes that a CSR lookup of node counts must move, frozen here so that
a change to the port cannot move them: the yardstick of the CSR lookup
layer (``ops/lookup.py``'s bucket scan, or a hand kernel that takes its
place), computed from the queries and the reference's own rows, never
from a table the port built or from its counters.

A CSR lookup keeps the rows sorted by bucket under the reference modulo
and one (start, size) pair a bucket. Following ``roofline.k2_bytes``, a
batch of queries in counts mode must move at least:

- per query, its 8-byte k-mer and its bucket's start and size (two int32,
  8 bytes);
- per distinct query k-mer, the k-mers of its bucket's rows (8 bytes a
  row) and the nodes of the rows that match it (8 bytes a row);
- one 8-byte count for every distinct node below ``n_nodes`` that the
  queries hit.
"""
from __future__ import annotations

import torch

QUERY_BYTES = 8
RANGE_BYTES = 4 + 4
ROW_BYTES = 8
COUNT_BYTES = 8
# reference rows handled at once
ROW_BLOCK = 1 << 26


class CsrTable:
    """The reference's rows (k-mers and nodes, in any order) and the size
    of every bucket under ``modulo``, counted from the rows."""

    def __init__(self, kmers: torch.Tensor, nodes: torch.Tensor,
                 modulo: int):
        self.kmers, self.nodes = kmers, nodes
        self.modulo = int(modulo)
        self.sizes = torch.zeros(self.modulo, dtype=torch.int64,
                                 device=kmers.device)
        for lo in range(0, kmers.shape[0], ROW_BLOCK):
            b = kmers[lo:lo + ROW_BLOCK] % self.modulo
            self.sizes.index_add_(0, b, torch.ones_like(b))

    def bucket_sizes(self, q: torch.Tensor) -> torch.Tensor:
        return self.sizes[q % self.modulo]


def nonempty_queries(table: CsrTable, q: torch.Tensor) -> int:
    """Queries whose bucket holds a row: those a CSR lookup scans."""
    return int((table.bucket_sizes(q) > 0).sum())


def csr_bytes(table: CsrTable, q: torch.Tensor, n_nodes: int) -> int:
    """Bytes a CSR lookup of node counts for the queries ``q`` must move
    (the module's docstring)."""
    uq = torch.unique(q)
    if not uq.numel():
        return 0
    scanned = int(table.bucket_sizes(uq).sum())
    matched = 0
    hit = torch.zeros(n_nodes, dtype=torch.bool, device=q.device)
    for lo in range(0, table.kmers.shape[0], ROW_BLOCK):
        km = table.kmers[lo:lo + ROW_BLOCK]
        nd = table.nodes[lo:lo + ROW_BLOCK].to(torch.int64)
        pos = torch.searchsorted(uq, km).clamp(max=uq.shape[0] - 1)
        match = uq[pos] == km
        matched += int(match.sum())
        hit[nd[match & (nd >= 0) & (nd < n_nodes)]] = True
    return (q.shape[0] * (QUERY_BYTES + RANGE_BYTES)
            + (scanned + matched) * ROW_BYTES
            + int(hit.sum()) * COUNT_BYTES)
