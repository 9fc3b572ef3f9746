"""The yardstick's roofline arithmetic, frozen here so that a change to the
port cannot move it: the card's published peak, the least time a call
could take, and the bytes that kernels K1 (``csrc/sliding_hash.cu``) and
K2 (``csrc/packed_lookup.cu``) must move, computed from shapes and from
the reference's own rows, never from a table the port built.

Copied from ``chip_smoke.py`` (``bound``, ``BYTES_PER_BASE``,
``k2_bytes``, ``classify``; ``k2_bytes`` counts the counts that K2
writes, not all of them) and ``ops/packed_layout.py``
(``internal_modulo``, the classes), in torch only.
"""
from __future__ import annotations

import torch

# NVIDIA's H100 SXM data sheet: 3.35 TB/s of device memory, at the full
# 700 W power limit (a run records the card's own limit beside it)
PEAK_BYTES_PER_S = 3.35e12
# K1 reads one byte a base and writes one int64 hash a base
K1_BYTES_PER_BASE = 1 + 8
# K2, per query: the 8-byte query and one 32-byte record
K2_BYTES_PER_QUERY = 8 + 32
# K2 adds to one int64 count a node that its queries hit (the counts are
# zeroed before K2, outside it); a scanned or matched row is 8 bytes
COUNT_BYTES = 8
ROW_BYTES = 8


def bound_seconds(nbytes: float) -> float:
    """The least time the card could take to move ``nbytes`` once."""
    return nbytes / PEAK_BYTES_PER_S


def roofline_percent(nbytes: float, device_seconds: float):
    """Share of the bytes bound, in percent: the bound's time over the
    kernel's device time (None without device time)."""
    if device_seconds <= 0:
        return None
    return bound_seconds(nbytes) / device_seconds * 100.0


def k1_bytes(n_bases: int) -> int:
    return K1_BYTES_PER_BASE * int(n_bases)


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def internal_modulo(n_rows: int) -> int:
    """The packed table's bucket count: the next prime >= max(67,
    2 * n_rows + 1)."""
    m = max(67, 2 * n_rows + 1)
    while not _is_prime(m):
        m += 1
    return m


class BucketSizes:
    """Rows per internal bucket of an index's k-mers, and which buckets
    of two rows hold one k-mer twice ("dup2"), from the rows alone; the
    rows' k-mers and nodes sorted by k-mer."""

    def __init__(self, kmers: torch.Tensor, nodes: torch.Tensor):
        self.modulo2 = internal_modulo(kmers.shape[0])
        b = kmers % self.modulo2
        order = torch.sort(b).indices
        b, km = b[order], kmers[order]
        self.buckets, size = torch.unique_consecutive(b, return_counts=True)
        self.size = size
        first = torch.cumsum(size, 0) - size
        two = size == 2
        self.dup2 = torch.zeros_like(two)
        self.dup2[two] = km[first[two]] == km[first[two] + 1]
        self.dup2_kmer = torch.full_like(size, -1)
        self.dup2_kmer[self.dup2] = km[first[self.dup2]]
        order = torch.sort(kmers).indices
        self.sorted_kmers = kmers[order]
        self.sorted_nodes = nodes[order]

    def lookup(self, q: torch.Tensor):
        """(rows in each query's bucket, whether it is a dup2 bucket that
        holds the query)."""
        b = q % self.modulo2
        pos = torch.searchsorted(self.buckets, b).clamp(
            max=self.buckets.shape[0] - 1)
        found = self.buckets[pos] == b
        size = torch.where(found, self.size[pos], 0)
        dup2_hit = found & self.dup2[pos] & (self.dup2_kmer[pos] == q)
        return size, dup2_hit


def k2_bytes(sizes: BucketSizes, q: torch.Tensor, n_nodes: int) -> int:
    """Bytes a packed lookup (counts mode) of queries ``q`` must move: per
    query 8 of query and one 32-byte record; for every distinct k-mer
    that its record does not answer (a bucket of more than two rows, or a
    dup2 bucket that holds it) the k-mers of its bucket's rows and the
    nodes of the rows that match; and one 8-byte count for every node
    below ``n_nodes`` that the queries hit.

    ``chip_smoke.py``'s ``k2_bytes`` counts all ``n_nodes`` counts
    instead; K2 does not write them (``torch.zeros`` does, before it), so
    on queries that mostly miss that count would let a faster K2 read
    above its bound."""
    size, dup2_hit = sizes.lookup(q)
    uniq = torch.unique(q[(size > 2) | dup2_hit])
    scanned = int(sizes.lookup(uniq)[0].sum()) if uniq.numel() else 0
    lo = torch.searchsorted(sizes.sorted_kmers, uniq)
    hi = torch.searchsorted(sizes.sorted_kmers, uniq, right=True)
    matched = int((hi - lo).sum())
    return (q.shape[0] * K2_BYTES_PER_QUERY
            + (scanned + matched) * ROW_BYTES
            + hit_nodes(sizes, q, n_nodes) * COUNT_BYTES)


def hit_nodes(sizes: BucketSizes, q: torch.Tensor, n_nodes: int) -> int:
    """Distinct nodes below ``n_nodes`` of the rows whose k-mer is among
    the queries."""
    uq = torch.unique(q)
    if not uq.numel():
        return 0
    pos = torch.searchsorted(uq, sizes.sorted_kmers).clamp(
        max=uq.shape[0] - 1)
    match = (uq[pos] == sizes.sorted_kmers) & (sizes.sorted_nodes < n_nodes)
    return int(torch.unique(sizes.sorted_nodes[match]).numel())
