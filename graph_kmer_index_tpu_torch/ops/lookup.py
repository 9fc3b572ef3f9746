"""Packed-record lookup: the port of graph_kmer_index_tpu/ops/lookup.py's
packed path (build, decode, deep-bucket scan, ultra-deep resolution).

The table lives under an INTERNAL modulo (next prime >= 2n+1, load factor
<= 0.5) as one 32-byte record per bucket, stored as an int32 tensor of
shape ``(ceil16(modulo2), 8)`` with the JAX package's exact bit patterns:

    [k0_lo, k0_hi, node0, ~(size | dup2 << 30), k1_lo, k1_hi,
     node1 or start row, spare]

An empty lane is all ones (-1 as int32; JAX's ``_EMPTY``), so an empty
size lane reads as size 0 and an empty key never matches a hash < 2^62.
Buckets of size <= 2 resolve from the record alone; deeper ones (and
"dup2" buckets, which hold one k-mer twice) keep their first sorted row in
lane 6 and resolve by scanning the bucket-sorted rows; buckets deeper than
``SCAN_CAP`` ("ultra", e.g. poly-A) resolve once per unique query k-mer.

Kernel K2 (csrc/packed_lookup.cu) does the per-query decode; the deep
scan and the ultra resolution are plain torch on the few queries that
need them.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import torch

from . import _kernels

SCAN_CAP = 256
DUP2 = 1 << 30
INT64_MAX = (1 << 63) - 1
# The JAX package pads its sorted "present" k-mers with 2^63 (uint64) and
# its query batches with a sentinel above every hash; neither fits int64,
# so the port uses INT64_MAX, which is equally above every hash (< 2^62).
PRESENT_SENT = INT64_MAX

_U32 = 0xFFFFFFFF
# ultra-deep resolution expands (unique query x bucket row) pairs in
# chunks of at most this many rows
_ULTRA_ROWS_PER_CHUNK = 1 << 24

# query classes written by K2 (0: final, answered by the record lanes)
CLS_DEEP, CLS_ULTRA = 1, 2


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
    """Next prime >= max(67, 2*n_rows + 1)."""
    m = max(67, 2 * n_rows + 1)
    while not _is_prime(m):
        m += 1
    return m


def record_rows(modulo2: int) -> int:
    """Rows of the record tensor: modulo2 rounded up to 16, as in JAX."""
    return -(-modulo2 // 16) * 16


def _i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same 32 bits (no
    conversion of a value >= 2^31 to int32)."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _lane(g: torch.Tensor, c: int) -> torch.Tensor:
    """Lane ``c`` of gathered records as its uint32 value in int64."""
    return g[:, c].to(torch.int64) & _U32


def _dup2_masks(is_second, sz_row, ks):
    """(dup_b, dup_a): second / first row of every size-2 bucket that
    holds the same k-mer twice (JAX lookup.py:_dup2_masks)."""
    same = torch.zeros_like(is_second)
    same[1:] = ks[1:] == ks[:-1]
    dup_b = is_second & (sz_row == 2) & same
    dup_a = torch.zeros_like(dup_b)
    dup_a[:-1] = dup_b[1:]
    return dup_b, dup_a


class PackedTables(NamedTuple):
    records: torch.Tensor  # int32 (record_rows(modulo2), 8)
    ks: torch.Tensor       # int64 rows sorted by internal bucket
    ns: torch.Tensor       # int64 nodes in the same order
    modulo2: int
    max_sz: int
    deep_frac: float


def build_packed(kmers: torch.Tensor, nodes: torch.Tensor,
                 modulo2: int) -> PackedTables:
    """Record table + bucket-sorted rows (JAX _packed_stage1,
    _dup2_masks and _packed_records, assembled as _build_packed)."""
    dev = kmers.device
    n = kmers.shape[0]
    rows = record_rows(modulo2)
    rec = torch.full((rows * 8,), -1, dtype=torch.int32, device=dev)
    if n == 0:
        return PackedTables(rec.view(rows, 8), kmers.to(torch.int64),
                            nodes.to(torch.int64), modulo2, 0, 0.0)
    bs, perm = torch.sort(kmers % modulo2, stable=True)
    ks = kmers[perm]
    ns = nodes[perm].to(torch.int64)
    del perm
    is_first = torch.ones(n, dtype=torch.bool, device=dev)
    is_first[1:] = bs[1:] != bs[:-1]
    is_second = torch.zeros_like(is_first)
    is_second[1:] = is_first[:-1]
    is_second &= ~is_first
    run_starts = torch.nonzero(is_first).flatten()
    run_len = torch.diff(run_starts, append=torch.tensor([n], device=dev))
    sz_row = torch.repeat_interleave(run_len, run_len, output_size=n)
    max_sz = int(run_len.max())
    dup_b, dup_a = _dup2_masks(is_second, sz_row, ks)
    deep_frac = int(((sz_row > 2) | dup_a | dup_b).sum()) / n

    tb = bs * 8
    del bs
    # the bucket's first row fills lanes 0-2, the second row of a plain
    # size-2 bucket lanes 4-6; dup2 buckets suppress their second slot
    slot = torch.where(is_first, tb, torch.where(
        is_second & (sz_row == 2) & ~dup_b, tb + 4, -1))
    put = slot >= 0
    at, kp = slot[put], ks[put]
    rec[at] = _i32_bits(kp & _U32)
    rec[at + 1] = _i32_bits(kp >> 32)
    rec[at + 2] = _i32_bits(ns[put])
    del slot, put, at, kp
    szv = sz_row | torch.where(dup_a, DUP2, 0)
    rec[tb[is_first] + 3] = (~szv[is_first]).to(torch.int32)
    deep_first = is_first & ((sz_row > 2) | dup_a)
    rec[tb[deep_first] + 6] = _i32_bits(
        torch.nonzero(deep_first).flatten())
    return PackedTables(rec.view(rows, 8), ks, ns, modulo2, max_sz,
                        deep_frac)


# -- kernel K2 and its plain twin ---------------------------------------------

def packed_decode_plain(records, queries, n_valid, modulo2, n_nodes=None):
    """Plain twin of K2. With ``n_nodes``: (int64 lane counts of length
    n_nodes, uint8 class per query); without: (bool lane hit per query,
    uint8 class per query). Classes: 0 final, 1 deep, 2 ultra."""
    n = queries.shape[0]
    valid = torch.arange(n, device=queries.device) < n_valid
    g = records[queries % modulo2]
    lo, hi = queries & _U32, queries >> 32
    raw = (~_lane(g, 3)) & _U32
    dup2 = raw >= DUP2
    sz = raw & (DUP2 - 1)
    hit0 = (_lane(g, 0) == lo) & (_lane(g, 1) == hi) & valid
    hit1 = (_lane(g, 4) == lo) & (_lane(g, 5) == hi) & valid
    if n_nodes is None:
        hit = hit0 | hit1
        ultra = (sz > SCAN_CAP) & valid & ~hit
        deep = (sz > 2) & valid & ~ultra & ~hit
        return hit, (ultra.to(torch.uint8) * CLS_ULTRA
                     + deep.to(torch.uint8) * CLS_DEEP)
    ultra = (sz > SCAN_CAP) & valid
    deep = (((sz > 2) & valid) | (dup2 & hit0)) & ~ultra
    node = torch.where(hit0, _lane(g, 2), _lane(g, 6))
    take = (hit0 | hit1) & ~deep & ~ultra & (node < n_nodes)
    counts = torch.bincount(node[take], minlength=n_nodes)[:n_nodes]
    return counts, (ultra.to(torch.uint8) * CLS_ULTRA
                    + deep.to(torch.uint8) * CLS_DEEP)


def packed_decode(records, queries, n_valid, modulo2, n_nodes=None):
    """Kernel K2 on CUDA tensors, the plain twin on CPU tensors; same
    contract as :func:`packed_decode_plain`."""
    if queries.device.type == "cpu":
        return packed_decode_plain(records, queries, n_valid, modulo2,
                                   n_nodes)
    _kernels.check_cuda_tensor(records, "records", torch.int32, 2)
    _kernels.check_cuda_tensor(queries, "queries", torch.int64, 1)
    if records.device != queries.device:
        raise ValueError("records and queries must share a device")
    if records.shape[1] != 8 or records.shape[0] < modulo2:
        raise ValueError(f"records must be (>= {modulo2}, 8), got "
                         f"{tuple(records.shape)}")
    if records.data_ptr() % 16:
        raise ValueError("records must be 16-byte aligned")
    dev = queries.device
    n = queries.shape[0]
    cls = torch.empty(n, dtype=torch.uint8, device=dev)
    if n_nodes is None:
        out = torch.empty(n, dtype=torch.bool, device=dev)
        counts_ptr, hit_ptr, n_nodes_arg = None, out.data_ptr(), 0
    else:
        out = torch.zeros(n_nodes, dtype=torch.int64, device=dev)
        counts_ptr, hit_ptr, n_nodes_arg = out.data_ptr(), None, n_nodes
    if n == 0:
        return out, cls
    lib = _kernels.library()
    with torch.cuda.device(dev):
        err = lib.gki_packed_decode(
            records.data_ptr(), queries.data_ptr(), n, min(n_valid, n),
            modulo2, counts_ptr, n_nodes_arg, hit_ptr, cls.data_ptr(),
            _kernels.stream_handle(dev))
    _kernels.check_launch("packed_decode", err)
    _kernels.launch_counts["packed_decode"] += 1
    return out, cls


# -- plain-torch follow-ups ---------------------------------------------------

def _bucket_meta(tables: PackedTables, q: torch.Tensor):
    """(start row, size) of each query's bucket, from its record."""
    g = tables.records[q % tables.modulo2]
    sz = ((~_lane(g, 3)) & _U32) & (DUP2 - 1)
    return _lane(g, 6), sz


def _scan_deep(tables: PackedTables, q: torch.Tensor):
    """Scan the deep buckets (2 < size <= SCAN_CAP, or dup2) of queries
    ``q``: one pass per bucket depth, each keeping only the queries whose
    bucket is still deeper. Returns (query index, matched row) pairs."""
    start, sz = _bucket_meta(tables, q)
    ids = torch.arange(q.shape[0], device=q.device)
    hit_ids, hit_rows = [], []
    j = 0
    while q.shape[0]:
        rows = start + j
        m = tables.ks[rows] == q
        hit_ids.append(ids[m])
        hit_rows.append(rows[m])
        j += 1
        keep = sz > j
        q, start, sz, ids = q[keep], start[keep], sz[keep], ids[keep]
    if not hit_ids:
        empty = torch.zeros(0, dtype=torch.int64, device=q.device)
        return empty, empty
    return torch.cat(hit_ids), torch.cat(hit_rows)


def _ultra_matches(tables: PackedTables, uniq: torch.Tensor):
    """(unique index, matched row) pairs for unique ultra-deep query
    k-mers: every row of each one's bucket that holds it (JAX
    _ultra_rows, vectorised over the uniques in bounded chunks)."""
    start, sz = _bucket_meta(tables, uniq)
    ends = torch.cumsum(sz, 0).tolist()
    hit_ids, hit_rows = [], []
    lo = 0
    while lo < len(ends):
        base = ends[lo - 1] if lo else 0
        hi = lo + 1
        while hi < len(ends) and ends[hi] - base <= _ULTRA_ROWS_PER_CHUNK:
            hi += 1
        s, z = start[lo:hi], sz[lo:hi]
        total = ends[hi - 1] - base
        owner = torch.repeat_interleave(
            torch.arange(lo, hi, device=uniq.device), z, output_size=total)
        first = torch.cumsum(z, 0) - z
        rows = (torch.repeat_interleave(s - first, z, output_size=total)
                + torch.arange(total, device=uniq.device))
        m = tables.ks[rows] == uniq[owner]
        hit_ids.append(owner[m])
        hit_rows.append(rows[m])
        lo = hi
    if not hit_ids:
        empty = torch.zeros(0, dtype=torch.int64, device=uniq.device)
        return empty, empty
    return torch.cat(hit_ids), torch.cat(hit_rows)


def _add_node_hits(counts, nodes, weights=None):
    """counts[node] += weight for nodes < len(counts) (the JAX scatters'
    mode="drop" as an explicit mask)."""
    keep = nodes < counts.shape[0]
    w = (torch.ones_like(nodes[keep]) if weights is None
         else weights[keep])
    counts.index_add_(0, nodes[keep], w)


def fixup_membership(hit, idx, q, present_sorted):
    """Set ``hit[idx]`` to membership of ``q`` in ``present_sorted``
    (sorted, padded with PRESENT_SENT) — JAX _fixup_membership."""
    pos = torch.searchsorted(present_sorted, q)
    pos = pos.clamp(max=present_sorted.shape[0] - 1)
    hit[idx] = present_sorted[pos] == q
    return hit


def packed_byte_budget(device: torch.device) -> int:
    """Largest record table this device takes: a quarter of its memory,
    leaving room for the row arrays, the build's sort temporaries and the
    query batches."""
    if device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
    else:
        total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    return total // 4


class DeviceKmerIndex:
    """Packed-record lookup over the rows (kmers, nodes) of a
    collision-free index, on the device that holds them. The record table
    is built at first use."""

    def __init__(self, kmers: torch.Tensor, nodes: torch.Tensor):
        if kmers.device != nodes.device:
            raise ValueError("kmers and nodes must share a device")
        self.kmers = kmers
        self.nodes = nodes
        self.device = kmers.device
        self._tables = None

    def packed(self) -> PackedTables:
        if self._tables is None:
            modulo2 = internal_modulo(int(self.kmers.shape[0]))
            need = record_rows(modulo2) * 32
            budget = packed_byte_budget(self.device)
            if need > budget:
                raise NotImplementedError(
                    f"packed records need {need} bytes, over this device's "
                    f"budget of {budget}; the CSR lookup path that serves "
                    "larger tables is not ported yet (ROADMAP.md)")
            self._tables = build_packed(self.kmers, self.nodes, modulo2)
        return self._tables

    def map_kmers(self, queries: torch.Tensor, n_nodes: int) -> torch.Tensor:
        """int64 hit counts per node (nodes >= n_nodes dropped) for an
        int64 query tensor on this index's device."""
        t = self.packed()
        counts, cls = packed_decode(t.records, queries, queries.shape[0],
                                    t.modulo2, n_nodes)
        deep = torch.nonzero(cls == CLS_DEEP).flatten()
        if deep.numel():
            _ids, rows = _scan_deep(t, queries[deep])
            _add_node_hits(counts, t.ns[rows])
        ultra = torch.nonzero(cls == CLS_ULTRA).flatten()
        if ultra.numel():
            uniq, mult = torch.unique(queries[ultra], return_counts=True)
            ids, rows = _ultra_matches(t, uniq)
            _add_node_hits(counts, t.ns[rows], mult[ids])
        return counts

    def has_kmers(self, queries: torch.Tensor) -> torch.Tensor:
        """bool membership per query of an int64 query tensor."""
        t = self.packed()
        hit, cls = packed_decode(t.records, queries, queries.shape[0],
                                 t.modulo2)
        deep = torch.nonzero(cls == CLS_DEEP).flatten()
        if deep.numel():
            ids, _rows = _scan_deep(t, queries[deep])
            hit[deep[ids]] = True
        ultra = torch.nonzero(cls == CLS_ULTRA).flatten()
        if ultra.numel():
            q = queries[ultra]
            uniq = torch.unique(q)
            ids, _rows = _ultra_matches(t, uniq)
            present = torch.unique(uniq[ids])
            sent = torch.full((1,), PRESENT_SENT, dtype=torch.int64,
                              device=q.device)
            hit = fixup_membership(hit, ultra, q, torch.cat([present, sent]))
        return hit

    def map_read_kmers(self, read_kmers, n_nodes: int) -> torch.Tensor:
        """Counts for a DeviceReadKmers batch, segment by segment."""
        total = torch.zeros(n_nodes, dtype=torch.int64, device=self.device)
        for seg in read_kmers.segments:
            total += self.map_kmers(seg, n_nodes)
        return total

    def has_read_kmers(self, read_kmers) -> torch.Tensor:
        """Membership for a DeviceReadKmers batch, in to_numpy() order."""
        parts = [self.has_kmers(seg) for seg in read_kmers.segments]
        if not parts:
            return torch.zeros(0, dtype=torch.bool, device=self.device)
        return torch.cat(parts)
