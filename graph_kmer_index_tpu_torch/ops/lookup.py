"""Device lookup: the port of graph_kmer_index_tpu/ops/lookup.py. The
packed-record path (build, decode, deep-bucket scan, ultra-deep
resolution) serves map/has; the CSR bucket scan serves them when the
records exceed the device's budget, and serves ``get_batched``.

The table lives under an INTERNAL modulo (next prime >= 2n+1, load factor
<= 0.5) as one 32-byte record per bucket, stored as an int32 tensor of
shape ``(ceil16(modulo2), 8)`` with the JAX package's exact bit patterns:

    [k0_lo, k0_hi, node0, ~(size | dup2 << 30), k1_lo, k1_hi,
     node1 or start row, spare]

An empty lane is all ones (-1 as int32; JAX's ``_EMPTY``), so an empty
size lane reads as size 0 and an empty key never matches a hash < 2^62.
Buckets of size <= 2 resolve from the record alone; deeper ones (and
"dup2" buckets, which hold one k-mer twice) keep their first sorted row in
lane 6 and resolve by scanning the bucket-sorted rows; for buckets deeper
than ``SCAN_CAP`` ("ultra", e.g. poly-A) the plain twin resolves each
unique query k-mer once and weights it by its multiplicity.

Kernel K2 (csrc/packed_lookup.cu) answers a whole query batch in one
launch (:func:`packed_lookup`): the lanes answer the queries they can, and
every other query (deep, dup2 or ultra bucket) is scanned in the same
block, once per distinct k-mer of the block's tile and weighted by its
multiplicity there. Nothing comes back to the host between the classes,
and ``map_kmers``/``has_kmers`` run no loop by depth on a CUDA tensor. Its
plain twin, :func:`packed_lookup_plain`, is the same lookup as three
plain-torch steps (:func:`packed_decode_plain`, the deep scan by depth,
the ultra resolution per unique k-mer) and serves CPU tensors and the
tests.

The CSR path reads the rows as the index stores them, sorted by bucket
under the REFERENCE modulo: a query's rows are [start, start + size) of
its bucket, from the modulo-sized bucket tables (two gathers per query)
or from a searchsorted over the n-sized sorted bucket column (no
modulo-sized tables). The JAX package scans a dense (queries, max_scan)
matrix, a static-shape device program; the port scans by depth instead
(pass j keeps only the queries whose bucket holds more than j rows), so a
poly-A bucket of hundreds of rows costs its own queries and no others.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from . import _kernels

SCAN_CAP = 256
# the CythonKmerIndex.get caps that get_batched keeps by default
DEFAULT_HIT_CAP = 10000
DEFAULT_FREQUENCY_CAP = 20
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

# query classes of packed_decode_plain (0: final, answered by the record
# lanes)
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


# -- the steps of K2's plain twin ---------------------------------------------

def packed_decode_plain(records, queries, n_valid, modulo2, n_nodes=None):
    """The lanes' step of K2's plain twin, and its classifier. With
    ``n_nodes``: (int64 lane counts of length n_nodes, uint8 class per
    query); without: (bool lane hit per query, uint8 class per query).
    Classes: 0 final, 1 deep, 2 ultra."""
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


def _bucket_meta(tables: PackedTables, q: torch.Tensor):
    """(start row, size) of each query's bucket, from its record."""
    g = tables.records[q % tables.modulo2]
    sz = ((~_lane(g, 3)) & _U32) & (DUP2 - 1)
    return _lane(g, 6), sz


def _bucket_hits_from_ranges(q: torch.Tensor, table_kmers: torch.Tensor,
                             start: torch.Tensor, size: torch.Tensor):
    """Every row of each query's range [start, start + size) that holds
    the query k-mer, scanned by depth: pass j keeps only the queries whose
    range is longer than j. Returns (query index, matched row) pairs,
    depth by depth (JAX _bucket_hits_from_ranges without its dense
    (queries, max_scan) matrix)."""
    ids = torch.nonzero(size > 0).flatten()
    q, start, size = q[ids], start[ids], size[ids]
    hit_ids, hit_rows = [], []
    j = 0
    while q.shape[0]:
        rows = start + j
        m = table_kmers[rows] == q
        hit_ids.append(ids[m])
        hit_rows.append(rows[m])
        j += 1
        keep = size > j
        q, start, size, ids = q[keep], start[keep], size[keep], ids[keep]
    if not hit_ids:
        return ids, ids.clone()
    return torch.cat(hit_ids), torch.cat(hit_rows)


def _scan_deep(tables: PackedTables, q: torch.Tensor):
    """Scan the deep buckets (2 < size <= SCAN_CAP, or dup2) of queries
    ``q`` against the internally sorted rows. Returns (query index,
    matched row) pairs."""
    return _bucket_hits_from_ranges(q, tables.ks, *_bucket_meta(tables, q))


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


def finish_classes(tables: PackedTables, queries, out, cls, n_nodes=None):
    """The steps after the lanes' of K2's plain twin: ``out`` (lane counts
    or lane hits) completed for the queries that ``cls`` marks deep
    (buckets scanned by depth) or ultra (resolved once per unique
    k-mer)."""
    deep = torch.nonzero(cls == CLS_DEEP).flatten()
    ultra = torch.nonzero(cls == CLS_ULTRA).flatten()
    if deep.numel():
        ids, rows = _scan_deep(tables, queries[deep])
        if n_nodes is None:
            out[deep[ids]] = True
        else:
            _add_node_hits(out, tables.ns[rows])
    if ultra.numel():
        q = queries[ultra]
        uniq, mult = torch.unique(q, return_counts=True)
        ids, rows = _ultra_matches(tables, uniq)
        if n_nodes is None:
            sent = torch.full((1,), PRESENT_SENT, dtype=torch.int64,
                              device=q.device)
            out = fixup_membership(
                out, ultra, q, torch.cat([torch.unique(uniq[ids]), sent]))
        else:
            _add_node_hits(out, tables.ns[rows], mult[ids])
    return out


def packed_lookup_plain(tables: PackedTables, queries, n_valid,
                        n_nodes=None):
    """Plain twin of K2: the packed lookup of ``queries[:n_valid]`` (the
    rest is padding). With ``n_nodes``: int64 hit counts per node (nodes
    >= n_nodes dropped); without: bool membership per query. The lanes
    answer what they can (:func:`packed_decode_plain`), then
    :func:`finish_classes` the rest."""
    out, cls = packed_decode_plain(tables.records, queries, n_valid,
                                   tables.modulo2, n_nodes)
    return finish_classes(tables, queries, out, cls, n_nodes)


def packed_lookup(tables: PackedTables, queries, n_valid, n_nodes=None):
    """Kernel K2 on CUDA tensors, the plain twin on CPU tensors; same
    contract as :func:`packed_lookup_plain`. Queries are hashes: int64
    values >= 0."""
    if queries.device.type == "cpu":
        return packed_lookup_plain(tables, queries, n_valid, n_nodes)
    records, modulo2 = tables.records, tables.modulo2
    _kernels.check_cuda_tensor(records, "records", torch.int32, 2)
    _kernels.check_cuda_tensor(queries, "queries", torch.int64, 1)
    _kernels.check_cuda_tensor(tables.ks, "ks", torch.int64, 1)
    _kernels.check_cuda_tensor(tables.ns, "ns", torch.int64, 1)
    dev = queries.device
    if not records.device == tables.ks.device == tables.ns.device == dev:
        raise ValueError("the tables and the queries must share a device")
    if records.shape[1] != 8 or records.shape[0] < modulo2:
        raise ValueError(f"records must be (>= {modulo2}, 8), got "
                         f"{tuple(records.shape)}")
    if records.data_ptr() % 16:
        raise ValueError("records must be 16-byte aligned")
    if tables.ns.shape != tables.ks.shape:
        raise ValueError("ks and ns must have one length")
    if n_nodes is not None and n_nodes < 0:
        raise ValueError(f"n_nodes must be >= 0, got {n_nodes}")
    n = queries.shape[0]
    if n_nodes is None:
        out = torch.empty(n, dtype=torch.bool, device=dev)
    else:
        out = torch.zeros(n_nodes, dtype=torch.int64, device=dev)
    if n == 0:
        return out
    counts_mode = n_nodes is not None
    lib = _kernels.library()
    with torch.cuda.device(dev):
        err = lib.gki_packed_lookup(
            records.data_ptr(), queries.data_ptr(), n,
            max(0, min(n_valid, n)), modulo2, tables.ks.data_ptr(),
            tables.ns.data_ptr(), tables.ks.shape[0],
            out.data_ptr() if counts_mode else None,
            n_nodes if counts_mode else 0,
            None if counts_mode else out.data_ptr(), int(counts_mode),
            _kernels.stream_handle(dev))
    _kernels.check_launch("packed_lookup", err)
    _kernels.launch_counts["packed_lookup"] += 1
    return out


def packed_byte_budget(device: torch.device) -> int:
    """Largest record table this device takes: a quarter of its memory,
    leaving room for the row arrays, the build's sort temporaries and the
    query batches."""
    if device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
    else:
        total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    return total // 4


# -- the CSR bucket scan and batched get ---------------------------------------

def _ranges_from_tables(queries, starts_tbl, sizes_tbl, modulo: int):
    """Per-query (start, size) row range via the modulo-sized bucket
    tables: two gathers per query."""
    b = queries % modulo
    return starts_tbl[b].to(torch.int64), sizes_tbl[b].to(torch.int64)


def _ref_bucket_ranges(qb: torch.Tensor, tb: torch.Tensor):
    """Per-query (start, size) row range under the reference modulo
    without the modulo-sized tables: searchsorted left and right of each
    query bucket ``qb`` in the bucket column ``tb`` of the bucket-sorted
    rows. The JAX package gets the same ranks from one merged stable sort
    of table and query keys."""
    qb = qb.to(tb.dtype)
    left = torch.searchsorted(tb, qb)
    return left, torch.searchsorted(tb, qb, right=True) - left


def _bucket_hits(queries, table_kmers, starts_tbl, sizes_tbl, modulo: int):
    """(query index, matched row) pairs via the bucket tables."""
    start, size = _ranges_from_tables(queries, starts_tbl, sizes_tbl, modulo)
    return _bucket_hits_from_ranges(queries, table_kmers, start, size)


def _node_counts(queries, table_kmers, table_nodes, starts_tbl, sizes_tbl,
                 modulo: int, n_nodes: int) -> torch.Tensor:
    """int64 hit counts per node (nodes >= n_nodes dropped) by the CSR
    scan."""
    _ids, rows = _bucket_hits(queries, table_kmers, starts_tbl, sizes_tbl,
                              modulo)
    counts = torch.zeros(n_nodes, dtype=torch.int64, device=queries.device)
    _add_node_hits(counts, table_nodes[rows])
    return counts


def _has_kmers(queries, table_kmers, starts_tbl, sizes_tbl,
               modulo: int) -> torch.Tensor:
    """bool membership per query by the CSR scan."""
    ids, _rows = _bucket_hits(queries, table_kmers, starts_tbl, sizes_tbl,
                              modulo)
    hit = torch.zeros(queries.shape[0], dtype=torch.bool,
                      device=queries.device)
    hit[ids] = True
    return hit


def _get_batched(queries, table_kmers, table_nodes, table_ref_offsets,
                 table_frequencies, table_allele_frequencies, start, size,
                 hit_cap: int, freq_cap: int) -> torch.Tensor:
    """The (5, n_hits) int64 rows [node, ref_offset, query index,
    frequency, int(allele_frequency * 1000)] of every hit, by query, then
    by row within the bucket (JAX _get_batched_kernel). A query whose
    bucket holds more than ``hit_cap`` rows is skipped whole, a row whose
    frequency exceeds ``freq_cap`` alone. The hits are counted before the
    output is allocated, so no capacity is guessed."""
    size = torch.where(size <= hit_cap, size, 0)
    ids, rows = _bucket_hits_from_ranges(queries, table_kmers, start, size)
    keep = table_frequencies[rows] <= freq_cap
    ids, rows = ids[keep], rows[keep]
    # the scan yields hits depth by depth; a stable sort by query keeps
    # each query's rows in bucket order
    order = torch.argsort(ids, stable=True)
    ids, rows = ids[order], rows[order]
    out = torch.empty((5, ids.shape[0]), dtype=torch.int64,
                      device=queries.device)
    out[0] = table_nodes[rows]
    out[1] = table_ref_offsets[rows]
    out[2] = ids
    out[3] = table_frequencies[rows]
    # float32 product, truncated, as the JAX package computes it
    out[4] = (table_allele_frequencies[rows] * 1000).to(torch.int64)
    return out


def as_device_tensor(value, dtype: torch.dtype,
                     device: torch.device) -> torch.Tensor:
    """A column (numpy array or tensor) as a ``dtype`` tensor on
    ``device``; a tensor already there in that dtype is not copied. uint64
    values (hashes, offsets < 2^63) keep their bits as int64."""
    if not isinstance(value, torch.Tensor):
        a = np.ascontiguousarray(value)
        if a.dtype == np.uint64:
            a = a.view(np.int64)
        elif a.dtype.kind == "u":
            a = a.astype(np.int64)
        value = torch.from_numpy(a)
    return value.to(device, dtype)


class DeviceKmerIndex:
    """Device view of a KmerIndex (models.kmer_index): the packed-record
    lookup, the CSR bucket scan and ``get_batched``, on the index's device.

    Columns move to the device LAZILY, per query path, as in the JAX
    package: the packed map/has path reads only kmers and nodes; the
    modulo-sized bucket tables and the other row columns move when the CSR
    path or ``get_batched`` reads them. A placeholder column (from
    remove_ref_offsets / remove_frequencies, or no allele frequencies)
    reads as zeros. The budgets below are class attributes that an
    instance may override."""

    _LAZY = {
        "table_kmers": ("kmers", torch.int64),
        "table_nodes": ("nodes", torch.int64),
        "table_ref_offsets": ("ref_offsets", torch.int64),
        "table_frequencies": ("frequencies", torch.int32),
        "table_allele_frequencies": ("allele_frequencies", torch.float32),
        "starts_tbl": ("hashes_to_index", torch.int32),
        "sizes_tbl": ("n_kmers", torch.int32),
    }
    _ZERO_IF_PLACEHOLDER = ("table_ref_offsets", "table_frequencies",
                            "table_allele_frequencies")

    # modulo-sized bucket tables (12 bytes per bucket, as the JAX package
    # counts them) below this are cheap to move and keep; above it,
    # get_batched takes its ranges from a searchsorted over the n-sized
    # bucket column
    BUCKET_TABLE_BYTE_BUDGET = 256 << 20
    # records above this fall back to the CSR path; None: a quarter of
    # the device (packed_byte_budget)
    PACKED_BYTE_BUDGET = None

    def __init__(self, host_index):
        self._host = host_index
        self._cache = {}
        self.device = host_index.device
        self.modulo = int(host_index.modulo)
        self._max_scan = None
        self._packed_tables = None

    def __getattr__(self, name):
        spec = DeviceKmerIndex._LAZY.get(name)
        if spec is None:
            raise AttributeError(name)
        if name not in self._cache:
            attr, dtype = spec
            value = getattr(self._host, attr)
            n = int(self._host.kmers.shape[0])
            if name in self._ZERO_IF_PLACEHOLDER and (
                    value is None or np.ndim(value) == 0
                    or np.shape(value)[0] != n):
                value = torch.zeros(n, dtype=dtype)
            if value is None:
                raise ValueError(
                    f"the index has no {attr} column; the CSR path needs "
                    "the bucket layout (KmerIndex.from_rows or from_file)")
            self._cache[name] = as_device_tensor(value, dtype, self.device)
        return self._cache[name]

    def _bucket_tables_cheap(self) -> bool:
        """True when get_batched should take its ranges from the bucket
        tables (two gathers per query): this view already holds them on
        the device, or they fit BUCKET_TABLE_BYTE_BUDGET. (The JAX package
        also takes tables that its device build left in HBM; the port's
        build leaves tensors that this view reads like any other column.)"""
        return ("starts_tbl" in self._cache
                or self.modulo * 12 <= self.BUCKET_TABLE_BYTE_BUDGET)

    @property
    def sorted_buckets(self) -> torch.Tensor:
        """Reference-modulo bucket of each (bucket-sorted) row: n-sized,
        where the bucket tables are modulo-sized. int32 when 2 * modulo + 2
        fits, as in the JAX package."""
        if "sorted_buckets" not in self._cache:
            dtype = (torch.int32 if 2 * self.modulo + 2 < 2 ** 31
                     else torch.int64)
            self._cache["sorted_buckets"] = (
                self.table_kmers % self.modulo).to(dtype)
        return self._cache["sorted_buckets"]

    @property
    def max_scan(self) -> int:
        """The deepest bucket's size (at least 1), from the host's sizes
        column, without moving it."""
        if self._max_scan is None:
            sizes = self._host.n_kmers
            if sizes is None:
                raise ValueError("the index has no n_kmers column")
            self._max_scan = (max(1, int(sizes.max())) if len(sizes)
                              else 1)
        return self._max_scan

    def packed(self) -> PackedTables | None:
        """The packed tables, built at first use; None when the records
        exceed PACKED_BYTE_BUDGET, and then map/has take the CSR path."""
        if self._packed_tables is None:
            modulo2 = internal_modulo(int(self._host.kmers.shape[0]))
            budget = (packed_byte_budget(self.device)
                      if self.PACKED_BYTE_BUDGET is None
                      else self.PACKED_BYTE_BUDGET)
            if record_rows(modulo2) * 32 > budget:
                self._packed_tables = False
            else:
                self._packed_tables = build_packed(
                    self.table_kmers, self.table_nodes, modulo2)
        return self._packed_tables or None

    def map_kmers(self, queries: torch.Tensor, n_nodes: int) -> torch.Tensor:
        """int64 hit counts per node (nodes >= n_nodes dropped) for an
        int64 query tensor on this index's device."""
        t = self.packed()
        if t is None:
            return _node_counts(queries, self.table_kmers, self.table_nodes,
                                self.starts_tbl, self.sizes_tbl, self.modulo,
                                n_nodes)
        return packed_lookup(t, queries, queries.shape[0], n_nodes)

    def has_kmers(self, queries: torch.Tensor) -> torch.Tensor:
        """bool membership per query of an int64 query tensor."""
        t = self.packed()
        if t is None:
            return _has_kmers(queries, self.table_kmers, self.starts_tbl,
                              self.sizes_tbl, self.modulo)
        return packed_lookup(t, queries, queries.shape[0])

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

    def get_batched(self, queries: torch.Tensor, max_hits=10,
                    hit_cap=DEFAULT_HIT_CAP,
                    frequency_cap=DEFAULT_FREQUENCY_CAP) -> torch.Tensor:
        """(5, n_hits) int64 [node, ref_offset, query index, frequency,
        int(1000 * allele_frequency)] for an int64 query tensor: the
        CythonKmerIndex.get contract as the JAX package keeps it (queries
        whose bucket holds more than ``hit_cap`` rows skipped, rows with
        frequency above ``frequency_cap`` skipped, bucket-0 queries looked
        up like any other; PARITY.md). ``max_hits`` is unused, as there."""
        if self._bucket_tables_cheap():
            start, size = _ranges_from_tables(queries, self.starts_tbl,
                                              self.sizes_tbl, self.modulo)
        else:
            start, size = _ref_bucket_ranges(queries % self.modulo,
                                             self.sorted_buckets)
        return _get_batched(queries, self.table_kmers, self.table_nodes,
                            self.table_ref_offsets, self.table_frequencies,
                            self.table_allele_frequencies, start, size,
                            hit_cap, frequency_cap)
