"""Bucket-range table shards, the sharded builds and the sharded serving
steps: graph_kmer_index_tpu/parallel/sharded.py on torch.distributed.

The production multi-card layout (SURVEY.md §5.8): the index is sharded
by contiguous BUCKET RANGE over the mesh's ``table`` dimension (each
table shard owns buckets [t * m_local, (t + 1) * m_local) and the row
segment they point into), while read/query batches shard over ``data``.
Each rank holds its own table shard on its card, takes its data slice of
the queries, hashes reads with K1, answers the queries whose bucket it
owns, and merges: node counts with one ``all_reduce`` over the world (the
JAX ``psum`` over both axes), membership with one over the rank's table
subgroup, then ``> 0``.

The packed steps answer through K2 in shard mode
(ops.lookup.packed_lookup with ``bucket_base``/``m2_local``), which
scans every deep bucket: there is no compaction capacity to exceed, so
nothing is dropped and nothing raises. The CSR step is plain torch over
the port's bucket scan with the shard's bucket offset. Pre-hashed queries
are padded with :data:`KMER_PAD`; a window that crosses a read's end
becomes KMER_PAD too. It matches no stored k-mer, so it counts nothing
and is a miss, wherever it lies in the batch.

Columns on the host are numpy, stacked with a leading ``(n_table,)``
axis: records as ``(n_table, m2_local, 8)`` int32 (the bytes of the JAX
package's ``(n_table, groups, 128)`` uint32), k-mers as int64 (the bits
of its uint64). A rank's columns (checkpoint.load_shards on a mesh, the
sharded builds) are tensors on its card with a leading axis of 1.

The sharded builds (:func:`build_packed_shards_sharded`,
:func:`build_table_shards_sharded`, :func:`frequencies_sharded`) take
the rows THIS rank holds, where the JAX functions take global arrays:
the rows of table index t are the t-th contiguous slice of the global
rows (slices may be uneven). Rows travel to the table shard that owns
their bucket by an exact exchange over the table group (the mesh's
``table`` dimension, or the world without a mesh): one
``all_to_all_single`` of the segment sizes, then one uneven
``all_to_all_single`` a column. The JAX package pads every segment to a
fixed capacity and raises when one overflows; here no segment can
overflow and no sentinel row travels. A stable sort by owner, segments
that arrive in source-rank order and rank-ordered slices make the
received order the global row order, so a shard's records equal a
single-table build's restricted to its range. :func:`count_min_sketch_sharded`
and :func:`merge_flat_kmers_all_gather` take the rank's own rows too;
:func:`run_sharded_function`, :func:`has_kmers_sharded` and
:func:`map_kmers_sharded` take the whole batch, as their JAX
counterparts do, and each rank answers its contiguous slice of it.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..flat_kmers import host_column
from ..models.kmer_index import frequencies_by_distinct_ref_offsets
from ..ops.encode import sliding_hashes
from ..ops.lookup import (INT64_MAX, PackedTables, _add_node_hits,
                          _bucket_hits_from_ranges, as_device_tensor,
                          packed_lookup, packed_records)
from ..ops.packed_layout import DUP2, SCAN_CAP, _dup2_masks, internal_modulo
from .mesh import (DATA_AXIS, TABLE_AXIS, coordinates, group_device,
                   mesh_device, subgroups)

#: pad value for pre-hashed query batches: real k-mers are < 4^31 = 2^62
#: (k <= 31), so it never matches a stored k-mer. The JAX package's 2^63
#: does not fit int64 (ROADMAP.md, porting rules).
KMER_PAD = INT64_MAX
_HASH_LIMIT = 1 << 62


class TableShards:
    """The bucket-range shards of an index's CSR layout: per shard, its
    bucket tables with row offsets counted from its own first row, and
    its row segment."""

    def __init__(self, starts, sizes, row_kmers, row_nodes, m_local, modulo,
                 max_scan, n_table):
        self.starts = starts          # (n_table, m_local) int64
        self.sizes = sizes            # (n_table, m_local) int32
        self.row_kmers = row_kmers    # (n_table, rmax) int64
        self.row_nodes = row_nodes    # (n_table, rmax) int32
        self.m_local = m_local
        self.modulo = modulo
        self.max_scan = max_scan
        self.n_table = n_table

    @classmethod
    def from_index(cls, index, n_table: int):
        """The shards of a KmerIndex with the bucket layout (from_rows,
        from_flat_kmers, from_file)."""
        starts_tbl = host_column(index.hashes_to_index).astype(np.int64)
        sizes_tbl = host_column(index.n_kmers).astype(np.int32)
        kmers = host_column(index.kmers).astype(np.int64)
        nodes = host_column(index.nodes).astype(np.int32)
        modulo = int(index.modulo)
        m_local = -(-modulo // n_table)

        starts_p = np.zeros(m_local * n_table, dtype=np.int64)
        sizes_p = np.zeros(m_local * n_table, dtype=np.int32)
        starts_p[:modulo] = starts_tbl
        sizes_p[:modulo] = sizes_tbl
        starts_p = starts_p.reshape(n_table, m_local)
        sizes_p = sizes_p.reshape(n_table, m_local)

        # rows live sorted by bucket, so each shard's rows are contiguous
        rows_lo, rows_hi = [], []
        for t in range(n_table):
            nz = sizes_p[t] > 0
            if nz.any():
                lo = int(starts_p[t][nz].min())
                hi = int((starts_p[t][nz] + sizes_p[t][nz]).max())
            else:
                lo, hi = 0, 0
            rows_lo.append(lo)
            rows_hi.append(hi)
        rmax = max(1, max(h - l for l, h in zip(rows_lo, rows_hi)))
        row_kmers = np.zeros((n_table, rmax), dtype=np.int64)
        row_nodes = np.zeros((n_table, rmax), dtype=np.int32)
        for t, (lo, hi) in enumerate(zip(rows_lo, rows_hi)):
            row_kmers[t, : hi - lo] = kmers[lo:hi]
            row_nodes[t, : hi - lo] = nodes[lo:hi]
            starts_p[t] -= lo  # re-base to shard-local row offsets
        max_scan = max(1, int(sizes_tbl.max()) if len(sizes_tbl) else 1)
        return cls(starts_p, sizes_p, row_kmers, row_nodes, m_local, modulo,
                   max_scan, n_table)

    @classmethod
    def from_jax_state(cls, starts, sizes, row_kmers, row_nodes, m_local,
                       modulo, max_scan, n_table):
        """The JAX package's TableShards columns (host arrays; k-mers
        uint64) as this container, so that both packages serve the same
        shards."""
        return cls(np.asarray(starts, np.int64), np.asarray(sizes, np.int32),
                   np.asarray(row_kmers, np.uint64).view(np.int64),
                   np.asarray(row_nodes, np.int32), int(m_local),
                   int(modulo), int(max_scan), int(n_table))


class PackedTableShards:
    """Bucket-range shards of the packed-record layout (ops.lookup): each
    table shard owns a contiguous range of m2_local INTERNAL-modulo
    buckets (a multiple of 16, as the JAX package's 16-bucket record
    groups never straddle a shard) as an ``(m2_local, 8)`` int32 record
    slice, plus its contiguous row segment, with deep records' start
    lanes re-based to shard-local row offsets."""

    def __init__(self, records, row_kmers, row_nodes, m2_local, modulo2,
                 max_scan, n_table, has_dup=True):
        self.records = records        # (n_table, m2_local, 8) int32
        self.row_kmers = row_kmers    # (n_table, rmax) int64
        self.row_nodes = row_nodes    # (n_table, rmax) int32
        self.m2_local = m2_local
        self.modulo2 = modulo2
        self.max_scan = max_scan
        self.n_table = n_table
        # dup2 buckets present (the JAX package's scan-stage flag; K2
        # scans whatever its records mark, so only the checkpoint keeps it)
        self.has_dup = has_dup

    @classmethod
    def from_index(cls, index, n_table: int):
        """The shards of a KmerIndex's rows (any index: the packed layout
        hashes by its own internal modulo)."""
        kmers = host_column(index.kmers, unsigned=True).astype(np.uint64)
        nodes = host_column(index.nodes).astype(np.uint32)
        n = len(kmers)
        modulo2 = internal_modulo(n)
        bucket = (kmers % np.uint64(modulo2)).astype(np.int64)
        order = np.argsort(bucket, kind="stable")
        bs, ks, ns = bucket[order], kmers[order], nodes[order]

        # ediff1d on an empty array still emits to_begin — guard so a
        # 0-row index builds all-empty shards instead of a mask mismatch
        first = (np.ediff1d(bs, to_begin=1) != 0) if n \
            else np.zeros(0, bool)
        second = np.concatenate([[False], first[:-1]]) & ~first \
            if n else first
        sizes_at = np.zeros(modulo2, np.int64)
        np.add.at(sizes_at, bs, 1)
        sz_row = sizes_at[bs]
        max_scan = int(sz_row.max()) if n else 1
        if max_scan > SCAN_CAP:
            raise ValueError(
                "table has buckets deeper than SCAN_CAP; use the CSR "
                "TableShards for this index")

        per_shard = -(-modulo2 // n_table)
        m2_local = 16 * (-(-per_shard // 16))
        # row segments: rows are sorted by bucket, so each shard's rows
        # are contiguous [lo, hi)
        cut = np.searchsorted(bs, np.arange(1, n_table) * m2_local)
        lo = np.concatenate([[0], cut])
        hi = np.concatenate([cut, [n]])

        # flat 8-lane records, the format of ops.lookup.build_packed with
        # shard-local start rows; all-ones default never matches a query
        # and reads as size 0
        idx_local = (np.arange(n, dtype=np.int64)
                     - lo[np.minimum(bs // m2_local, n_table - 1)])
        rec = np.full(8 * m2_local * n_table, 0xFFFFFFFF, np.uint32)
        tb = bs * 8
        ks_lo = (ks & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        ks_hi = (ks >> np.uint64(32)).astype(np.uint32)
        dup_b, dup_a = _dup2_masks(second, sz_row, ks)
        sec2 = second & (sz_row == 2) & ~dup_b
        rec[tb[first]] = ks_lo[first]
        rec[tb[first] + 1] = ks_hi[first]
        rec[tb[first] + 2] = ns[first]
        szv = sz_row.astype(np.uint32)
        szv[dup_a] |= np.uint32(DUP2)
        rec[tb[first] + 3] = ~szv[first]
        rec[tb[sec2] + 4] = ks_lo[sec2]
        rec[tb[sec2] + 5] = ks_hi[sec2]
        rec[tb[sec2] + 6] = ns[sec2]
        fdeep = first & ((sz_row > 2) | dup_a)
        rec[tb[fdeep] + 6] = idx_local[fdeep].astype(np.uint32)

        rmax = max(1, int((hi - lo).max()))
        row_kmers = np.zeros((n_table, rmax), np.int64)
        row_nodes = np.zeros((n_table, rmax), np.int32)
        for t in range(n_table):
            row_kmers[t, :hi[t] - lo[t]] = ks[lo[t]:hi[t]].view(np.int64)
            row_nodes[t, :hi[t] - lo[t]] = ns[lo[t]:hi[t]]
        return cls(rec.view(np.int32).reshape(n_table, m2_local, 8),
                   row_kmers, row_nodes, m2_local, modulo2, max_scan,
                   n_table, has_dup=bool(dup_b.any()))

    @classmethod
    def from_jax_state(cls, records, row_kmers, row_nodes, m2_local, modulo2,
                       max_scan, n_table, has_dup=True):
        """The JAX package's PackedTableShards columns (host arrays:
        ``(n_table, groups, 128)`` uint32 records, uint64 k-mers) as this
        container: each shard's records become the ``(groups * 16, 8)``
        int32 view of the same bytes."""
        rec = np.ascontiguousarray(records, np.uint32)
        return cls(rec.view(np.int32).reshape(rec.shape[0], -1, 8),
                   np.asarray(row_kmers, np.uint64).view(np.int64),
                   np.asarray(row_nodes, np.int32), int(m2_local),
                   int(modulo2), int(max_scan), int(n_table),
                   has_dup=bool(has_dup))


def _local(col, t: int, dev: torch.device) -> torch.Tensor:
    """Table shard ``t`` of a column: a rank's own column (leading axis
    1) or the stacked host one (leading axis n_table), on ``dev``."""
    if not isinstance(col, torch.Tensor):
        col = torch.from_numpy(np.asarray(col))
    return col[0 if col.shape[0] == 1 else t].to(dev)


def shard_tables(shards: PackedTableShards, t: int, records, row_kmers,
                 row_nodes, dev) -> PackedTables:
    """K2's tables of table shard ``t`` on ``dev`` (rows' nodes as the
    int64 that K2 reads)."""
    return PackedTables(_local(records, t, dev), _local(row_kmers, t, dev),
                        _local(row_nodes, t, dev).to(torch.int64),
                        shards.modulo2, shards.max_scan, 0.0)


def shard_lookup(shards: PackedTableShards, t: int, tables: PackedTables,
                 queries: torch.Tensor, n_nodes=None) -> torch.Tensor:
    """K2 in shard mode: counts (``n_nodes`` given) or membership of the
    queries whose internal bucket table shard ``t`` owns; every other
    query answers nothing."""
    return packed_lookup(tables, queries, queries.shape[0], n_nodes,
                         bucket_base=t * shards.m2_local,
                         m2_local=shards.m2_local)


def _queries(reads, k: int, from_kmers: bool, dev) -> torch.Tensor:
    """This rank's flat int64 queries. ``from_kmers``: pre-hashed k-mers,
    any value outside [0, 2^62) read as padding; else a (reads, L) matrix
    of 2-bit bases, hashed by K1, with the windows that cross a read's end
    made padding. Padding is KMER_PAD."""
    if not isinstance(reads, torch.Tensor):
        reads = torch.from_numpy(np.asarray(reads))
    reads = reads.to(dev)
    if from_kmers:
        flat = reads.reshape(-1).to(torch.int64)
        valid = (flat >= 0) & (flat < _HASH_LIMIT)
        return torch.where(valid, flat, KMER_PAD)
    r_loc, length = reads.shape
    hashes = sliding_hashes(reads.reshape(-1).to(torch.int8), k)
    pos = torch.arange(r_loc * length, device=dev) % length
    return torch.where(pos <= length - k, hashes, KMER_PAD)


def make_count_step(mesh, shards: TableShards, n_nodes: int, k: int,
                    data_axis: str = DATA_AXIS, table_axis: str = TABLE_AXIS,
                    from_kmers: bool = False):
    """The full pipeline step of a rank over a 2-D mesh, CSR layout:
    2-bit reads -> K1 hashes -> bucket-range-sharded lookup -> node counts.

    Returns ``step(reads, starts, sizes, row_kmers, row_nodes)``: reads
    (r_loc, L) this rank's data slice; the table columns this rank's
    shard (or the stacked host ones, of which it takes its own); int64
    node counts of the whole mesh, on every rank. With ``from_kmers`` the
    queries are a flat pre-hashed batch padded with :data:`KMER_PAD`."""
    m_local, modulo = shards.m_local, shards.modulo
    dev = mesh_device(mesh)
    _, t = coordinates(mesh, data_axis, table_axis)

    def step(reads, starts, sizes, row_kmers, row_nodes):
        q = _queries(reads, k, from_kmers, dev)
        bucket = q % modulo
        mine = bucket // m_local == t
        lb = (bucket - t * m_local).clamp(0, m_local - 1)
        start = _local(starts, t, dev)[lb]
        size = torch.where(mine, _local(sizes, t, dev)[lb].to(torch.int64),
                           0)
        _ids, rows = _bucket_hits_from_ranges(q, _local(row_kmers, t, dev),
                                              start, size)
        counts = torch.zeros(n_nodes, dtype=torch.int64, device=dev)
        _add_node_hits(counts,
                       _local(row_nodes, t, dev)[rows].to(torch.int64))
        dist.all_reduce(counts)
        return counts

    return step


def make_count_step_packed(mesh, shards: PackedTableShards, n_nodes: int,
                           k: int, data_axis: str = DATA_AXIS,
                           table_axis: str = TABLE_AXIS,
                           from_kmers: bool = False):
    """The packed-record mirror of :func:`make_count_step`: K2 in shard
    mode answers the rank's queries that its table shard owns, then one
    all_reduce over the world. Returns ``step(reads, records, row_kmers,
    row_nodes)``."""
    dev = mesh_device(mesh)
    _, t = coordinates(mesh, data_axis, table_axis)

    def step(reads, records, row_kmers, row_nodes):
        tables = shard_tables(shards, t, records, row_kmers, row_nodes, dev)
        counts = shard_lookup(shards, t, tables,
                              _queries(reads, k, from_kmers, dev), n_nodes)
        dist.all_reduce(counts)
        return counts

    return step


def make_member_step_packed(mesh, shards: PackedTableShards, k: int,
                            data_axis: str = DATA_AXIS,
                            table_axis: str = TABLE_AXIS,
                            from_kmers: bool = False):
    """Membership mirror of :func:`make_count_step_packed`: each table
    shard answers its own queries (K2 in shard mode), then an all_reduce
    over the table subgroup ORs the shards' verdicts. Returns
    ``step(reads, records, row_kmers, row_nodes)``: the (r_loc, L) hit
    matrix of this rank's reads (positions past L - k are False), or with
    ``from_kmers`` a flat vector (padding answers False)."""
    dev = mesh_device(mesh)
    _, t = coordinates(mesh, data_axis, table_axis)
    _, table_group = subgroups(mesh, data_axis, table_axis)

    def step(reads, records, row_kmers, row_nodes):
        tables = shard_tables(shards, t, records, row_kmers, row_nodes, dev)
        q = _queries(reads, k, from_kmers, dev)
        hit = shard_lookup(shards, t, tables, q).to(torch.int32)
        dist.all_reduce(hit, group=table_group)
        hit = hit > 0
        return hit if from_kmers else hit.reshape(tuple(reads.shape))

    return step


# -- collectives over a mesh dimension ----------------------------------------

def _group_of(mesh=None, axis: str = DATA_AXIS):
    """(group, size, index, device) of this rank along ``axis`` of
    ``mesh``: the mesh's subgroup, or the world without a mesh."""
    if not dist.is_initialized():
        raise RuntimeError("start the process group first "
                           "(mesh.start_process_group)")
    if mesh is None:
        return (None, dist.get_world_size(), dist.get_rank(),
                group_device())
    size = mesh.size(mesh.mesh_dim_names.index(axis))
    return (mesh.get_group(axis), size, mesh.get_local_rank(axis),
            mesh_device(mesh))


def _all_reduce_ints(values, op, group, dev) -> list[int]:
    t = torch.tensor(values, dtype=torch.int64, device=dev)
    dist.all_reduce(t, op=op, group=group)
    return t.tolist()


def _all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's rows of ``t`` (lengths may differ), concatenated in
    rank order: the lengths are exchanged, each part padded to the
    longest, gathered and cut."""
    world = dist.get_world_size(group)
    n = torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device)
    lens = [torch.empty_like(n) for _ in range(world)]
    dist.all_gather(lens, n, group=group)
    lens = [int(x) for x in lens]
    padded = t.new_zeros((max(lens),) + tuple(t.shape[1:]))
    padded[:t.shape[0]] = t
    parts = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(parts, padded, group=group)
    return torch.cat([p[:m] for p, m in zip(parts, lens)])


def _exchange(owner: torch.Tensor, cols, n_parts: int, group):
    """Rows to their owners over ``group`` (JAX _route_rows_to_owners
    without its fixed capacity): a stable sort by owner, so each segment
    keeps this rank's row order; the ``(n_parts,)`` segment sizes by one
    ``all_to_all_single``; then each column by one uneven
    ``all_to_all_single``. Received rows come segment by segment in
    source-rank order. Returns (received columns, the sort's permutation,
    sizes sent, sizes received)."""
    owner, perm = torch.sort(owner, stable=True)
    send = torch.bincount(owner, minlength=n_parts)
    del owner
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    send, recv = send.tolist(), recv.tolist()
    out = []
    for c in cols:
        r = c.new_empty(sum(recv))
        dist.all_to_all_single(r, c[perm], recv, send, group=group)
        out.append(r)
    return out, perm, send, recv


def _sort_received(kmers, nodes, modulo: int, base: int):
    """This shard's received rows sorted by local bucket (``kmer % modulo
    - base``), stable: the received order is the global row order, so
    this is the global stable bucket sort restricted to the shard (JAX
    _sort_received). Returns (local buckets, k-mers, nodes)."""
    lb, order = torch.sort(kmers % modulo - base, stable=True)
    return lb, kmers[order], nodes[order]


def _row_slab(rows: torch.Tensor, dtype) -> torch.Tensor:
    """A shard's ``(1, max(1, m))`` row column: its m rows, then zeros."""
    slab = torch.zeros((1, max(1, rows.shape[0])), dtype=dtype,
                       device=rows.device)
    slab[0, :rows.shape[0]] = rows
    return slab


# -- the sharded builds -------------------------------------------------------

def build_packed_shards_sharded(kmers, nodes, mesh=None,
                                axis: str = TABLE_AXIS):
    """This rank's :class:`PackedTableShards` shard, built from the rows it
    holds (numpy arrays or tensors; k-mers < 2^62): the table is sharded
    over the table group (``axis`` of ``mesh``, or the world), whose rank
    t holds the t-th contiguous slice of the global rows. The global row
    count (one ``all_reduce``) sets the internal modulo; each row goes to
    the shard owning its internal bucket (:func:`_exchange`), and the shard
    writes its records with ops.lookup.packed_records, so one table shard
    is ``build_packed`` of the same rows, record for record. Returns
    (shard, its row count); the shard's columns lie on this rank's device
    with a leading axis of 1. Raises when a bucket is deeper than
    SCAN_CAP, as the JAX package does."""
    group, n_table, t, dev = _group_of(mesh, axis)
    k = as_device_tensor(kmers, torch.int64, dev)
    nd = as_device_tensor(nodes, torch.int64, dev)
    n, = _all_reduce_ints([k.shape[0]], dist.ReduceOp.SUM, group, dev)
    modulo2 = internal_modulo(n)
    per_shard = -(-modulo2 // n_table)
    m2_local = 16 * -(-per_shard // 16)  # as PackedTableShards.from_index
    k, nd = _exchange(k % modulo2 // m2_local, (k, nd), n_table, group)[0]
    lb, ks, ns = _sort_received(k, nd, modulo2, t * m2_local)
    del k, nd
    rec, max_sz, _, dup = packed_records(lb, ks, ns, m2_local)
    max_scan, has_dup = _all_reduce_ints([max_sz, int(dup)],
                                         dist.ReduceOp.MAX, group, dev)
    if max_scan > SCAN_CAP:
        raise ValueError("table has buckets deeper than SCAN_CAP; use the "
                         "CSR TableShards for this index")
    shard = PackedTableShards(rec[None], _row_slab(ks, torch.int64),
                              _row_slab(ns, torch.int32), m2_local, modulo2,
                              max(1, max_scan), n_table,
                              has_dup=bool(has_dup))
    return shard, ks.shape[0]


def build_table_shards_sharded(kmers, nodes, modulo: int, mesh=None,
                               axis: str = TABLE_AXIS):
    """This rank's :class:`TableShards` shard (the CSR bucket layout of
    the index's own ``modulo``), built from the rows it holds by the same
    exchange as :func:`build_packed_shards_sharded`: the shard's bucket
    sizes, its row offsets counted from its first row (0 for an empty
    bucket, as in the JAX package; TableShards.from_index keeps another
    meaningless value there) and its rows. Unlike the JAX build, rows
    already sorted by bucket are no trouble: no segment has a capacity.
    Returns (shard, its row count)."""
    group, n_table, t, dev = _group_of(mesh, axis)
    k = as_device_tensor(kmers, torch.int64, dev)
    nd = as_device_tensor(nodes, torch.int64, dev)
    modulo = int(modulo)
    m_local = -(-modulo // n_table)
    k, nd = _exchange(k % modulo // m_local, (k, nd), n_table, group)[0]
    lb, ks, ns = _sort_received(k, nd, modulo, t * m_local)
    del k, nd
    m = ks.shape[0]
    sizes = torch.bincount(lb, minlength=m_local).to(torch.int32)
    starts = torch.zeros(m_local, dtype=torch.int64, device=dev)
    if m:
        first = torch.ones(m, dtype=torch.bool, device=dev)
        first[1:] = lb[1:] != lb[:-1]
        starts[lb[first]] = torch.nonzero(first).flatten()
    max_scan, = _all_reduce_ints([int(sizes.max()) if m else 0],
                                 dist.ReduceOp.MAX, group, dev)
    shard = TableShards(starts[None], sizes[None], _row_slab(ks, torch.int64),
                        _row_slab(ns, torch.int32), m_local, modulo,
                        max(1, max_scan), n_table)
    return shard, m


def frequencies_sharded(kmers, ref_offsets, mesh=None,
                        axis: str = TABLE_AXIS) -> torch.Tensor:
    """Per-row k-mer frequencies (distinct ref offsets per k-mer, wrapped
    to 16 bits) of the rows this rank holds, computed sharded over the
    table group: each row goes to shard ``kmer % n_shards``, so a k-mer's
    rows meet on one shard, which counts them with
    frequencies_by_distinct_ref_offsets; the frequencies come back by the
    mirrored exchange (the split sizes swapped). Returns int32 values
    aligned to this rank's rows, on its device."""
    group, n_shards, _, dev = _group_of(mesh, axis)
    k = as_device_tensor(kmers, torch.int64, dev)
    r = as_device_tensor(ref_offsets, torch.int64, dev)
    (k_r, r_r), perm, send, recv = _exchange(k % n_shards, (k, r), n_shards,
                                             group)
    freqs = frequencies_by_distinct_ref_offsets(k_r, r_r)
    del k_r, r_r
    back = freqs.new_empty(k.shape[0])
    dist.all_to_all_single(back, freqs, send, recv, group=group)
    out = torch.empty_like(back)
    out[perm] = back
    return out


# -- the data-parallel functions ----------------------------------------------

def merge_flat_kmers_all_gather(mesh, shard_arrays, axis: str = DATA_AXIS):
    """The four FlatKmers columns (hashes, nodes, ref offsets, allele
    frequencies) of every rank along ``axis`` of ``mesh`` (the world
    without a mesh), concatenated in rank order on every rank: the host
    merge of the reference's fork-join, bit for bit. This rank passes its
    own rows; ranks may hold different counts. Returns four tensors on
    this rank's device (uint64 hashes and offsets as int64 bits)."""
    group, _, _, dev = _group_of(mesh, axis)
    return tuple(_all_gather_rows(as_device_tensor(a, None, dev), group)
                 for a in shard_arrays)


def count_min_sketch_sharded(kmers, modulos, dtype=torch.int32):
    """Count-min sketch of the k-mers of every rank: this rank counts its
    own k-mers, one bincount per modulo into that row's range of the flat
    ``(sum(modulos),)`` sketch, then one ``all_reduce`` (the JAX psum).
    Returns the sketch on this rank's device."""
    group, _, _, dev = _group_of()
    k = as_device_tensor(kmers, torch.int64, dev)
    modulos = [int(m) for m in modulos]
    sketch = torch.cat([torch.bincount(k % m, minlength=m)
                        for m in modulos]).to(dtype)
    dist.all_reduce(sketch, group=group)
    return sketch


def _is_array(a) -> bool:
    return isinstance(a, (np.ndarray, torch.Tensor))


def run_sharded_function(func, n_shards, array_args, device="cuda"):
    """Data-parallel map over the leading axis of the array arguments
    (the reference's run_numpy_based_function_in_parallel): ``func`` is a
    torch function whose output rows align with its input rows. Every rank
    passes the whole arguments; they are padded by repeating row 0 to a
    multiple of d = min(n_shards, ranks), rank r < d applies
    ``func`` to its r-th slice, and the results are gathered in rank order
    and cut to the input's length. Other arguments pass whole. Without a
    started process group ``func`` runs on the whole arguments on
    ``device``."""
    lengths = {len(a) for a in array_args if _is_array(a)}
    if len(lengths) != 1:
        raise ValueError("array args must share one leading length")
    n = lengths.pop()
    if not dist.is_initialized():
        dev = resolve_device(device)
        return func(*[as_device_tensor(a, None, dev) if _is_array(a) else a
                      for a in array_args])
    group, world, r, dev = _group_of()
    d = max(1, min(int(n_shards), world))
    per = -(-n // d)
    args = []
    for a in array_args:
        if _is_array(a):
            a = as_device_tensor(a, None, dev)
            if per * d > n:
                a = torch.cat([a, a[:1].expand((per * d - n,)
                                               + tuple(a.shape[1:]))])
            a = a[r * per:(r + 1) * per]
        args.append(a)
    return _all_gather_rows(func(*args), group)[:n]


def _query_slice(index, kmers, n_shards):
    """(group, this rank's contiguous slice of the index's queries)."""
    group, world, r, _ = _group_of()
    q = index._queries(kmers)
    d = max(1, min(int(n_shards or world), world))
    return group, (torch.tensor_split(q, d)[r] if r < d else q[:0])


def has_kmers_sharded(index, kmers, n_shards=None) -> np.ndarray:
    """Data-parallel membership (the reference's has_kmers_parallel): the
    index is replicated, every rank holding it on its card; every rank
    passes the whole batch and answers its contiguous slice through the
    index's own lookup (K2 on the whole packed table; the CSR scan above
    the packed budget), and the answers are gathered in rank order.
    ``n_shards`` caps the ranks that answer. Returns bool per query."""
    group, mine = _query_slice(index, kmers, n_shards)
    hit = index.device_index.has_kmers(mine).to(torch.uint8)
    return _all_gather_rows(hit, group).bool().cpu().numpy()


def map_kmers_sharded(index, kmers, n_nodes: int,
                      n_shards=None) -> np.ndarray:
    """Data-parallel node counts: as :func:`has_kmers_sharded`, each rank
    counting its slice, the counts summed by one ``all_reduce``. Returns
    int64 counts of every node below ``n_nodes``."""
    group, mine = _query_slice(index, kmers, n_shards)
    counts = index.device_index.map_kmers(mine, int(n_nodes))
    dist.all_reduce(counts, group=group)
    return counts.cpu().numpy()
