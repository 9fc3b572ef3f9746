"""Bucket-range table shards and the sharded serving steps: the serving
half of graph_kmer_index_tpu/parallel/sharded.py, on torch.distributed.

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
of its uint64). A rank's columns (checkpoint.load_shards on a mesh) are
tensors on its card with a leading axis of 1.

Not here yet (listed in ROADMAP.md): the sharded builds,
``merge_flat_kmers_all_gather``, ``count_min_sketch_sharded``,
``run_sharded_function`` and ``has/map_kmers_sharded``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..flat_kmers import host_column
from ..ops.encode import sliding_hashes
from ..ops.lookup import (INT64_MAX, PackedTables, _add_node_hits,
                          _bucket_hits_from_ranges, packed_lookup)
from ..ops.packed_layout import DUP2, SCAN_CAP, _dup2_masks, internal_modulo
from .mesh import DATA_AXIS, TABLE_AXIS, coordinates, mesh_device, subgroups

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
