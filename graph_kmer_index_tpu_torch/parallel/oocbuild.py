"""Out-of-core genome-scale index build: bucket-range spills on disk. The
port of graph_kmer_index_tpu/parallel/oocbuild.py by the copy route: host
numpy and the port's native walker; the shard files are the JAX
package's, byte for byte. The workers (the find pool's and the per-range
builds') import numpy alone. ``index_from_shard_checkpoint`` rebuilds a
port KmerIndex on a named device.

The reference's whole pipeline is in-memory: the CLI's ``index`` command
merges every chunk's FlatKmers into one array set
(command_line_interface.py:601-616) and ``make_from_flat`` argsorts the
full row set at once (collision_free_kmer_index.py:422-467). At its own
implied scale — ``--genome-size`` defaults to 3e9
(command_line_interface.py:261) — that is ~4.8 G rows and ~125 GB of row
arrays before the two modulo-sized tables, which does not fit a 128 GB
host in one piece. The reference simply never runs there.

This module makes the build **streaming and bounded**, reusing the
bucket-range-owner decomposition the multi-chip sharded build
(:mod:`.sharded`) already proved bit-equal:

1. **Spill** (:class:`SpillWriter`): as find chunks finish (in chunk
   order), each row is routed to the owner of its bucket range
   (``owner = (kmer % modulo) // ceil(modulo/n_ranges)``) and appended
   to that range's on-disk column files. Only the current chunk is ever
   in memory. A journal (written after the data it covers) makes the
   spill crash-safe and resumable: on reopen, partially-written tails
   beyond the journal are truncated away.
2. **Per-range build** (:func:`build_shards_from_spills`): each range's
   rows are loaded (~total/n_ranges), stably sorted by bucket, turned
   into that shard's local CSR tables + row slabs, and written as one
   shard file of a :mod:`.checkpoint`-compatible checkpoint. Peak memory
   is one range, not the genome. Shard files are atomic, so the build
   stage resumes per shard; spills can be deleted as each shard lands,
   which bounds peak **disk** at ~max(spill, checkpoint) too.
3. **Serve / assemble**: the result is a standard shard checkpoint —
   ``checkpoint.load_shards`` serves it over a mesh without ever
   materializing the whole table, and
   :func:`index_from_shard_checkpoint` reassembles a full ``KmerIndex``
   when it fits (testing, smaller runs).

Bit-equality contract: a global stable sort by bucket, restricted to a
contiguous bucket range, equals the stable sort of that range's rows
taken in global input order — so shard row slabs and sizes are
bit-identical to ``TableShards.from_index(monolithic, n_ranges)`` built
from the same FlatKmers (pinned in tests/test_torch_oocbuild.py). The one
deliberate difference: empty buckets store ``starts = 0`` here, whereas
``from_index`` rebases the monolithic table's zeros to ``-shard_row_lo``
— both are dead values (every reader masks on ``sizes > 0``).

Frequencies use the reference ``set_frequencies`` semantics (distinct
ref offsets per kmer, collision_free_kmer_index.py:267-293); equal kmers
share a bucket, hence a range, so they are computed exactly per shard.
"""
from __future__ import annotations

import json
import logging
import os
import time

import numpy as np

from . import shard_files as ckpt
from ..ops.packed_layout import DUP2, SCAN_CAP, _dup2_masks, internal_modulo
from ..utils.hugepages import cap_malloc_mmap_threshold, hp_empty, hp_zeros

_SPILL_VERSION = 1
_COLS = (("kmers", np.uint64), ("nodes", np.int32),
         ("refs", np.uint64), ("afs", np.float32))
#: the packed-conversion pass only re-routes what its serve path reads
_COLS_KN = _COLS[:2]
_COL_DTYPES = dict(_COLS)


def _range_path(spill_dir: str, t: int, col: str) -> str:
    return os.path.join(spill_dir, f"range-{t:05d}.{col}.bin")


def _chunk_range_path(spill_dir: str, key, t: int, col: str) -> str:
    start, stop = key
    return os.path.join(
        spill_dir, f"chunk-{start:08d}-{stop:08d}.range-{t:05d}.{col}.bin")


def spill_chunk_to_files(spill_dir, key, modulo, n_ranges, m_range,
                         cols_spec, arrays, range_lo=0, range_hi=None):
    """Worker-side spill (layout='chunk'): partition ONE find chunk's
    rows by bucket-range owner and write its per-(chunk, range) files.

    Needs no shared state and no ordering — each chunk owns its file
    names (the find-chunk ``(start, stop)`` critical-path window), so
    the find workers write their own rows instead of pickling ~24 B/row
    through the pool to a single streaming consumer (round-5 profiling:
    the parent-streaming path cost a 2x pickle round trip and left
    ~50-70 chunk-sizes of glibc arena retention in the parent). Writes
    are idempotent (O_TRUNC, deterministic bytes); a chunk present with
    the right sizes is skipped. Returns per-range row counts; the
    PARENT journals them only after the worker returned, i.e. strictly
    after the files were written.
    """
    h = np.ascontiguousarray(arrays[0], dtype=np.uint64)
    cols = tuple(np.ascontiguousarray(v, dtype=dt)
                 for (_, dt), v in zip(cols_spec, arrays))
    owner = (h % np.uint64(modulo)).astype(np.int64) // m_range
    order = np.argsort(owner, kind="stable")
    counts = np.bincount(owner[order], minlength=n_ranges).astype(np.int64)
    bounds = np.concatenate([[0], np.cumsum(counts)])
    if range_hi is None:
        range_hi = n_ranges
    # pass-partitioned spills: rows outside [range_lo, range_hi) are
    # dropped (their counts zeroed) — another find pass owns them
    counts[:range_lo] = 0
    counts[range_hi:] = 0
    for t in range(range_lo, range_hi):
        lo, hi = int(bounds[t]), int(bounds[t + 1])
        if lo == hi:
            continue
        sel = order[lo:hi]
        for (col, dtype), arr in zip(cols_spec, cols):
            path = _chunk_range_path(spill_dir, key, t, col)
            want = (hi - lo) * np.dtype(dtype).itemsize
            if os.path.exists(path) and os.path.getsize(path) == want:
                continue
            with open(path, "wb") as f:
                arr[sel].tofile(f)
    return counts


def _m_range(modulo: int, n_ranges: int) -> int:
    return -(-int(modulo) // int(n_ranges))


class SpillWriter:
    """Append find-chunk rows to per-bucket-range spill files.

    ``add_chunk`` must be called in strictly increasing ``chunk_id``
    order (global input order is what makes the per-range row order
    match the monolithic build's stable sort); completions arriving
    out of order are the caller's to buffer. Chunks already journaled
    are skipped, so a resumed parent can replay the full sequence.
    """

    def __init__(self, spill_dir: str, modulo: int, n_ranges: int,
                 pins: dict | None = None, cols=None, m_range=None,
                 fsync: bool = False, layout: str = "range"):
        # layout="range": one append-only file set per range, chunks
        # appended in order by a single consumer (required when the
        # parent must also see the rows, e.g. find --checkpoint-dir).
        # layout="chunk": one file set per (find-chunk, range), written
        # by the find workers themselves (spill_chunk_to_files); the
        # parent only journals counts, so no rows ever cross the pool.
        # fsync=False is PROCESS-crash-safe by write ordering alone: the
        # journal line is written (buffered) strictly after the data it
        # covers, and buffered writes survive the death of the process.
        # fsync=True additionally survives a kernel/power crash — at
        # ~4*n_ranges fsyncs per chunk, which round-5 profiling showed
        # stalls the spill consumer behind the find workers and backlogs
        # whole chunks in the pool's result queue (the parent's RSS grew to
        # ~75% of the genome's rows before the fix).
        self.spill_dir = spill_dir
        self.modulo = int(modulo)
        self.n_ranges = int(n_ranges)
        # m_range override: the packed conversion needs 16-aligned
        # ranges (record groups must not straddle shards)
        self.m_range = int(m_range) if m_range is not None \
            else _m_range(modulo, n_ranges)
        self.cols = tuple(cols) if cols is not None else _COLS
        self.fsync = bool(fsync)
        if layout not in ("range", "chunk"):
            raise ValueError(f"unknown spill layout {layout!r}")
        self.layout = layout
        os.makedirs(spill_dir, exist_ok=True)
        meta = {"version": _SPILL_VERSION, "modulo": self.modulo,
                "n_ranges": self.n_ranges, "pins": pins or {},
                "cols": [c for c, _ in self.cols],
                "m_range": self.m_range, "layout": self.layout}
        meta_path = os.path.join(spill_dir, "meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                old = json.load(f)
            if old != meta:
                raise ValueError(
                    f"spill dir {spill_dir!r} was written with different "
                    f"inputs ({old} != {meta}); refusing to mix spills")
        else:
            tmp = f"{meta_path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(meta, f)
            os.replace(tmp, meta_path)

        self.journal_path = os.path.join(spill_dir, "journal.jsonl")
        self.range_rows = np.zeros(self.n_ranges, dtype=np.int64)
        self.done: set = set()
        self.chunk_counts: dict = {}
        self._next = 0
        if os.path.exists(self.journal_path):
            with open(self.journal_path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        break  # torn tail line: everything after is void
                    counts = np.asarray(rec["rows"], dtype=np.int64)
                    if self.layout == "chunk":
                        key = (int(rec["start"]), int(rec["stop"]))
                        if key in self.done:
                            continue
                        self.done.add(key)
                        self.chunk_counts[key] = counts
                    else:
                        self.done.add(int(rec["chunk"]))
                    self.range_rows += counts
            if self.layout == "range":
                self._next = (max(self.done) + 1) if self.done else 0
                if self.done != set(range(self._next)):
                    raise ValueError(
                        f"spill journal {self.journal_path!r} has chunk "
                        f"gaps ({sorted(self.done)[:10]}...); cannot "
                        f"resume")
        self._validated = False

    def validate_files(self, skip_ranges=()) -> None:
        """Crash cleanup: drop any partially-appended tail beyond the
        journaled lengths; refuse short/missing files. Runs lazily
        before the first append (``add_chunk``) — a reader of a
        FINISHED spill set whose ranges were already consumed and
        deleted (``delete_spills``) passes those as ``skip_ranges``
        instead of failing on them."""
        if self.layout == "chunk":
            self._validate_chunk_files(skip_ranges)
            return
        for t in range(self.n_ranges):
            if t in skip_ranges:
                continue
            for col, dtype in self.cols:
                path = _range_path(self.spill_dir, t, col)
                want = int(self.range_rows[t]) * np.dtype(dtype).itemsize
                if os.path.exists(path):
                    if os.path.getsize(path) < want:
                        raise ValueError(
                            f"spill file {path} shorter than its "
                            f"journal ({os.path.getsize(path)} < "
                            f"{want}); spill dir is corrupt")
                    if os.path.getsize(path) > want:
                        os.truncate(path, want)
                elif want:
                    raise ValueError(f"spill file {path} missing but "
                                     f"journaled nonempty")
        self._validated = True

    def _validate_chunk_files(self, skip_ranges=()) -> None:
        """layout='chunk': journaled chunk files must exist with exact
        sizes (ranges already consumed+deleted are skipped); files of
        UNjournaled chunks are torn survivors of a crash — deleted (the
        rewrite is idempotent, but stale partial bytes must never be
        readable)."""
        import glob as _glob
        journaled = set()
        for key, counts in self.chunk_counts.items():
            for t in range(self.n_ranges):
                nt = int(counts[t])
                if nt == 0:
                    continue
                for col, dtype in self.cols:
                    path = _chunk_range_path(self.spill_dir, key, t, col)
                    journaled.add(os.path.basename(path))
                    if t in skip_ranges:
                        continue
                    want = nt * np.dtype(dtype).itemsize
                    if not os.path.exists(path) \
                            or os.path.getsize(path) != want:
                        raise ValueError(
                            f"spill file {path} missing or wrong size "
                            f"for its journal entry")
        for path in _glob.glob(os.path.join(self.spill_dir,
                                            "chunk-*.range-*.bin")):
            if os.path.basename(path) not in journaled:
                os.remove(path)
        self._validated = True

    def journal_chunk(self, key, counts) -> None:
        """layout='chunk': record a completed chunk (files already
        written by the worker). Any-order; duplicates are no-ops."""
        assert self.layout == "chunk"
        key = (int(key[0]), int(key[1]))
        if key in self.done:
            return
        counts = np.asarray(counts, dtype=np.int64)
        with open(self.journal_path, "a") as f:
            f.write(json.dumps({"start": key[0], "stop": key[1],
                                "rows": counts.tolist()}) + "\n")
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())
        self.done.add(key)
        self.chunk_counts[key] = counts
        self.range_rows += counts

    def range_segments(self, t: int):
        """layout='chunk': ``[(key, rows_in_t), ...]`` in chunk order
        (ascending start == global input order), zero-row chunks
        skipped."""
        return [(key, int(self.chunk_counts[key][t]))
                for key in sorted(self.chunk_counts)
                if int(self.chunk_counts[key][t])]

    def add_chunk(self, chunk_id: int, hashes, nodes, ref_offsets=None,
                  allele_frequencies=None) -> None:
        if not self._validated:
            self.validate_files()
        chunk_id = int(chunk_id)
        if chunk_id in self.done:
            return
        if chunk_id != self._next:
            raise ValueError(f"add_chunk out of order: got {chunk_id}, "
                             f"expected {self._next}")
        h = np.ascontiguousarray(hashes, dtype=np.uint64)
        vals = (h, nodes, ref_offsets, allele_frequencies)[:len(self.cols)]
        cols = tuple(np.ascontiguousarray(v, dtype=dt)
                     for (_, dt), v in zip(self.cols, vals))
        owner = (h % np.uint64(self.modulo)).astype(np.int64) // self.m_range
        order = np.argsort(owner, kind="stable")
        owner_sorted = owner[order]
        counts = np.bincount(owner_sorted, minlength=self.n_ranges
                             ).astype(np.int64)
        bounds = np.concatenate([[0], np.cumsum(counts)])
        for t in range(self.n_ranges):
            lo, hi = int(bounds[t]), int(bounds[t + 1])
            if lo == hi:
                continue
            sel = order[lo:hi]
            for (col, dtype), arr in zip(self.cols, cols):
                with open(_range_path(self.spill_dir, t, col), "ab") as f:
                    arr[sel].tofile(f)
                    f.flush()
                    if self.fsync:
                        os.fsync(f.fileno())
        # journal strictly after the data it describes is written
        with open(self.journal_path, "a") as f:
            f.write(json.dumps({"chunk": chunk_id,
                                "rows": counts.tolist()}) + "\n")
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())
        self.done.add(chunk_id)
        self._next = chunk_id + 1
        self.range_rows += counts

    def finish(self) -> dict:
        return {"n_chunks": len(self.done),
                "range_rows": self.range_rows.copy(),
                "total_rows": int(self.range_rows.sum())}


def _load_spill_range(spill_dir: str, t: int, n_rows: int, cols=_COLS,
                      segs=None):
    """Read one range's spilled columns into hugepage-advised buffers
    (this host first-touch faults fresh 4 KB pages at ~22 MB/s; a plain
    np.fromfile allocation would serialize on that). ``segs`` (layout
    'chunk': ``[(key, rows), ...]`` in chunk order) concatenates the
    per-chunk files; None reads the contiguous per-range files."""
    out = []
    for col, dtype in cols:
        buf = hp_empty(n_rows, dtype)
        isz = np.dtype(dtype).itemsize
        if n_rows and segs is None:
            with open(_range_path(spill_dir, t, col), "rb") as f:
                got = f.readinto(memoryview(buf).cast("B"))
            assert got == n_rows * isz, (col, t, got, n_rows)
        elif n_rows:
            mv = memoryview(buf).cast("B")
            off = 0
            for key, nr in segs:
                with open(_chunk_range_path(spill_dir, key, t, col),
                          "rb") as f:
                    got = f.readinto(mv[off * isz:(off + nr) * isz])
                assert got == nr * isz, (col, t, key, got, nr)
                off += nr
            assert off == n_rows, (col, t, off, n_rows)
        out.append(buf)
    return out


def _delete_range_spills(writer: "SpillWriter", t: int) -> None:
    if writer.layout == "chunk":
        for key, _ in writer.range_segments(t):
            for col, _d in writer.cols:
                path = _chunk_range_path(writer.spill_dir, key, t, col)
                if os.path.exists(path):
                    os.remove(path)
    else:
        for col, _d in writer.cols:
            path = _range_path(writer.spill_dir, t, col)
            if os.path.exists(path):
                os.remove(path)


def _run_chunk_spill(chunk):
    """Find-pool worker for the worker-side spill mode: walk the chunk,
    expand rows locally, write this chunk's per-range spill files, and
    return only the per-range counts (never the rows) and the seconds
    the spill writes took. Chunks already journaled by a previous (killed)
    run are skipped entirely — resume-without-find-checkpoint re-walks
    nothing."""
    from .host_pool import _WORKER_STATE, _check_walker
    from ..finder import DenseKmerFinder

    cap_malloc_mmap_threshold()
    s = _WORKER_STATE
    cfg = s["finder_kwargs"]["_spill_cfg"]
    start, stop = chunk
    if (start, stop) in cfg["done"]:
        return (start, stop, None, 0.0)
    kwargs = {k: v for k, v in s["finder_kwargs"].items()
              if k != "_spill_cfg"}
    finder = DenseKmerFinder(
        s["graph"], s["k"], critical_graph_paths=s["critical_paths"],
        position_id=s["position_id"],
        start_at_critical_path_number=start,
        stop_at_critical_path_number=stop,
        use_device=False, **kwargs)
    finder.find()
    _check_walker(finder)
    flat = finder.get_flat_kmers(v="1")
    spill_cols = tuple((c, _COL_DTYPES[c])
                       for c in cfg.get("cols", [c for c, _ in _COLS]))
    arrays = (np.asarray(flat._hashes), np.asarray(flat._nodes),
              np.asarray(flat._ref_offsets),
              np.asarray(flat._allele_frequencies))[:len(spill_cols)]
    t0 = time.perf_counter()
    counts = spill_chunk_to_files(
        cfg["spill_dir"], (start, stop), cfg["modulo"], cfg["n_ranges"],
        cfg["m_range"], spill_cols, arrays,
        range_lo=cfg.get("range_lo", 0), range_hi=cfg.get("range_hi"))
    return (start, stop, counts, time.perf_counter() - t0)


def _frequencies_by_distinct_ref_offsets(kmers_sorted, ref_offsets_sorted):
    """frequency[row] = number of DISTINCT ref offsets among rows with the
    same kmer (reference set_frequencies semantics,
    collision_free_kmer_index.py:267-293), vectorized: lexsort by
    (kmer, ref_offset), count unique pairs per kmer segment; uint16, as
    the index's column (models.kmer_index computes the same on a
    device)."""
    n = len(kmers_sorted)
    if n == 0:
        return np.zeros(0, dtype=np.uint16)
    order = np.lexsort((ref_offsets_sorted, kmers_sorted))
    km = kmers_sorted[order]
    ro = ref_offsets_sorted[order]
    new_kmer = np.ediff1d(km, to_begin=km.dtype.type(1)) != 0
    new_pair = new_kmer | (np.ediff1d(ro, to_begin=ro.dtype.type(1)) != 0)
    seg_id = np.cumsum(new_kmer) - 1
    counts = np.bincount(seg_id, weights=new_pair.astype(np.int64)
                         ).astype(np.int64)
    freqs = np.zeros(n, dtype=np.uint16)
    freqs[order] = counts[seg_id]
    return freqs


def _shard_meta_path(prefix: str, t: int, n_table: int) -> str:
    return f"{prefix}.shard-{t:05d}-of-{n_table:05d}.meta.json"


def _build_one_shard(arg) -> tuple:
    """Module-level per-shard build (one bucket range: load, stable
    sort, CSR tables, atomic write) — callable serially or from a
    torch-free SubprocessPool worker. Returns ``(t, max_scan, max_node)``.
    """
    (spill_dir, out_prefix, t, n_ranges, modulo, nt, rmax,
     skip_frequencies, segs, col_names, m_range) = arg
    cap_malloc_mmap_threshold()

    spill_cols = tuple((c, _COL_DTYPES[c]) for c in col_names)
    kn_only = len(spill_cols) == 2
    loaded = _load_spill_range(spill_dir, t, nt, cols=spill_cols,
                               segs=segs)
    kmers, nodes = loaded[0], loaded[1]
    refs = loaded[2] if not kn_only else None
    afs = loaded[3] if not kn_only else None
    local = ((kmers % np.uint64(modulo)).astype(np.int64)
             - t * m_range)
    order = np.argsort(local, kind="stable")
    local = local[order]
    kmers, nodes = kmers[order], nodes[order]
    if not kn_only:
        refs, afs = refs[order], afs[order]

    diffs = (np.ediff1d(local, to_begin=np.int64(1))
             if nt else np.zeros(0, np.int64))
    bstarts = np.nonzero(diffs)[0]
    ubuckets = local[bstarts]
    n_entries = (np.ediff1d(bstarts, to_end=nt - bstarts[-1])
                 if len(bstarts) else np.zeros(0, np.int64))
    starts_tbl = hp_zeros(m_range, np.int64, populate=True)
    sizes_tbl = hp_zeros(m_range, np.int32, populate=True)
    starts_tbl[ubuckets] = bstarts
    sizes_tbl[ubuckets] = n_entries
    shard_scan = int(n_entries.max()) if len(n_entries) else 0
    shard_node = int(nodes.max()) if nt else 0

    def pad(a, dtype):
        # stored UNPADDED: load_shards pads to the manifest shape, so
        # per-shard builds never depend on the global max range size
        return np.ascontiguousarray(a, dtype=dtype)

    cols = {"starts": starts_tbl, "sizes": sizes_tbl,
            "row_kmers": pad(kmers, np.uint64),
            "row_nodes": pad(nodes, np.int32),
            "n_rows": np.int64(nt)}
    if not kn_only:
        cols["row_ref_offsets"] = pad(refs, np.uint64)
        cols["row_afs"] = pad(afs, np.float32)
        if not skip_frequencies:
            cols["row_frequencies"] = pad(
                _frequencies_by_distinct_ref_offsets(kmers, refs),
                np.uint16)
    ckpt._atomic_savez(ckpt.shard_path(out_prefix, t, n_ranges), **cols)
    mpath = _shard_meta_path(out_prefix, t, n_ranges)
    tmp = f"{mpath}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        # "extras" pins the column set: a resume under a different
        # skip_frequencies/cols flag must REBUILD, not silently reuse a
        # shard whose columns no longer match the manifest
        shard_extras = [] if kn_only else (
            ["row_ref_offsets", "row_afs"]
            + ([] if skip_frequencies else ["row_frequencies"]))
        json.dump({"rows": nt, "rmax": rmax, "max_scan": shard_scan,
                   "max_node": shard_node, "extras": shard_extras}, f)
    os.replace(tmp, mpath)
    return t, shard_scan, shard_node


def build_shards_from_spills(spill_dir: str, out_prefix: str,
                             skip_frequencies: bool = False,
                             delete_spills: bool = False,
                             keep_ranges: tuple = (),
                             n_workers: int = 1,
                             only_ranges=None,
                             write_manifest: bool = True) -> dict:
    """Per-range merge+build with bounded peak memory.

    For each bucket range: load its spilled rows, stable-sort by bucket,
    emit the shard's local CSR tables + padded row slabs (plus the full
    index's extra columns: ref offsets, allele frequencies and — unless
    skipped — reference-semantics frequencies) as one atomic
    ``checkpoint.shard_path`` file. The manifest is written last, after
    every shard landed, carrying the cross-shard aggregates
    (``max_scan``, ``max_node``) and the extra-column names.

    Already-present shard files are skipped (their sidecar meta carries
    their aggregates), so an interrupted build resumes per shard.
    ``n_workers > 1`` builds ranges concurrently in torch-free subprocess
    workers (ranges are independent; peak memory becomes
    ``n_workers * range``, so size ``n_ranges`` accordingly).
    Returns ``{"prefix", "n_table", "total_rows", "max_scan"}``.
    """
    with open(os.path.join(spill_dir, "meta.json")) as f:
        meta = json.load(f)
    modulo = int(meta["modulo"])
    n_ranges = int(meta["n_ranges"])
    writer = SpillWriter(
        spill_dir, modulo, n_ranges, pins=meta.get("pins") or {},
        cols=tuple((c, _COL_DTYPES[c]) for c in meta["cols"]),
        m_range=meta.get("m_range"),
        layout=meta.get("layout", "range"))
    # the writer's m_range honors any meta override (the routing the
    # spill was actually written with) — never recompute it here
    m_range = writer.m_range
    range_rows = writer.range_rows
    rmax = max(1, int(range_rows.max()) if len(range_rows) else 1)

    max_scan = 1
    max_node = 0
    kn_only = len(writer.cols) == 2
    if kn_only:
        extras = []
    else:
        extras = ["row_ref_offsets", "row_afs"]
        if not skip_frequencies:
            extras.append("row_frequencies")

    todo = []
    other_columns = {}  # shards built under other flags -> their columns
    build_set = range(n_ranges) if only_ranges is None else only_ranges
    for t in build_set:
        spath = ckpt.shard_path(out_prefix, t, n_ranges)
        mpath = _shard_meta_path(out_prefix, t, n_ranges)
        if os.path.exists(spath) and os.path.exists(mpath):
            with open(mpath) as f:
                sm = json.load(f)
            if (sm["rows"] == int(range_rows[t]) and sm["rmax"] == rmax
                    and sm.get("extras") == extras):
                max_scan = max(max_scan, sm["max_scan"])
                max_node = max(max_node, sm["max_node"])
                logging.info("ooc build: shard %d/%d already built; "
                             "skipping", t, n_ranges)
                continue
            if sm.get("extras") != extras:
                other_columns[t] = sm.get("extras")
        todo.append((spill_dir, out_prefix, t, n_ranges, modulo,
                     int(range_rows[t]), rmax, skip_frequencies,
                     writer.range_segments(t)
                     if writer.layout == "chunk" else None,
                     [c for c, _ in writer.cols], m_range))
    # already-built ranges may legitimately have had their spills
    # deleted; only the ranges still to build need intact files
    try:
        writer.validate_files(
            skip_ranges=set(range(n_ranges)) - {a[2] for a in todo})
    except ValueError as e:
        if not other_columns:
            raise
        raise ValueError(
            f"shards {sorted(other_columns)} were built with the columns "
            f"{sorted(map(str, other_columns.values()))[0]}, and these "
            f"flags (skip_frequencies, spill columns) ask for {extras}; "
            f"their spills are gone, so {spill_dir} cannot rebuild them: "
            f"delete it to find again") from e

    def done_one(t, shard_scan, shard_node):
        nonlocal max_scan, max_node
        max_scan = max(max_scan, shard_scan)
        max_node = max(max_node, shard_node)
        logging.info("ooc build: shard %d/%d built (%d rows, scan<=%d)",
                     t, n_ranges, int(range_rows[t]), shard_scan)
        if delete_spills and t not in keep_ranges:
            _delete_range_spills(writer, t)

    if n_workers > 1 and len(todo) > 1:
        from .proc_pool import SubprocessPool
        with SubprocessPool(min(n_workers, len(todo))) as pool:
            for _, res in pool.imap_unordered(
                    _build_one_shard, [(a[2], a) for a in todo]):
                done_one(*res)
    else:
        for a in todo:
            done_one(*_build_one_shard(a))

    if write_manifest:
        ckpt._atomic_savez(
            ckpt.manifest_path(out_prefix),
            kind="csr", version=ckpt._VERSION, n_table=n_ranges,
            m_local=m_range, modulo=modulo, max_scan=max_scan,
            max_node=max_node,
            extras=np.asarray(extras),
            shard_rows=range_rows.astype(np.int64),
            shape_starts=np.asarray([m_range], dtype=np.int64),
            shape_sizes=np.asarray([m_range], dtype=np.int64),
            shape_row_kmers=np.asarray([rmax], dtype=np.int64),
            shape_row_nodes=np.asarray([rmax], dtype=np.int64))
    return {"prefix": out_prefix, "n_table": n_ranges,
            "total_rows": int(range_rows.sum()), "max_scan": max_scan}


def finalize_csr_manifest(out_prefix: str, n_ranges: int, modulo: int,
                          m_range=None) -> dict:
    """Write the manifest for a shard set assembled across several
    build calls (pass-partitioned spills): every shard's sidecar meta
    carries its rows/max_scan/max_node/extras; the manifest is their
    aggregate. All sidecars must exist and agree on the column set."""
    if m_range is None:
        m_range = _m_range(modulo, n_ranges)
    shard_rows = np.zeros(n_ranges, dtype=np.int64)
    max_scan, max_node = 1, 0
    extras = None
    for t in range(n_ranges):
        with open(_shard_meta_path(out_prefix, t, n_ranges)) as f:
            sm = json.load(f)
        shard_rows[t] = sm["rows"]
        max_scan = max(max_scan, sm["max_scan"])
        max_node = max(max_node, sm["max_node"])
        if extras is None:
            extras = sm.get("extras", [])
        elif sm.get("extras", []) != extras:
            raise ValueError(f"shard {t} column set {sm.get('extras')} "
                             f"differs from {extras}; passes were built "
                             f"with different flags")
    rmax = max(1, int(shard_rows.max()))
    ckpt._atomic_savez(
        ckpt.manifest_path(out_prefix),
        kind="csr", version=ckpt._VERSION, n_table=n_ranges,
        m_local=m_range, modulo=modulo, max_scan=max_scan,
        max_node=max_node, extras=np.asarray(extras),
        shard_rows=shard_rows,
        shape_starts=np.asarray([m_range], dtype=np.int64),
        shape_sizes=np.asarray([m_range], dtype=np.int64),
        shape_row_kmers=np.asarray([rmax], dtype=np.int64),
        shape_row_nodes=np.asarray([rmax], dtype=np.int64))
    return {"prefix": out_prefix, "n_table": n_ranges,
            "total_rows": int(shard_rows.sum()), "max_scan": max_scan}


def index_from_shard_checkpoint(prefix: str, device="cuda"):
    """Reassemble a full ``KmerIndex`` on ``device`` from an out-of-core
    shard checkpoint (requires the whole row set to fit in memory — the
    genome-scale path serves via ``checkpoint.load_shards`` on a mesh
    instead): k-mers and nodes on the device, the other columns on the
    host until a query path reads them, as ``KmerIndex.from_file`` leaves
    them. Bit-equal to ``from_flat_kmers`` on the same rows
    (tests/test_torch_oocbuild.py)."""
    from ..models.kmer_index import KmerIndex

    with np.load(ckpt.manifest_path(prefix)) as z:
        n_table = int(z["n_table"])
        m_range = int(z["m_local"])
        modulo = int(z["modulo"])
        shard_rows = z["shard_rows"].astype(np.int64)
        extras = [str(s) for s in z["extras"]] if "extras" in z.files \
            else []
    if "row_ref_offsets" not in extras:
        raise ValueError(
            "this checkpoint was built with spill_cols='kn' (serving "
            "columns only); a full KmerIndex cannot be "
            "reassembled from it — serve it via checkpoint.load_shards")
    total = int(shard_rows.sum())
    kmers = hp_empty(total, np.uint64)
    nodes = hp_empty(total, np.int32)
    refs = hp_empty(total, np.uint64)
    afs = hp_empty(total, np.float32)
    freqs = hp_empty(total, np.uint16) if "row_frequencies" in extras \
        else None
    starts_g = hp_zeros(modulo, np.int64, populate=True)
    sizes_g = hp_zeros(modulo, np.uint32, populate=True)
    off = 0
    for t in range(n_table):
        nt = int(shard_rows[t])
        with np.load(ckpt.shard_path(prefix, t, n_table)) as z:
            # the last ranges of an m_range*n_ranges > modulo layout are
            # pure padding: no bucket (hence no row) can land there
            b0 = min(modulo, t * m_range)
            b1 = min(modulo, b0 + m_range)
            sizes_t = z["sizes"][: b1 - b0]
            nz = sizes_t > 0
            starts_g[b0:b1][nz] = z["starts"][: b1 - b0][nz] + off
            sizes_g[b0:b1] = sizes_t
            kmers[off:off + nt] = z["row_kmers"][:nt]
            nodes[off:off + nt] = z["row_nodes"][:nt]
            refs[off:off + nt] = z["row_ref_offsets"][:nt]
            afs[off:off + nt] = z["row_afs"][:nt]
            if freqs is not None:
                freqs[off:off + nt] = z["row_frequencies"][:nt]
        off += nt
    return KmerIndex.from_arrays(
        kmers, nodes, modulo, device, ref_offsets=refs,
        frequencies=freqs if freqs is not None else 0,
        allele_frequencies=afs, hashes_to_index=starts_g, n_kmers=sizes_g)


def find_and_build_out_of_core(graph, k, n_workers, workdir,
                               modulo=452930477, n_ranges=32,
                               critical_paths=None, position_id=None,
                               chunks_per_worker=20,
                               skip_frequencies=False,
                               delete_spills=True, keep_ranges=(),
                               checkpoint_dir=None, mp_context=None,
                               out_prefix=None, build_workers=None,
                               stash_ram_chunks=None, spill_cols="full",
                               n_spill_passes=1, require_native=False,
                               stats=None, **finder_kwargs) -> dict:
    """Genome-scale pipeline: pooled find → bucket-range spill →
    per-range build → shard checkpoint at ``out_prefix``.

    Default (no ``checkpoint_dir``): WORKER-SIDE spill — each find
    worker writes its own chunk's per-(chunk, range) files and ships
    only per-range counts back; no row ever crosses the pool, the
    parent's memory stays ~the graph, and a killed run's journaled
    chunks are skipped entirely on re-run (resume without a second
    on-disk row copy). With ``checkpoint_dir``, rows come back to the
    parent (persisted per chunk as find-checkpoint npz) and stream into
    append-only per-range files in chunk order, with out-of-order
    completions past a small RAM cap stashed to disk.

    ``require_native``: a chunk that the Python walker took raises (at
    chromosome scale that route runs for hours). ``stats``: a dict that
    receives ``find_seconds`` (the pooled find, its workers' spill writes
    included), ``spill_write_seconds`` (those writes, summed over the
    workers; worker-spill mode), ``build_seconds`` (the per-range builds)
    and ``spill_bytes`` (the rows spilled times their columns' bytes).
    """
    from .host_pool import (_find_pooled, _graph_fingerprint, _run_chunk,
                            _value_fingerprint, plan_chunks)
    from ..critical_paths import CriticalGraphPaths

    if critical_paths is None:
        critical_paths = CriticalGraphPaths.from_graph(graph, k)
    if position_id is None:
        from ..graph import PositionId
        position_id = PositionId.from_graph(graph)

    cap_malloc_mmap_threshold()  # streaming consumer: see hugepages.py
    chunks = plan_chunks(len(critical_paths), n_workers,
                         chunks_per_worker)
    pins = {"graph": _graph_fingerprint(graph), "k": int(k),
            "kwargs": {kk: _value_fingerprint(v)
                       for kk, v in sorted(finder_kwargs.items())},
            # a resume with a different worker count would re-chunk the
            # worklist; journaled rows from the old chunking would then
            # double-count — refuse instead
            "chunking": [len(chunks), chunks[0][1] - chunks[0][0]
                         if chunks else 0]}
    spill_dir = os.path.join(workdir, "spill")
    if out_prefix is None:
        out_prefix = os.path.join(workdir, "index")

    worker_spill = checkpoint_dir is None
    if spill_cols not in ("full", "kn"):
        raise ValueError(f"spill_cols must be 'full' or 'kn', got "
                         f"{spill_cols!r}")
    # 'kn' spills only what the serving lookups read (kmers+nodes):
    # half the disk, no ref-offset/AF/frequency columns in the result —
    # the membership/counts checkpoint for map_kmers-style serving
    cols = _COLS if spill_cols == "full" else _COLS_KN
    if spill_cols == "kn" and not worker_spill:
        raise ValueError("spill_cols='kn' requires the worker-spill "
                         "mode (no checkpoint_dir)")
    if n_spill_passes > 1 and not worker_spill:
        raise ValueError("n_spill_passes requires the worker-spill "
                         "mode (no checkpoint_dir)")
    if int(n_spill_passes) < 1:
        raise ValueError(f"n_spill_passes must be >= 1, got "
                         f"{n_spill_passes}")
    if stats is None:
        stats = {}
    stats.update(find_seconds=0.0, spill_write_seconds=0.0,
                 build_seconds=0.0, spill_bytes=0)
    row_bytes = sum(np.dtype(dt).itemsize for _, dt in cols)

    if worker_spill:
        # Pass-partitioned spills: pass p finds the WHOLE graph but
        # spills only bucket ranges [lo, hi), builds+deletes them, then
        # the next pass runs — peak disk drops to ~spill/n_passes +
        # checkpoint, at the cost of walking the graph n_passes times.
        # Unpadded shard storage (checkpoint._read_shard pads at load)
        # makes per-pass builds independent of the global max range.
        per_pass = -(-n_ranges // int(n_spill_passes))
        expected_extras = [] if spill_cols == "kn" else (
            ["row_ref_offsets", "row_afs"]
            + ([] if skip_frequencies else ["row_frequencies"]))
        total_spilled = 0
        for p_i in range(n_spill_passes):
            lo = p_i * per_pass
            hi = min(n_ranges, lo + per_pass)
            sd = (spill_dir if n_spill_passes == 1
                  else os.path.join(workdir, f"spill_pass{p_i}"))
            # the window pin only exists for multi-pass spills: adding
            # it to single-pass meta would refuse resumes of spill dirs
            # written before this feature existed
            pass_pins = (pins if n_spill_passes == 1
                         else {**pins, "window": [lo, hi]})
            writer = SpillWriter(sd, modulo, n_ranges, pins=pass_pins,
                                 cols=cols, layout="chunk")
            # torn files of unjournaled chunks must be gone BEFORE
            # workers start rewriting them — ranges outside this pass's
            # window and ranges whose shards already landed (resume /
            # re-entry after delete_spills) legitimately have no files
            built = {t for t in range(n_ranges)
                     if os.path.exists(ckpt.shard_path(out_prefix, t,
                                                       n_ranges))
                     and os.path.exists(_shard_meta_path(out_prefix, t,
                                                         n_ranges))}
            outside = set(range(n_ranges)) - set(range(lo, hi))
            writer.validate_files(skip_ranges=outside | built)
            window_built = set(range(lo, hi)) <= built
            if window_built and len(writer.done) == 0:
                # every shard of the window exists and nothing is
                # spilled: a prior run finished this pass — but ONLY
                # reuse shards whose column set matches the CURRENT
                # flags; otherwise wipe them and re-run the pass (the
                # spills are gone, so honoring the flag means
                # re-finding)
                stale = []
                for t in range(lo, hi):
                    with open(_shard_meta_path(out_prefix, t,
                                               n_ranges)) as f:
                        sm = json.load(f)
                    if sm.get("extras") != expected_extras:
                        stale.append(t)
                if not stale:
                    continue
                logging.warning(
                    "ooc: shards %s were built with a different column "
                    "set (%s != %s); rebuilding this pass", stale,
                    sm.get("extras"), expected_extras)
                for t in stale:
                    os.remove(ckpt.shard_path(out_prefix, t, n_ranges))
                    os.remove(_shard_meta_path(out_prefix, t, n_ranges))
            fk = dict(finder_kwargs)
            fk["_spill_cfg"] = {
                "spill_dir": sd, "modulo": int(modulo),
                "n_ranges": int(n_ranges), "m_range": writer.m_range,
                "cols": [c for c, _ in writer.cols],
                "range_lo": lo, "range_hi": hi,
                "done": frozenset(writer.done)}

            def on_result(i, r):
                start, stop, counts, seconds = r
                stats["spill_write_seconds"] += seconds
                if counts is not None:
                    writer.journal_chunk((start, stop), counts)

            t0 = time.perf_counter()
            _find_pooled(_run_chunk_spill, graph, k, n_workers,
                         critical_paths, position_id, chunks_per_worker,
                         fk, checkpoint_dir=None, mp_context=mp_context,
                         on_result=on_result, require_native=require_native)
            stats["find_seconds"] += time.perf_counter() - t0
            total_spilled += int(writer.range_rows.sum())
            t0 = time.perf_counter()
            build_shards_from_spills(
                sd, out_prefix, skip_frequencies=skip_frequencies,
                delete_spills=delete_spills, keep_ranges=keep_ranges,
                n_workers=n_workers if build_workers is None
                else build_workers,
                only_ranges=range(lo, hi),
                write_manifest=False)
            stats["build_seconds"] += time.perf_counter() - t0
        stats["spill_bytes"] = total_spilled * row_bytes
        res = finalize_csr_manifest(out_prefix, n_ranges, modulo)
        res["spilled_rows"] = res["total_rows"]
        logging.info("ooc: %d rows across %d pass(es), %d newly spilled",
                     res["total_rows"], n_spill_passes, total_spilled)
        return res
    else:
        # Out-of-order completions can pile up while a straggler chunk
        # blocks the consecutive prefix (the other workers keep
        # consuming the task list), so only a few are held in RAM; the
        # rest stash to disk — peak parent memory stays
        # O(n_workers * chunk), not O(genome).
        pending: dict = {}
        state = {"next": 0}
        ram_cap = max(2, int(n_workers)) if stash_ram_chunks is None \
            else int(stash_ram_chunks)
        stash_dir = os.path.join(workdir, "stash")
        if os.path.isdir(stash_dir):
            import shutil
            shutil.rmtree(stash_dir)  # stale stash from a killed run
        _STASHED = object()

        def _stash_path(i):
            return os.path.join(stash_dir, f"chunk-{i:08d}.npz")

        def _consume(r):
            h, n, ro, af = r
            writer.add_chunk(state["next"], h, n, ro, af)
            state["next"] += 1

        def on_result(i, r):
            if i != state["next"] and len(pending) >= ram_cap:
                os.makedirs(stash_dir, exist_ok=True)
                np.savez(_stash_path(i),
                         **{f"a{j}": a for j, a in enumerate(r)})
                pending[i] = _STASHED
            else:
                pending[i] = r
            while state["next"] in pending:
                r2 = pending.pop(state["next"])
                if r2 is _STASHED:
                    with np.load(_stash_path(state["next"])) as z:
                        r2 = tuple(z[f"a{j}"] for j in range(4))
                    os.remove(_stash_path(state["next"]))
                _consume(r2)

        writer = SpillWriter(spill_dir, modulo, n_ranges, pins=pins,
                             cols=cols, layout="range")
        t0 = time.perf_counter()
        _find_pooled(_run_chunk, graph, k, n_workers, critical_paths,
                     position_id, chunks_per_worker, finder_kwargs,
                     checkpoint_dir=checkpoint_dir,
                     mp_context=mp_context, on_result=on_result,
                     require_native=require_native)
        stats["find_seconds"] = time.perf_counter() - t0
        assert not pending, "chunk stream ended with a gap in the prefix"
    spill = writer.finish()
    stats["spill_bytes"] = spill["total_rows"] * row_bytes
    logging.info("ooc find: %d chunks, %d rows spilled",
                 spill["n_chunks"], spill["total_rows"])
    t0 = time.perf_counter()
    res = build_shards_from_spills(
        spill_dir, out_prefix, skip_frequencies=skip_frequencies,
        delete_spills=delete_spills, keep_ranges=keep_ranges,
        n_workers=n_workers if build_workers is None else build_workers)
    stats["build_seconds"] = time.perf_counter() - t0
    res["spilled_rows"] = spill["total_rows"]
    return res


# -- out-of-core PACKED layout (the production serving table) ---------------

def _build_packed_shard(arg) -> tuple:
    """One modulo2-bucket range of the packed-record layout — the same
    construction as ``PackedTableShards.from_index`` (sharded.py:305)
    restricted to a shard: a bucket's record group never straddles a
    shard (16-aligned ranges) and dup2 adjacency is bucket-local, so
    the restriction is exact. Returns ``(t, max_scan, has_dup,
    max_node)``."""
    (spill_dir, out_prefix, t, n_table, modulo2, m2_local, nt,
     rmax, segs) = arg
    cap_malloc_mmap_threshold()

    kmers, nodes = _load_spill_range(spill_dir, t, nt, cols=_COLS_KN,
                                     segs=segs)
    bs = ((kmers % np.uint64(modulo2)).astype(np.int64)
          - t * m2_local)
    order = np.argsort(bs, kind="stable")
    bs, ks = bs[order], kmers[order]
    ns = nodes[order].astype(np.uint32)

    first = (np.ediff1d(bs, to_begin=np.int64(1)) != 0) if nt \
        else np.zeros(0, bool)
    second = np.concatenate([[False], first[:-1]]) & ~first \
        if nt else first
    sizes_at = np.zeros(m2_local, np.int64)
    np.add.at(sizes_at, bs, 1)
    sz_row = sizes_at[bs]
    max_scan = int(sz_row.max()) if nt else 1
    if max_scan > SCAN_CAP:
        raise ValueError(
            "table has buckets deeper than SCAN_CAP; use the CSR "
            "layout for this index")

    idx_local = np.arange(nt, dtype=np.int64)
    # multi-GB allocate-then-fill: hugepage-advised (a host
    # quirk — fresh 4 KB pages fault at ~22 MB/s)
    rec = hp_empty(8 * m2_local, np.uint32)
    rec[:] = np.uint32(0xFFFFFFFF)
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

    def pad(a, dtype):
        return np.ascontiguousarray(a, dtype=dtype)

    ckpt._atomic_savez(
        ckpt.shard_path(out_prefix, t, n_table),
        records=rec.reshape(m2_local // 16, 128),
        row_kmers=pad(ks, np.uint64),
        row_nodes=pad(ns.astype(np.int32), np.int32))
    has_dup = bool(dup_b.any())
    max_node = int(nodes.max()) if nt else 0
    mpath = _shard_meta_path(out_prefix, t, n_table)
    tmp = f"{mpath}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"rows": nt, "rmax": rmax, "max_scan": max_scan,
                   "has_dup": has_dup, "max_node": max_node}, f)
    os.replace(tmp, mpath)
    return t, max_scan, has_dup, max_node


def convert_checkpoint_to_packed(csr_prefix: str, workdir: str,
                                 out_prefix: str | None = None,
                                 n_table: int | None = None,
                                 n_workers: int = 1,
                                 delete_spills: bool = True) -> dict:
    """Out-of-core CSR checkpoint → out-of-core PACKED checkpoint.

    The packed layout (ops/lookup.py: one 32-byte record gather per
    query) hashes by its own internal ``next_prime(2n)`` modulo, so a
    conversion is a full re-partition: each CSR shard's rows are read
    once (in global row order) and re-spilled to the owner of their
    modulo2-bucket range, then each range builds its packed shard —
    peak memory stays ~rows/n_table. The result serves through the
    existing ``checkpoint.load_shards`` + ``make_count_step_packed`` /
    ``make_member_step_packed`` mesh steps and is bit-identical to
    ``PackedTableShards.from_index`` of the monolithic index
    (tests/test_torch_oocbuild.py).

    Disk note: packed records cost 32 B/bucket at ~2 buckets/row —
    ~64 B/row of checkpoint (it is the serving fleet's HBM-resident
    table). A 3 Gb genome's packed set is ~300 GB spread over the
    fleet; size ``n_table`` so each shard fits one device's HBM.
    """
    with np.load(ckpt.manifest_path(csr_prefix)) as z:
        n_csr = int(z["n_table"])
        shard_rows = z["shard_rows"].astype(np.int64)
    n = int(shard_rows.sum())
    if n_table is None:
        n_table = n_csr
    modulo2 = internal_modulo(n)
    per_shard = -(-modulo2 // n_table)
    m2_local = 16 * (-(-per_shard // 16))

    spill_dir = os.path.join(workdir, "spill2")
    if out_prefix is None:
        out_prefix = os.path.join(workdir, "packed")
    writer = SpillWriter(spill_dir, modulo2, n_table,
                         pins={"csr": os.path.abspath(csr_prefix),
                               "rows": n},
                         cols=_COLS_KN, m_range=m2_local)
    # pass 1: CSR shards in order == global row order; chunk = shard
    for t in range(n_csr):
        if t in writer.done:
            continue
        nt = int(shard_rows[t])
        with np.load(ckpt.shard_path(csr_prefix, t, n_csr)) as z:
            writer.add_chunk(t, z["row_kmers"][:nt], z["row_nodes"][:nt])
    spill = writer.finish()
    assert spill["total_rows"] == n, (spill["total_rows"], n)

    # pass 2: per-range packed builds
    rmax = max(1, int(writer.range_rows.max()))
    max_scan, has_dup, max_node = 1, False, 0
    todo = []
    for t in range(n_table):
        spath = ckpt.shard_path(out_prefix, t, n_table)
        mpath = _shard_meta_path(out_prefix, t, n_table)
        if os.path.exists(spath) and os.path.exists(mpath):
            with open(mpath) as f:
                sm = json.load(f)
            if sm["rows"] == int(writer.range_rows[t]) \
                    and sm["rmax"] == rmax:
                max_scan = max(max_scan, sm["max_scan"])
                has_dup = has_dup or sm["has_dup"]
                max_node = max(max_node, sm["max_node"])
                continue
        todo.append((spill_dir, out_prefix, t, n_table, modulo2,
                     m2_local, int(writer.range_rows[t]), rmax, None))
    writer.validate_files(
        skip_ranges=set(range(n_table)) - {a[2] for a in todo})

    def done_one(t, s_scan, s_dup, s_node):
        nonlocal max_scan, has_dup, max_node
        max_scan = max(max_scan, s_scan)
        has_dup = has_dup or s_dup
        max_node = max(max_node, s_node)
        logging.info("packed ooc: shard %d/%d built", t, n_table)
        if delete_spills:
            _delete_range_spills(writer, t)

    if n_workers > 1 and len(todo) > 1:
        from .proc_pool import SubprocessPool
        with SubprocessPool(min(n_workers, len(todo))) as pool:
            for _, res in pool.imap_unordered(
                    _build_packed_shard, [(a[2], a) for a in todo]):
                done_one(res[0], res[1], res[2], res[3])
    else:
        for a in todo:
            done_one(*_build_packed_shard(a))

    ckpt._atomic_savez(
        ckpt.manifest_path(out_prefix),
        kind="packed", version=ckpt._VERSION, n_table=n_table,
        m2_local=m2_local, modulo2=modulo2, max_scan=max_scan,
        has_dup=int(has_dup), max_node=max_node,
        shard_rows=writer.range_rows.astype(np.int64),
        shape_records=np.asarray([m2_local // 16, 128], dtype=np.int64),
        shape_row_kmers=np.asarray([rmax], dtype=np.int64),
        shape_row_nodes=np.asarray([rmax], dtype=np.int64))
    return {"prefix": out_prefix, "n_table": n_table, "total_rows": n,
            "modulo2": modulo2, "max_scan": max_scan}


def reshard_checkpoint(prefix: str, out_prefix: str,
                       new_n_table: int) -> dict:
    """Merge adjacent bucket-range shards of a CSR checkpoint:
    ``n_table -> new_n_table`` (must divide it). Build-time shard counts
    are chosen for per-range memory (e.g. 32 at 1 Gb); serving wants
    one shard per mesh device (e.g. 8) — ranges are contiguous bucket
    intervals, so k adjacent shards merge by concatenating rows and
    re-basing their local starts, one group in memory at a time.
    The merged row stream is identical to a direct ``new_n_table``
    build (rows are globally bucket-sorted either way); the bucket
    tables use ``m_local_new = k * m_local`` (which can differ from a
    direct build's own ceil-division by a few padding buckets — the
    container is self-describing and serves identically,
    tests/test_torch_oocbuild.py)."""
    cap_malloc_mmap_threshold()
    with np.load(ckpt.manifest_path(prefix)) as z:
        if str(z["kind"]) != "csr":
            raise ValueError("reshard_checkpoint supports the csr kind "
                             "(packed records embed shard-local row "
                             "starts; rebuild with the target count)")
        n_old = int(z["n_table"])
        m_local = int(z["m_local"])
        modulo = int(z["modulo"])
        max_scan = int(z["max_scan"])
        max_node = int(z["max_node"]) if "max_node" in z.files else 0
        extras = [str(s) for s in z["extras"]] if "extras" in z.files \
            else []
        shard_rows = z["shard_rows"].astype(np.int64)
    if n_old % new_n_table:
        raise ValueError(f"{new_n_table} does not divide {n_old}")
    k = n_old // new_n_table
    m_new = m_local * k
    group_rows = shard_rows.reshape(new_n_table, k).sum(axis=1)
    rmax = max(1, int(group_rows.max()))

    row_cols = ["row_kmers", "row_nodes"] + extras
    for t in range(new_n_table):
        out: dict = {"starts": hp_zeros(m_new, np.int64, populate=True),
                     "sizes": hp_zeros(m_new, np.int32, populate=True),
                     "n_rows": np.int64(int(group_rows[t]))}
        off = 0
        bufs: dict = {}
        for j in range(k):
            src = t * k + j
            nt = int(shard_rows[src])
            with np.load(ckpt.shard_path(prefix, src, n_old)) as z:
                sizes_j = z["sizes"]
                nzj = sizes_j > 0
                out["sizes"][j * m_local:(j + 1) * m_local] = sizes_j
                st = out["starts"][j * m_local:(j + 1) * m_local]
                st[nzj] = z["starts"][nzj] + off
                for name in row_cols:
                    a = z[name]
                    if name not in bufs:
                        bufs[name] = np.zeros(rmax, dtype=a.dtype)
                    bufs[name][off:off + nt] = a[:nt]
            off += nt
        assert off == int(group_rows[t])
        out.update(bufs)
        ckpt._atomic_savez(ckpt.shard_path(out_prefix, t, new_n_table),
                           **out)
    ckpt._atomic_savez(
        ckpt.manifest_path(out_prefix),
        kind="csr", version=ckpt._VERSION, n_table=new_n_table,
        m_local=m_new, modulo=modulo, max_scan=max_scan,
        max_node=max_node, extras=np.asarray(extras),
        shard_rows=group_rows,
        shape_starts=np.asarray([m_new], dtype=np.int64),
        shape_sizes=np.asarray([m_new], dtype=np.int64),
        shape_row_kmers=np.asarray([rmax], dtype=np.int64),
        shape_row_nodes=np.asarray([rmax], dtype=np.int64))
    return {"prefix": out_prefix, "n_table": new_n_table,
            "total_rows": int(group_rows.sum())}
