"""ctypes loader for the native host library (csrc/host/gki.cpp and
walker.cpp, byte copies of the JAX package's native sources, and the
port's own rolled.cpp, the host half of the staging ring's rolled upload):
the port of graph_kmer_index_tpu/native/__init__.py.

Compiles lazily with g++ on first use into
``graph_kmer_index_tpu_torch/build/``; all call sites fall back to the
pure-numpy implementations when a compiler is unavailable, so the native
layer is an accelerator, not a dependency. A caller that must not take the
slow route (a chromosome-scale walk) checks :func:`available` first;
:func:`build_error` then says why the library is missing.

The library is compiled with ``-march=native``, so it belongs to the
machine that built it: its file name carries a digest of the sources, the
flags and the CPU's feature flags, and a library built elsewhere is never
loaded. It is built under a temporary name and moved into place, so
several processes may reach first use at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import subprocess
import tempfile
import threading

import numpy as np

from .utils.hugepages import hp_empty, hp_zeros

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_HERE, "csrc", "host", "gki.cpp"),
         os.path.join(_HERE, "csrc", "host", "walker.cpp"),
         os.path.join(_HERE, "csrc", "host", "rolled.cpp")]
_BUILD_DIR = os.path.join(_HERE, "build")
_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
          "-pthread"]
_lock = threading.Lock()
_lib = None
_tried = False
_build_error = None


def _cpu_identity() -> str:
    """What ``-march=native`` depends on: the CPU's model and feature
    flags."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = f.read().splitlines()
        picked = {}
        for line in lines:
            key = line.split(":")[0].strip()
            if key in ("model name", "flags", "Features") \
                    and key not in picked:
                picked[key] = line
        if picked:
            return "\n".join(picked[key] for key in sorted(picked))
    except OSError:
        pass
    return platform.machine() + platform.processor()


def library_path() -> str:
    """Where the library for these sources and this CPU lives."""
    digest = hashlib.sha256()
    for src in _SRCS:
        with open(src, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(_FLAGS).encode())
    digest.update(_cpu_identity().encode())
    return os.path.join(_BUILD_DIR,
                        f"libgki_host_{digest.hexdigest()[:16]}.so")


def _build(path: str) -> bool:
    global _build_error
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=_BUILD_DIR)
        os.close(fd)
    except OSError as e:
        _build_error = f"cannot write {_BUILD_DIR}: {e}"
        logging.info("native build unavailable (%s); using numpy fallbacks",
                     _build_error)
        return False
    cmd = ["g++", *_FLAGS, "-o", tmp] + _SRCS
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=240)
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        stderr = getattr(e, "stderr", b"") or b""
        _build_error = f"{e}\n{stderr.decode(errors='replace')[-2000:]}"
        logging.info("native build unavailable (%s); using numpy fallbacks", e)
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def build_error():
    """Why the library is unavailable (the compiler's message), or None."""
    return _build_error


def get_lib():
    """The loaded library, or None if unavailable."""
    global _lib, _tried, _build_error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = library_path()
        if not os.path.exists(so) and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:
            _build_error = f"load failed: {e}"
            logging.info("native load failed (%s)", e)
            return None

        i64, u64, i32 = ctypes.c_int64, ctypes.c_uint64, ctypes.c_int32
        p = ctypes.POINTER
        lib.gki_encode_ascii.restype = i64
        lib.gki_encode_ascii.argtypes = [ctypes.c_char_p, i64,
                                         p(ctypes.c_int8)]
        lib.gki_sliding_hashes.restype = i64
        lib.gki_sliding_hashes.argtypes = [p(ctypes.c_int8), i64, i32,
                                           p(ctypes.c_uint64)]
        # every bucket-table entry point has an int64- and an int32-starts
        # variant (suffix 32); the starts dtype is dispatched per call so
        # a device-built int32 table is never widened (see gki.cpp)
        for suffix, start_t in (("", ctypes.c_int64), ("32", ctypes.c_int32)):
            bl = getattr(lib, f"gki_bucket_lookup{suffix}")
            bl.restype = i64
            bl.argtypes = [
                p(ctypes.c_uint64), i64, p(ctypes.c_uint64),
                p(ctypes.c_uint32), p(ctypes.c_uint64), p(ctypes.c_uint16),
                p(ctypes.c_float), p(start_t), p(ctypes.c_uint32),
                u64, i64, i64, i32, p(ctypes.c_uint64), i64]
            mk = getattr(lib, f"gki_map_kmers{suffix}")
            mk.restype = None
            mk.argtypes = [
                p(ctypes.c_uint64), i64, p(ctypes.c_uint64),
                p(ctypes.c_uint32), p(start_t), p(ctypes.c_uint32), u64, i64,
                p(ctypes.c_int64)]
            hk = getattr(lib, f"gki_has_kmers{suffix}")
            hk.restype = None
            hk.argtypes = [
                p(ctypes.c_uint64), i64, p(ctypes.c_uint64), p(start_t),
                p(ctypes.c_uint32), u64, p(ctypes.c_uint8)]
        lib.gki_fasta_encode.restype = i64
        lib.gki_fasta_encode.argtypes = [
            ctypes.c_char_p, i64, p(ctypes.c_int8), i64, p(ctypes.c_int64),
            p(ctypes.c_int64), i64]
        lib.gki_walk_run.restype = ctypes.c_void_p
        lib.gki_walk_run.argtypes = [
            i64, p(ctypes.c_uint32), p(ctypes.c_int64), p(ctypes.c_int8),
            p(ctypes.c_int64), p(ctypes.c_int32), p(ctypes.c_uint8),
            p(ctypes.c_int32), i32, i32,
            p(ctypes.c_int64), p(ctypes.c_int64), i64,
            p(ctypes.c_int64), p(ctypes.c_int64), i64,
            i64, i32, p(ctypes.c_int64), i64, p(ctypes.c_int64)]
        lib.gki_walk_fetch.restype = None
        lib.gki_walk_fetch.argtypes = [
            ctypes.c_void_p, p(ctypes.c_int8), p(ctypes.c_int64),
            p(ctypes.c_int32), p(ctypes.c_int32), p(ctypes.c_int32),
            p(ctypes.c_int32), p(ctypes.c_int32)]
        lib.gki_walk_free.restype = None
        lib.gki_walk_free.argtypes = [ctypes.c_void_p]
        lib.gki_finalize_free.restype = None
        lib.gki_finalize_free.argtypes = [ctypes.c_void_p]
        lib.gki_finalize_count.restype = ctypes.c_void_p
        lib.gki_finalize_count.argtypes = [
            p(ctypes.c_int32), p(ctypes.c_int32), p(ctypes.c_int32),
            i64, p(ctypes.c_double), i32, p(ctypes.c_int32), i64,
            p(ctypes.c_int64)]
        lib.gki_finalize_fill.restype = None
        lib.gki_finalize_fill.argtypes = [
            ctypes.c_void_p, p(ctypes.c_int8), i64, i32,
            p(ctypes.c_int64), p(ctypes.c_int32), p(ctypes.c_int32),
            p(ctypes.c_int32), i64,
            p(ctypes.c_uint64), p(ctypes.c_int32),
            p(ctypes.c_int32), p(ctypes.c_int16), p(ctypes.c_double)]
        lib.gki_frequencies_bucket_ordered.restype = i32
        lib.gki_frequencies_bucket_ordered.argtypes = [
            p(ctypes.c_uint64), p(ctypes.c_uint64), i64, u64,
            p(ctypes.c_uint16), i32]
        lib.gki_build_packed.restype = None
        lib.gki_build_packed.argtypes = [
            p(ctypes.c_uint64), p(ctypes.c_uint32), i64, u64,
            p(ctypes.c_uint64), p(ctypes.c_uint64), p(ctypes.c_uint32),
            p(ctypes.c_int64)]
        lib.gki_packed_map_kmers.restype = None
        lib.gki_packed_map_kmers.argtypes = [
            p(ctypes.c_uint64), i64, p(ctypes.c_uint64),
            p(ctypes.c_uint64), p(ctypes.c_uint32), u64,
            p(ctypes.c_int64), i64]
        lib.gki_rolled_encode.restype = i64
        lib.gki_rolled_encode.argtypes = [
            ctypes.c_void_p, i64, ctypes.c_void_p, i64, i32,
            p(ctypes.c_int64)]
        lib.gki_packed_has_kmers.restype = None
        lib.gki_packed_has_kmers.argtypes = [
            p(ctypes.c_uint64), i64, p(ctypes.c_uint64),
            p(ctypes.c_uint64), u64, p(ctypes.c_uint8)]
        _lib = lib
        return _lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _starts_args(starts_tbl):
    """(array, ctypes pointer, fn-suffix) for a bucket starts table.
    int32 inputs stay int32 (the device build's layout — widening the
    production-modulo table is a multi-GB copy); anything else takes the
    legacy int64 path."""
    a = np.asarray(starts_tbl)
    if a.dtype == np.int32 and a.flags.c_contiguous:
        return a, _ptr(a, ctypes.c_int32), "32"
    a = np.ascontiguousarray(a, np.int64)
    return a, _ptr(a, ctypes.c_int64), ""


def _check_modulo(modulo):
    # guard BEFORE entering C: `kmer % 0` there is a SIGFPE that kills
    # the whole process instead of raising (a corrupt/empty index file
    # is the realistic source of modulo == 0)
    if int(modulo) <= 0:
        raise ValueError(f"modulo must be positive, got {modulo}")


def available() -> bool:
    return get_lib() is not None


def encode_ascii(seq: bytes) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty(len(seq), dtype=np.int8)
    lib.gki_encode_ascii(seq, len(seq), _ptr(out, ctypes.c_int8))
    return out


def sliding_hashes(seq: np.ndarray, k: int) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    if not 1 <= k <= 31:
        # k=0 shifts by a negative amount in C (UB); k=32 collides the
        # all-T hash with the packed-table empty sentinel (2^64-1)
        raise ValueError(f"k must be in [1, 31], got {k}")
    seq = np.ascontiguousarray(seq, dtype=np.int8)
    n = len(seq)
    if n < k:
        return np.zeros(0, dtype=np.uint64)
    out = hp_empty(n - k + 1, np.uint64)
    lib.gki_sliding_hashes(_ptr(seq, ctypes.c_int8), n, k,
                           _ptr(out, ctypes.c_uint64))
    return out


def bucket_lookup(kmers, table_kmers, table_nodes, table_ref_offsets,
                  table_frequencies, table_allele_frequencies, starts_tbl,
                  sizes_tbl, modulo, hit_cap=10000, freq_cap=20):
    """(5, n_hits) uint64 matrix — the CythonKmerIndex.get contract,
    minus the Cython bucket-0 skip (python-get semantics; PARITY.md)."""
    lib = get_lib()
    if lib is None:
        return None
    _check_modulo(modulo)
    kmers = np.ascontiguousarray(kmers, dtype=np.uint64)
    starts, starts_ptr, suffix = _starts_args(starts_tbl)
    args = (
        _ptr(kmers, ctypes.c_uint64), len(kmers),
        _ptr(np.ascontiguousarray(table_kmers, np.uint64), ctypes.c_uint64),
        _ptr(np.ascontiguousarray(table_nodes, np.uint32), ctypes.c_uint32),
        _ptr(np.ascontiguousarray(table_ref_offsets, np.uint64),
             ctypes.c_uint64),
        _ptr(np.ascontiguousarray(table_frequencies, np.uint16),
             ctypes.c_uint16),
        _ptr(np.ascontiguousarray(table_allele_frequencies, np.float32),
             ctypes.c_float),
        starts_ptr,
        _ptr(np.ascontiguousarray(sizes_tbl, np.uint32), ctypes.c_uint32),
        int(modulo), int(hit_cap), int(freq_cap))
    fn = getattr(lib, f"gki_bucket_lookup{suffix}")
    n_hits = fn(*args, 1, None, 0)
    out = hp_zeros((5, max(1, n_hits)), np.uint64)
    if n_hits > 0:
        fn(*args, 0, _ptr(out, ctypes.c_uint64), n_hits)
    return out[:, :n_hits]


def map_kmers(kmers, table_kmers, table_nodes, starts_tbl, sizes_tbl,
              modulo, n_nodes) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    _check_modulo(modulo)
    kmers = np.ascontiguousarray(kmers, dtype=np.uint64)
    starts, starts_ptr, suffix = _starts_args(starts_tbl)
    # int64 like the packed path: uint32 silently wrapped at 2^32
    # accumulated hits per node, and the two backends must agree
    counts = hp_zeros(n_nodes, np.int64)
    getattr(lib, f"gki_map_kmers{suffix}")(
        _ptr(kmers, ctypes.c_uint64), len(kmers),
        _ptr(np.ascontiguousarray(table_kmers, np.uint64), ctypes.c_uint64),
        _ptr(np.ascontiguousarray(table_nodes, np.uint32), ctypes.c_uint32),
        starts_ptr,
        _ptr(np.ascontiguousarray(sizes_tbl, np.uint32), ctypes.c_uint32),
        int(modulo), n_nodes - 1, _ptr(counts, ctypes.c_int64))
    return counts


def has_kmers(kmers, table_kmers, starts_tbl, sizes_tbl,
              modulo) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    _check_modulo(modulo)
    kmers = np.ascontiguousarray(kmers, dtype=np.uint64)
    starts, starts_ptr, suffix = _starts_args(starts_tbl)
    out = hp_zeros(len(kmers), np.uint8)
    getattr(lib, f"gki_has_kmers{suffix}")(
        _ptr(kmers, ctypes.c_uint64), len(kmers),
        _ptr(np.ascontiguousarray(table_kmers, np.uint64), ctypes.c_uint64),
        starts_ptr,
        _ptr(np.ascontiguousarray(sizes_tbl, np.uint32), ctypes.c_uint32),
        int(modulo), _ptr(out, ctypes.c_uint8))
    return out.astype(bool)


def frequencies_bucket_ordered(kmers, ref_offsets, modulo,
                               n_threads=None) -> np.ndarray | None:
    """frequency[row] = #distinct ref offsets among rows with the same
    kmer, for rows already sorted by hash bucket (the index build's row
    layout — equal kmers always share a bucket, so this is a parallel
    linear pass with tiny per-bucket sorts instead of a global n-log-n
    sort; reference semantics collision_free_kmer_index.py:267-293,
    uint16 wrap identical to the numpy/device paths). Returns None when
    the library is unavailable or the rows are NOT bucket-ordered
    (verified in-pass) — callers fall back to the sorting path."""
    lib = get_lib()
    if lib is None:
        return None
    _check_modulo(modulo)
    kmers = np.ascontiguousarray(kmers, dtype=np.uint64)
    ref_offsets = np.ascontiguousarray(ref_offsets, dtype=np.uint64)
    if len(ref_offsets) != len(kmers):
        return None
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 1)
    out = hp_empty(len(kmers), np.uint16)
    rc = lib.gki_frequencies_bucket_ordered(
        _ptr(kmers, ctypes.c_uint64), _ptr(ref_offsets, ctypes.c_uint64),
        len(kmers), int(modulo), _ptr(out, ctypes.c_uint16),
        int(n_threads))
    return out if rc == 0 else None


def walk(graph, crit_index, k, max_variant_nodes, worklist, seen_points,
         stop_at_node=-1, early_stop=False, only_follow_nodes=None):
    """Run the native DenseKmerFinder span walk. Returns the span
    descriptor arrays (tape, span_tape_start, span_n_windows, span_node,
    span_first_offset, span_nodes_len, span_nodes) or None when the
    native library is unavailable or a python-level assertion would fire
    (caller falls back to the python walker)."""
    lib = get_lib()
    if lib is None:
        return None
    n = graph.n_nodes()
    # cache the (immutable) marshaled graph arrays on the graph object —
    # per-call ascontiguousarray/pointer building dominates small walks
    cached = getattr(graph, "_native_walk_arrays", None)
    if cached is None:
        cached = (
            np.ascontiguousarray(graph.node_sizes, np.uint32),
            np.ascontiguousarray(graph.seq_start, np.int64),
            np.ascontiguousarray(graph.sequence, np.int8),
            np.ascontiguousarray(graph.edge_index, np.int64),
            np.ascontiguousarray(graph.edge_targets, np.int32),
            np.ascontiguousarray(
                (graph.linear_ref_mask | graph.ref_dummy_mask).astype(
                    np.uint8)),
        )
        graph._native_walk_arrays = cached
    node_sizes, seq_start, sequence, edge_index, edge_targets, is_ref = cached
    crit = np.ascontiguousarray(crit_index, np.int32)
    assert len(crit) >= n, "crit_index must cover all nodes"

    def _cols(points):
        # accept either an (n, 2) row layout or a pre-split
        # (nodes, offsets) column tuple (the finder's chunked path —
        # avoids an O(n_paths) copy per chunk)
        if isinstance(points, tuple):
            nodes, offsets = points
            return (np.ascontiguousarray(nodes, dtype=np.int64),
                    np.ascontiguousarray(offsets, dtype=np.int64))
        rows = np.asarray(points, dtype=np.int64).reshape(-1, 2)
        return (np.ascontiguousarray(rows[:, 0]),
                np.ascontiguousarray(rows[:, 1]))

    wl_nodes, wl_offsets = _cols(worklist)
    seen_nodes, seen_offsets = _cols(seen_points)

    follow = np.ascontiguousarray(
        np.array(sorted(only_follow_nodes), dtype=np.int64)
        if only_follow_nodes else np.zeros(0, dtype=np.int64))
    out_sizes = np.zeros(3, dtype=np.int64)
    handle = lib.gki_walk_run(
        n, _ptr(node_sizes, ctypes.c_uint32), _ptr(seq_start, ctypes.c_int64),
        _ptr(sequence, ctypes.c_int8), _ptr(edge_index, ctypes.c_int64),
        _ptr(edge_targets, ctypes.c_int32), _ptr(is_ref, ctypes.c_uint8),
        _ptr(crit, ctypes.c_int32), int(k), int(max_variant_nodes),
        _ptr(wl_nodes, ctypes.c_int64), _ptr(wl_offsets, ctypes.c_int64),
        len(wl_nodes),
        _ptr(seen_nodes, ctypes.c_int64), _ptr(seen_offsets, ctypes.c_int64),
        len(seen_nodes), int(stop_at_node), int(bool(early_stop)),
        _ptr(follow, ctypes.c_int64), len(follow),
        _ptr(out_sizes, ctypes.c_int64))
    if not handle or out_sizes[0] < 0:
        return None
    n_spans, tape_len, sn_len = (int(out_sizes[0]), int(out_sizes[1]),
                                 int(out_sizes[2]))
    try:
        tape = hp_empty(tape_len, np.int8)
        ts = hp_empty(n_spans, np.int64)
        nw = hp_empty(n_spans, np.int32)
        s_node = hp_empty(n_spans, np.int32)
        s_off = hp_empty(n_spans, np.int32)
        nl = hp_empty(n_spans, np.int32)
        span_nodes = hp_empty(sn_len, np.int32)
    except BaseException:
        # allocation failure (exactly the high-memory case): the walker
        # handle would otherwise leak its tape + span vectors
        lib.gki_walk_free(handle)
        raise
    lib.gki_walk_fetch(handle, _ptr(tape, ctypes.c_int8),
                       _ptr(ts, ctypes.c_int64), _ptr(nw, ctypes.c_int32),
                       _ptr(s_node, ctypes.c_int32),
                       _ptr(s_off, ctypes.c_int32),
                       _ptr(nl, ctypes.c_int32),
                       _ptr(span_nodes, ctypes.c_int32))
    return tape, ts, nw, s_node, s_off, nl, span_nodes


def finalize_rows(tape, k, ts, nw, s_node, s_off, raw_nl, raw_nodes,
                  af_table, only_save_one=False, only_store_nodes=None):
    """Native span-stream -> FlatKmers row expansion (no whitelist mask;
    callers with a whitelist use the python path). Returns
    (kmers u64, nodes i32, start_nodes i32, start_offsets i16, af f64)
    (kmers as int64) or None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    tape = np.ascontiguousarray(tape, np.int8)
    ts = np.ascontiguousarray(ts, np.int64)
    nw = np.ascontiguousarray(nw, np.int32)
    s_node = np.ascontiguousarray(s_node, np.int32)
    s_off = np.ascontiguousarray(s_off, np.int32)
    raw_nl = np.ascontiguousarray(raw_nl, np.int32)
    raw_nodes = np.ascontiguousarray(raw_nodes, np.int32)
    af_table = np.ascontiguousarray(af_table, np.float64)
    if only_store_nodes is not None:
        store = np.ascontiguousarray(sorted(only_store_nodes), np.int32)
        n_store = len(store)
    else:
        store = np.zeros(0, np.int32)
        n_store = -1
    n_rows = np.zeros(1, np.int64)
    # count/fill protocol: count caches per-span filtered node sets and
    # the exact row total; fill writes rows straight into the numpy
    # buffers (no native-side result vectors, no fetch copy: first-touch
    # page faults make every avoided output copy worth having)
    plan = lib.gki_finalize_count(
        _ptr(nw, ctypes.c_int32), _ptr(raw_nl, ctypes.c_int32),
        _ptr(raw_nodes, ctypes.c_int32), len(ts),
        _ptr(af_table, ctypes.c_double),
        int(bool(only_save_one)), _ptr(store, ctypes.c_int32), n_store,
        _ptr(n_rows, ctypes.c_int64))
    if not plan:
        return None
    n = int(n_rows[0])
    try:
        # int64 buffer, filled through a uint64 pointer: hash values are
        # < 4^31 so the bit patterns agree, and the finder's consumer
        # wants int64 — writing it directly saves a 20MB/2.5M-row astype
        kmers = hp_empty(n, np.int64)
        nodes = hp_empty(n, np.int32)
        start_nodes = hp_empty(n, np.int32)
        start_offsets = hp_empty(n, np.int16)
        af = hp_empty(n, np.float64)
    except BaseException:
        # fill (which consumes the plan) will never run: free the plan's
        # per-span vectors — this is the out-of-memory path where GBs of
        # cached node sets matter most
        lib.gki_finalize_free(plan)
        raise
    lib.gki_finalize_fill(
        plan, _ptr(tape, ctypes.c_int8), len(tape), int(k),
        _ptr(ts, ctypes.c_int64), _ptr(nw, ctypes.c_int32),
        _ptr(s_node, ctypes.c_int32), _ptr(s_off, ctypes.c_int32),
        len(ts),
        _ptr(kmers, ctypes.c_uint64), _ptr(nodes, ctypes.c_int32),
        _ptr(start_nodes, ctypes.c_int32),
        _ptr(start_offsets, ctypes.c_int16), _ptr(af, ctypes.c_double))
    return kmers, nodes, start_nodes, start_offsets, af


def fasta_encode(text: bytes, max_reads: int | None = None):
    """All sequence lines of a FASTA/FASTQ buffer, 2-bit encoded:
    (flat int8 array, starts, lens)."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(text)
    # every read (= sequence LINE, matching the python fallback) needs
    # at least one newline-terminated line, so the line count bounds the
    # read count tightly (an n//2+1 bound would allocate and populate
    # 8 bytes per BYTE of input for starts+lens)
    max_reads = max_reads or (text.count(b"\n") + 2)
    out = hp_empty(n, np.int8)
    starts = hp_empty(max_reads, np.int64)
    lens = hp_empty(max_reads, np.int64)
    n_reads = lib.gki_fasta_encode(
        text, n, _ptr(out, ctypes.c_int8), n,
        _ptr(starts, ctypes.c_int64), _ptr(lens, ctypes.c_int64), max_reads)
    if n_reads < 0:
        return None
    total = int(starts[n_reads - 1] + lens[n_reads - 1]) if n_reads else 0
    return out[:total], starts[:n_reads], lens[:n_reads]


def build_packed(kmers: np.ndarray, nodes: np.ndarray, modulo2: int):
    """(records, rows_kmers, rows_nodes) packed layout (see ops/lookup.py
    for the record format), or None without the native toolchain."""
    lib = get_lib()
    if lib is None:
        return None
    _check_modulo(modulo2)
    kmers = np.ascontiguousarray(kmers, np.uint64)
    nodes = np.ascontiguousarray(nodes, np.uint32)
    n = len(kmers)
    rec = hp_empty(4 * modulo2, np.uint64)
    rows_k = hp_empty(n, np.uint64)
    rows_n = hp_empty(n, np.uint32)
    scratch = hp_empty(modulo2 + 1, np.int64)
    lib.gki_build_packed(_ptr(kmers, ctypes.c_uint64),
                         _ptr(nodes, ctypes.c_uint32), n, modulo2,
                         _ptr(rec, ctypes.c_uint64),
                         _ptr(rows_k, ctypes.c_uint64),
                         _ptr(rows_n, ctypes.c_uint32),
                         _ptr(scratch, ctypes.c_int64))
    return rec, rows_k, rows_n


def packed_map_kmers(kmers, rec, rows_k, rows_n, modulo2, n_nodes):
    lib = get_lib()
    if lib is None:
        return None
    _check_modulo(modulo2)
    kmers = np.ascontiguousarray(kmers, np.uint64)
    counts = hp_zeros(n_nodes, np.int64)
    lib.gki_packed_map_kmers(_ptr(kmers, ctypes.c_uint64), len(kmers),
                             _ptr(rec, ctypes.c_uint64),
                             _ptr(rows_k, ctypes.c_uint64),
                             _ptr(rows_n, ctypes.c_uint32), modulo2,
                             _ptr(counts, ctypes.c_int64), n_nodes)
    return counts


def packed_has_kmers(kmers, rec, rows_k, modulo2):
    lib = get_lib()
    if lib is None:
        return None
    _check_modulo(modulo2)
    kmers = np.ascontiguousarray(kmers, np.uint64)
    out = hp_zeros(len(kmers), np.uint8)
    lib.gki_packed_has_kmers(_ptr(kmers, ctypes.c_uint64), len(kmers),
                             _ptr(rec, ctypes.c_uint64),
                             _ptr(rows_k, ctypes.c_uint64), modulo2,
                             _ptr(out, ctypes.c_uint8))
    return out.astype(bool)
