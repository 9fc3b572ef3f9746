"""Host-side multiprocess worklist sharding for the finder control plane
(the port of graph_kmer_index_tpu/parallel/host_pool.py).

The graph traversal control plane is irreducibly host-side (irregular
DFS); the reference scales it with fork() + POSIX-shm worklist splits
(command_line_interface.py:574-623). Here: fork-shared graph (copy-on-
write, no serialization), critical-path chunks as the work units — the
chunks are independent by construction (a k-window cannot span a
critical point, SURVEY.md §5.7) — and a host concatenate of FlatKmers.
Workers hash with the native C++ rolling kernel; the card stays free for
the device finalize and the index build (find_kmers_parallel_device).
"""
from __future__ import annotations

import hashlib
import json
import logging
import multiprocessing as mp
import os
import sys
import time

import numpy as np

from ..critical_paths import CriticalGraphPaths
from ..finder import DenseKmerFinder
from ..flat_kmers import FlatKmers

_WORKER_STATE: dict = {}


def _accelerator_backend_live() -> bool:
    """True if CUDA has been initialised in this process (a probe that
    initialises nothing).

    CPU tensors do not count: the pool workers are host-only by
    construction (pure numpy / native-walker chunk functions), and
    glibc's malloc at-fork handlers plus CPython's at-fork lock re-init
    cover the generic threads+fork hazard, the same bargain the
    reference's fork pools make under threaded numpy. A live CUDA context
    stays guarded: its device handles do not survive a fork. This module
    does not import torch (its workers never need it): CUDA can only be
    live in a process that has."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.cuda.is_initialized()


def _init_worker(graph, k, critical_paths, position_id, finder_kwargs,
                 require_native=False):
    _WORKER_STATE.update(graph=graph, k=k, critical_paths=critical_paths,
                         position_id=position_id,
                         finder_kwargs=finder_kwargs,
                         require_native=require_native)


def _check_walker(finder) -> None:
    """With ``require_native``, refuse a chunk that the Python walker
    took: at chromosome scale that route runs for hours and looks like a
    hang."""
    if _WORKER_STATE.get("require_native") and not finder.used_native_walker:
        from .. import native
        raise RuntimeError("the native span walker was required and was "
                           f"not used: {native.build_error()}")


def _run_chunk(chunk):
    start, stop = chunk
    s = _WORKER_STATE
    finder = DenseKmerFinder(
        s["graph"], s["k"], critical_graph_paths=s["critical_paths"],
        position_id=s["position_id"],
        start_at_critical_path_number=start,
        stop_at_critical_path_number=stop,
        use_device=False,  # workers stay off-device; parent owns the chip
        **s["finder_kwargs"])
    finder.find()
    _check_walker(finder)
    flat = finder.get_flat_kmers(v="1")
    return (np.asarray(flat._hashes), np.asarray(flat._nodes),
            np.asarray(flat._ref_offsets),
            np.asarray(flat._allele_frequencies))


def _run_chunk_spans(chunk):
    """Like _run_chunk but returns the finder's COMPACT span
    representation (tape + per-span descriptors) instead of expanded
    rows — ~30x smaller, for the parent's device-resident finalize —
    and, last, the microseconds the walk took."""
    start, stop = chunk
    s = _WORKER_STATE
    t0 = time.perf_counter()
    finder = DenseKmerFinder(
        s["graph"], s["k"], critical_graph_paths=s["critical_paths"],
        position_id=s["position_id"],
        start_at_critical_path_number=start,
        stop_at_critical_path_number=stop,
        use_device=False,
        **s["finder_kwargs"])
    finder.find()
    _check_walker(finder)
    walk_us = int((time.perf_counter() - t0) * 1e6)
    return (finder._tape.get_nparray(),
            finder._span_tape_start.get_nparray(),
            finder._span_n_windows.get_nparray(),
            finder._span_node.get_nparray(),
            finder._span_first_offset.get_nparray(),
            finder._span_nodes_len.get_nparray(),
            finder._span_nodes.get_nparray(),
            walk_us)


def _run_indexed(args):
    """Pool shim for imap_unordered: thread the chunk index through the
    worker so out-of-order completions slot back correctly."""
    i, run_fn, chunk = args
    return i, run_fn(chunk)


_MAP_FN = None


def _init_map_worker(fn):
    global _MAP_FN
    _MAP_FN = fn


def _run_map_chunk(chunk):
    return _MAP_FN(chunk)


_SHARED_POOL = None


def get_shared_pool(n_workers: int = 16):
    """Process-wide worker pool (reference shared_mem.py:21-27).

    Returns a ``multiprocessing`` fork pool, reused across calls until
    :func:`close_shared_pool`. If CUDA is already initialised in this
    process, forking is unsafe — a thread pool with the same
    interface is returned instead (callers' workloads here release the
    GIL in numpy/native kernels)."""
    global _SHARED_POOL
    if _SHARED_POOL is None:
        if _accelerator_backend_live():
            logging.warning("CUDA already initialised; "
                            "shared pool uses threads (fork is unsafe)")
            from multiprocessing.dummy import Pool as ThreadPool
            _SHARED_POOL = ThreadPool(n_workers)
        else:
            _SHARED_POOL = mp.get_context("fork").Pool(n_workers)
    return _SHARED_POOL


def close_shared_pool() -> None:
    """Close the process-wide pool (reference shared_mem.py:30-34)."""
    global _SHARED_POOL
    if _SHARED_POOL is not None:
        _SHARED_POOL.close()
        _SHARED_POOL.join()
        _SHARED_POOL = None


def map_over_chunks(fn, chunks, n_workers):
    """Generic fork-pool map over independent work chunks (the reference's
    chunked_imap over VCF-variant chunks, command_line_interface.py:352-364).
    Serial when n_workers <= 1 or CUDA is initialised."""
    if n_workers > 1 and _accelerator_backend_live():
        logging.warning("CUDA already initialised; mapping "
                        "chunks serially (fork would be unsafe)")
        n_workers = 1
    if n_workers <= 1:
        return [fn(c) for c in chunks]
    ctx = mp.get_context("fork")
    with ctx.Pool(n_workers, initializer=_init_map_worker,
                  initargs=(fn,)) as pool:
        return pool.map(_run_map_chunk, chunks)


# -- per-chunk find checkpoints ----------------------------------------------
#
# The reference's only resume mechanism is manual: re-run with
# start/stop_at_critical_path_number and merge the npz files yourself
# (kmer_finder.py:92-93, command_line_interface.py:574-623). Here a
# ``checkpoint_dir`` makes the pooled find restartable automatically:
# each finished chunk persists as chunk-SSSSSSSS-EEEEEEEE.npz
# (deterministic chunk IDs, SURVEY.md §5.4), a meta.json pins the
# inputs the chunks are only valid for, and a re-run recomputes only
# the missing chunks. Stale files from a different chunking are simply
# never matched; a different graph/k/flag set is refused loudly.

_CKPT_VERSION = 2  # 2: content-pinned meta (graph AF, critical paths,
#                       position ids, kwarg digests)


def _array_digest(h, arr) -> None:
    arr = np.ascontiguousarray(arr)
    h.update(str(arr.dtype).encode())
    h.update(str(arr.shape).encode())
    h.update(arr.tobytes())


def _graph_fingerprint(graph) -> str:
    """Stable digest of every graph array a chunk's output can depend
    on — topology, sequence, ref layout AND allele frequencies (rows
    mode embeds AF values, finder emission reads them) — so a resumed
    find against a changed graph is refused, not merged."""
    h = hashlib.blake2b(digest_size=16)
    for a in (graph.node_sizes, graph.sequence, graph.seq_start,
              graph.edge_targets, graph.edge_index, graph.linear_ref_mask,
              graph.ref_dummy_mask, graph.node_to_ref_offset,
              graph.allele_frequencies, graph.chromosome_start_nodes_array):
        _array_digest(h, a)
    return h.hexdigest()


def _value_fingerprint(val) -> object:
    """JSON-stable pin for a finder kwarg. Scalars pass through; arrays
    and index-like objects (anything carrying ``_kmers``, e.g. a
    whitelist CollisionFreeKmerIndex) pin their CONTENT — a resumed run
    whose whitelist changed must be refused, not merged with chunks
    filtered by the old one."""
    if isinstance(val, (int, float, str, bool, type(None))):
        return val
    if isinstance(val, np.generic):  # np.int64(4) is NOT an int subclass
        return f"{val.dtype}:{val.item()}"
    h = hashlib.blake2b(digest_size=16)
    if isinstance(val, (set, frozenset)):
        _array_digest(h, np.sort(np.asarray(list(val))))
        return f"set:{h.hexdigest()}"
    if isinstance(val, (list, tuple, np.ndarray)):
        _array_digest(h, np.asarray(val))
        return f"array:{h.hexdigest()}"
    if hasattr(val, "_kmers"):
        _array_digest(h, np.asarray(val._kmers))
        return f"{type(val).__name__}:{h.hexdigest()}"
    return type(val).__name__  # last resort: type identity only


def _ckpt_verify_meta(checkpoint_dir, graph, k, critical_paths,
                      position_id, mode, finder_kwargs) -> None:
    """Create/validate ``meta.json``; raise on any input mismatch.

    Creation is race-safe: the first writer links its meta into place
    exclusively (``os.link`` fails on an existing path), so two
    concurrent first runs with different inputs cannot both believe
    they own the directory — the loser validates against the winner's
    meta and raises."""
    cp = hashlib.blake2b(digest_size=16)
    _array_digest(cp, np.asarray(critical_paths.nodes))
    _array_digest(cp, np.asarray(critical_paths.offsets))
    pid_h = hashlib.blake2b(digest_size=16)
    _array_digest(pid_h, np.asarray(position_id._start_ids))
    meta = {
        "version": _CKPT_VERSION, "k": int(k),
        "n_paths": int(len(critical_paths)),
        "critical_paths": cp.hexdigest(),
        "position_id": pid_h.hexdigest(),
        "mode": mode, "graph": _graph_fingerprint(graph),
        "finder_kwargs": sorted(
            (key, _value_fingerprint(val))
            for key, val in finder_kwargs.items()),
    }
    meta = json.loads(json.dumps(meta))  # normalize tuples -> lists
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = os.path.join(checkpoint_dir, "meta.json")
    if not os.path.exists(path):
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        try:
            os.link(tmp, path)  # atomic create-exclusive
        except FileExistsError:
            pass  # lost the race; validate against the winner below
        except OSError:
            # filesystem without hard links (vfat/exFAT/some FUSE):
            # fall back to exclusive create — non-atomic against a
            # concurrent torn write, but those FSes offer nothing better
            try:
                with open(path, "x") as f:
                    json.dump(meta, f)
            except FileExistsError:
                pass
        finally:
            os.unlink(tmp)
    try:
        with open(path) as f:
            old = json.load(f)
    except ValueError as e:
        raise ValueError(
            f"find checkpoint dir {checkpoint_dir!r} has an unreadable "
            f"meta.json ({e}); clear the directory") from e
    if old.get("version") != _CKPT_VERSION:
        raise ValueError(
            f"find checkpoint dir {checkpoint_dir!r} uses checkpoint "
            f"format {old.get('version')} but this library writes "
            f"{_CKPT_VERSION}; clear the directory to rebuild")
    if old != meta:
        raise ValueError(
            f"find checkpoint dir {checkpoint_dir!r} was written for "
            f"different inputs ({old} != {meta}); clear it or use "
            "another directory")


def _ckpt_chunk_path(checkpoint_dir, chunk) -> str:
    return os.path.join(checkpoint_dir,
                        f"chunk-{chunk[0]:08d}-{chunk[1]:08d}.npz")


def _ckpt_save_chunk(checkpoint_dir, chunk, arrays) -> None:
    path = _ckpt_chunk_path(checkpoint_dir, chunk)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **{f"a{i}": a for i, a in enumerate(arrays)})
    os.replace(tmp, path)


def _ckpt_load_chunk(checkpoint_dir, chunk):
    """The chunk's result tuple, or None if absent/unreadable (a torn
    file — e.g. a survivor of a pre-atomic-write crash — recomputes)."""
    path = _ckpt_chunk_path(checkpoint_dir, chunk)
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            return tuple(z[f"a{i}"] for i in range(len(z.files)))
    except Exception as e:
        logging.warning("find checkpoint: unreadable chunk %s (%s); "
                        "recomputing", path, e)
        return None


def plan_chunks(n_paths: int, n_workers: int, chunks_per_worker: int):
    """The pooled find's critical-path chunking, exposed so spill
    journals can pin it: resuming with a different worker count would
    otherwise produce overlapping-but-differently-bounded chunks whose
    stale journal entries double-count rows."""
    n_chunks = min(max(1, n_workers * chunks_per_worker), max(1, n_paths))
    per = max(1, n_paths // n_chunks)
    starts = list(range(0, n_paths, per))
    ends = starts[1:] + [n_paths]
    return list(zip(starts, ends))


def _find_pooled(run_fn, graph, k, n_workers, critical_paths, position_id,
                 chunks_per_worker, finder_kwargs, checkpoint_dir=None,
                 mp_context=None, on_result=None, require_native=False):
    """Shared chunking + fork-pool loop: runs ``run_fn`` (a module-level
    chunk worker) over critical-path chunks, serial or forked.

    ``mp_context``: multiprocessing start method. Default (None) picks
    ``fork`` when CUDA is not initialised in this process, else serial.
    Pass ``"spawn"`` to parallelize safely AFTER CUDA is live: workers
    re-import from scratch (a few seconds each) instead of inheriting
    device state, and never see the card.

    ``require_native``: a chunk that the Python walker took (no native
    library) raises instead of running on.

    ``on_result(i, result)``: streaming consumer. When given, each chunk
    result (including checkpoint-resumed ones) is handed over the moment
    it exists instead of being retained — the returned ``results`` list
    is all None and the consumer owns buffering/ordering. This is what
    lets the device finalize overlap the host find.
    """
    if critical_paths is None:
        critical_paths = CriticalGraphPaths.from_graph(graph, k)
    if position_id is None:
        from ..graph import PositionId
        position_id = PositionId.from_graph(graph)

    n_paths = len(critical_paths)
    chunks = plan_chunks(n_paths, n_workers, chunks_per_worker)
    logging.info("find pool: %d paths in %d chunks over %d workers",
                 n_paths, len(chunks), n_workers)

    results = [None] * len(chunks)

    def _deliver(i, r):
        if on_result is None:
            results[i] = r
        else:
            on_result(i, r)

    work = list(range(len(chunks)))
    if checkpoint_dir is not None:
        mode = "spans" if run_fn is _run_chunk_spans else "rows"
        _ckpt_verify_meta(checkpoint_dir, graph, k, critical_paths,
                          position_id, mode, finder_kwargs)
        work = []
        for i, c in enumerate(chunks):
            r = _ckpt_load_chunk(checkpoint_dir, c)
            if r is None:
                work.append(i)
            else:
                _deliver(i, r)
        if len(work) < len(chunks):
            logging.info("find checkpoint: resumed %d/%d chunks from %s",
                         len(chunks) - len(work), len(chunks),
                         checkpoint_dir)
        if not work:
            return results, position_id

    if mp_context is None:
        mp_context = "fork"
        if n_workers > 1 and _accelerator_backend_live():
            # fork() after CUDA is initialised breaks the child (inherited
            # device state). The safe patterns are pool-before-first-CUDA-
            # call or mp_context="spawn"; fall back to serial otherwise.
            logging.warning("CUDA already initialised; "
                            "running worklist serially (fork would be "
                            "unsafe; pass mp_context='spawn' to "
                            "parallelize)")
            n_workers = 1

    if n_workers <= 1:
        _init_worker(graph, k, critical_paths, position_id, finder_kwargs,
                     require_native)
        for i in work:
            r = run_fn(chunks[i])
            if checkpoint_dir is not None:
                _ckpt_save_chunk(checkpoint_dir, chunks[i], r)
            _deliver(i, r)
    elif mp_context == "spawn":
        # fresh processes after CUDA is live. NOT multiprocessing's
        # spawn context: that replays the parent's __main__ in every
        # worker (re-executes an unguarded harness script; dies in a
        # respawn loop when __main__ is stdin). SubprocessPool workers
        # run `python -m ...proc_pool` — importable, inert __main__ —
        # with the same fresh-import isolation (see proc_pool.py).
        from .proc_pool import SubprocessPool
        with SubprocessPool(n_workers, initializer=_init_worker,
                            initargs=(graph, k, critical_paths,
                                      position_id, finder_kwargs,
                                      require_native)) as pool:
            for i, r in pool.imap_unordered(
                    run_fn, [(i, chunks[i]) for i in work]):
                if checkpoint_dir is not None:
                    _ckpt_save_chunk(checkpoint_dir, chunks[i], r)
                _deliver(i, r)
    else:
        ctx = mp.get_context(mp_context)
        with ctx.Pool(n_workers, initializer=_init_worker,
                      initargs=(graph, k, critical_paths, position_id,
                                finder_kwargs, require_native)) as pool:
            # unordered imap: each chunk persists the moment it actually
            # finishes (ordered imap would buffer completions behind a
            # straggler and lose them on a crash); results slot back by
            # the index threaded through the worker
            for i, r in pool.imap_unordered(
                    _run_indexed,
                    [(i, run_fn, chunks[i]) for i in work]):
                if checkpoint_dir is not None:
                    _ckpt_save_chunk(checkpoint_dir, chunks[i], r)
                _deliver(i, r)
    return results, position_id


def find_kmers_parallel(graph, k, n_workers, critical_paths=None,
                        position_id=None, chunks_per_worker=20,
                        checkpoint_dir=None, mp_context=None,
                        require_native=False, **finder_kwargs):
    """Full-graph DenseKmerFinder sharded over ``n_workers`` processes.

    Returns FlatKmers identical (same rows, chunk-concatenation order) to
    the reference CLI's multiprocess ``index -t N`` merge
    (command_line_interface.py:601-616). With ``checkpoint_dir`` each
    finished chunk persists immediately and an interrupted run resumes
    from the completed chunks (see the checkpoint helpers above).
    """
    results, _ = _find_pooled(_run_chunk, graph, k, n_workers,
                              critical_paths, position_id,
                              chunks_per_worker, finder_kwargs,
                              checkpoint_dir=checkpoint_dir,
                              mp_context=mp_context,
                              require_native=require_native)
    shards = [FlatKmers(h, n, r, a) for h, n, r, a in results]
    del results  # consume=True frees each shard as it is copied
    return FlatKmers.from_multiple_flat_kmers(shards, consume=True)


def _merge_span_results(results, k):
    """Concatenate chunk span tuples (worker emission order) into one
    span set, pinning the consecutive-tape-slice invariant the device
    expansion relies on (cumsum-derived starts, ops/finalize.py)."""
    from ..utils.hugepages import hp_concatenate
    tapes = [r[0] for r in results]
    tape_off = np.cumsum([0] + [len(t) for t in tapes[:-1]])
    tape = hp_concatenate(tapes) if tapes else np.zeros(0, np.int8)
    ts = hp_concatenate([r[1] + off for r, off in zip(results, tape_off)])
    nw = hp_concatenate([r[2] for r in results])
    s_node = hp_concatenate([r[3] for r in results])
    s_off = hp_concatenate([r[4] for r in results])
    raw_nl = hp_concatenate([r[5] for r in results])
    raw_nodes = hp_concatenate([r[6] for r in results])
    tlen = nw.astype(np.int64) + (k - 1)
    assert np.array_equal(ts, np.cumsum(tlen) - tlen), \
        "span tape slices are not consecutive; device finalize invariant"
    return tape, nw, s_node, s_off, raw_nl, raw_nodes


def find_kmers_parallel_device(graph, k, n_workers, critical_paths=None,
                               position_id=None, chunks_per_worker=20,
                               checkpoint_dir=None, mp_context=None,
                               stream_rows_target=16_000_000,
                               stream_tape_target=16_000_000,
                               device="cuda", require_native=False,
                               stats=None, **finder_kwargs):
    """find_kmers_parallel with a STREAMED DEVICE-RESIDENT finalize:
    workers return compact span tapes (~1 byte/base + span descriptors);
    the parent expands rows on ``device`` (ops.finalize) as chunks finish,
    so the tape upload + hash + row expansion overlap the host find
    instead of following it. Returns FlatKmers whose columns are tensors
    on ``device`` (hashes and ref offsets int64, nodes int32, allele
    frequencies float32), ready for KmerIndex.from_flat_kmers on the same
    device; the expanded rows (~24 bytes/row) never cross the
    host<->device link. Rows are bit-identical to find_kmers_parallel.

    Streaming mechanics: completions arrive unordered; chunks buffer
    until a CONSECUTIVE prefix is ready, and the buffer flushes to a
    device expansion (expand_spans_device_padded) whenever it holds
    ``stream_rows_target`` rows or ``stream_tape_target`` tape bytes.
    Runs that never cross a threshold take one expansion of the whole.

    ``stats``: a dict that receives ``groups`` (device expansions made),
    ``flush_seconds`` (host-clock seconds the pool loop spent in them:
    merge, dedup, upload and launches), ``span_rows`` (the sum over the
    spans of windows x deduped nodes, which the row count must equal),
    ``tape_bases`` (each expansion's tape length) and
    ``first_result_seconds`` (from the call to the first chunk's return:
    the workers' start-up plus one chunk's walk).

    While a profiler session records (utils/profiling.py), the call is
    the span ``build.find`` and each expansion ``build.flush``, and it
    counts ``find.chunks``, ``find.walk_us`` (the walk time each chunk
    returns; a chunk resumed from a checkpoint, the walk that made it)
    and ``find.first_result_us``.
    """
    from ..utils import profiling

    with profiling.span("build.find"):
        if finder_kwargs.get("whitelist") is not None:
            # the whitelist filter is applied at finalize time per window;
            # the device expansion path doesn't implement it: use the
            # row-returning path (whose workers filter in-finalize)
            return find_kmers_parallel(
                graph, k, n_workers, critical_paths=critical_paths,
                position_id=position_id,
                chunks_per_worker=chunks_per_worker,
                checkpoint_dir=checkpoint_dir, mp_context=mp_context,
                require_native=require_native, **finder_kwargs)
        only_save_one = finder_kwargs.get("only_save_one_node_per_kmer",
                                          False)
        only_store_nodes = finder_kwargs.get("only_store_nodes")
        if critical_paths is None:
            critical_paths = CriticalGraphPaths.from_graph(graph, k)
        if position_id is None:
            from ..graph import PositionId
            position_id = PositionId.from_graph(graph)

        from ..finder import _dedup_span_nodes
        from ..ops.finalize import (assemble_group_columns,
                                    expand_spans_device,
                                    expand_spans_device_padded)

        pending: dict = {}
        buffer: list = []
        state = {"next": 0, "rows": 0, "tape": 0}
        groups: list = []
        if stats is None:
            stats = {}
        stats.update(groups=0, flush_seconds=0.0, span_rows=0,
                     tape_bases=[], first_result_seconds=None)
        t_call = time.perf_counter()

        def _expand_buffer(expand):
            t0 = time.perf_counter()
            with profiling.span("build.flush"):
                tape, nw, s_node, s_off, raw_nl, raw_nodes = \
                    _merge_span_results(buffer, k)
                nl, ns, span_nodes, s_af = _dedup_span_nodes(
                    raw_nl, raw_nodes, graph.allele_frequencies,
                    only_save_one, only_store_nodes)
                out = expand(tape, nw, s_node, s_off, nl, span_nodes, s_af,
                             position_id._start_ids, k, device=device)
            buffer.clear()
            state["rows"] = state["tape"] = 0
            stats["groups"] += 1
            stats["span_rows"] += int((nw.astype(np.int64) * nl).sum())
            stats["tape_bases"].append(len(tape))
            stats["flush_seconds"] += time.perf_counter() - t0
            return out

        def _flush():
            groups.append(_expand_buffer(expand_spans_device_padded))

        def _on_result(i, r):
            if stats["first_result_seconds"] is None:
                stats["first_result_seconds"] = (time.perf_counter()
                                                 - t_call)
                profiling.count("find.first_result_us",
                                stats["first_result_seconds"] * 1e6)
            profiling.count("find.chunks")
            if len(r) > 7:  # an older checkpoint holds no walk time
                profiling.count("find.walk_us", r[7])
            pending[i] = r
            while state["next"] in pending:
                r2 = pending.pop(state["next"])
                state["next"] += 1
                buffer.append(r2)
                state["tape"] += len(r2[0])
                # dedup can only shrink node lists: raw product is a safe
                # upper bound for the flush threshold
                state["rows"] += int(np.sum(r2[2].astype(np.int64)
                                            * r2[5].astype(np.int64)))
            if (state["rows"] >= stream_rows_target
                    or state["tape"] >= stream_tape_target):
                _flush()

        _, position_id = _find_pooled(
            _run_chunk_spans, graph, k, n_workers, critical_paths,
            position_id, chunks_per_worker, finder_kwargs,
            checkpoint_dir=checkpoint_dir, mp_context=mp_context,
            on_result=_on_result, require_native=require_native)
        assert not pending, "chunk stream ended with a gap in the prefix"

        if not groups:
            # one expansion of the whole (small runs / tests)
            return FlatKmers(*_expand_buffer(expand_spans_device))

        if buffer:
            _flush()
        return FlatKmers(*assemble_group_columns(groups))
