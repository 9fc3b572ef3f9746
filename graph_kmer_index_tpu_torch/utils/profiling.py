"""Profiling harness: the port of graph_kmer_index_tpu/utils/profiling.py.
Span timing on the host's clock, ``torch.profiler`` traces of device work,
the program's own spans and counters, and the reference's run_profile.py
scenario.

Spans and counters are on while a ``torch.profiler`` session records
(:func:`active`): a session of the caller's own, or :func:`device_trace`.
A span is then a ``record_function`` range in the profiler's trace, on
the clock that the trace shares with the device's activity; otherwise it
costs one flag read. The read-mapping path's spans, each nested in the
one above it:

    kmer_index.map_kmers       KmerIndex.map_kmers, the whole call
      kmer_index.upload        KmerIndex._queries: the queries to the device
                               (through the staging ring, host_buffers.upload,
                               rolled where they roll)
      lookup.k2                ops.lookup.packed_lookup on CUDA: the counts'
                               zeroing and K2's launch (host time only)
      lookup.csr               ops.lookup.DeviceKmerIndex.map_kmers /
                               has_kmers where the packed table exceeds its
                               budget: the CSR bucket scan by depth, which
                               waits for the device at every pass
      kmer_index.counts_to_host  the wait for K2 and the counts' copy
    read_kmers.hash_fasta_file   read_kmers.hash_fasta_file, the whole call
      read_kmers.read          the next whole-record block of the file
      read_kmers.parse         the block's 2-bit encoding
      read_kmers.upload        the tape segment to the device
      read_kmers.hash          K1 and the reverse complements

The dense build's spans (``CriticalGraphPaths.from_graph`` through the
packed table):

    build.critical_paths       CriticalGraphPaths.from_graph
    build.find                 parallel.host_pool.find_kmers_parallel_device,
                               the whole streamed find
      build.flush              one device expansion of the finished chunks
    kmer_index.build           KmerIndex.from_rows: the bucket layout and
                               the frequencies
    lookup.pack                DeviceKmerIndex.packed: the packed table

Counters (:func:`counters`): K2 adds, per launch while a session records,
``k2.queries`` (valid queries whose bucket lies in the table or its
shard), ``k2.pending`` (those the record's lanes could not answer, left
to the bucket scan), ``k2.scan_rows`` (rows the scan read, once per
distinct k-mer of a tile of 256 queries) and ``k2.scan_matches`` (rows
that matched). They live in one small int64 tensor per device, made at
the first counted launch, and come to the host only when read. Beside
them, on the host, the pool of pinned count blocks
(``ops/host_buffers.py``) adds ``host_counts.reused`` (a block answered
from the free list) and ``host_counts.allocated`` (a block that had to
be mapped and pinned), and its staging ring of uploads adds
``upload.staged_bytes`` (query bytes that went through the ring as they
are), ``upload.ring_waits`` (times the host found the copy to the card of
the block next in turn unfinished), ``upload.rolled`` (queries sent in the
rolled form as a 2-bit step), ``upload.anchors`` (queries sent whole
inside the rolled form) and ``upload.rolled_bytes`` (bytes of the rolled
form sent to the card). The pooled find adds, per call of
``find_kmers_parallel_device``, ``find.chunks`` (chunk results
delivered), ``find.walk_us`` (microseconds the workers spent walking
them, which each chunk returns with its result) and
``find.first_result_us`` (microseconds from the call to the first
result: the workers' start-up and one chunk's walk). The CSR bucket scan
of ``map_kmers``/``has_kmers`` (span ``lookup.csr``) adds ``csr.queries``
(queries whose bucket holds a row), ``csr.passes`` (passes by depth,
each two ``nonzero`` calls and so two waits for the device, and one pass
more where queries are left past ``ops.lookup.CSR_DEPTH_PASSES`` rows and
compare the rest of their buckets once per distinct k-mer),
``csr.scan_rows`` (rows compared: the sum of each pass's queries, and the
distinct k-mers' rows) and ``csr.hits`` (compared rows that matched), all
from shapes the passes have brought to the host.
"""
from __future__ import annotations

import contextlib
import logging
import os
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

K2_COUNTERS = ("k2.queries", "k2.pending", "k2.scan_rows", "k2.scan_matches")
CSR_COUNTERS = ("csr.queries", "csr.passes", "csr.scan_rows", "csr.hits")
HOST_COUNTERS = ("host_counts.reused", "host_counts.allocated",
                 "find.chunks", "find.walk_us", "find.first_result_us",
                 "upload.staged_bytes", "upload.ring_waits",
                 "upload.rolled", "upload.anchors", "upload.rolled_bytes",
                 *CSR_COUNTERS)
# copies of the counters that K2's blocks add to in turn
# (csrc/packed_lookup.cu: kStatStripes), so that no one address takes
# every block's atomics
COUNTER_STRIPES = 64

_OFF = contextlib.nullcontext()
_counter_tensors: dict[torch.device, torch.Tensor] = {}
_host_counters = dict.fromkeys(HOST_COUNTERS, 0)
_host_counters_lock = threading.Lock()


def active() -> bool:
    """True while a ``torch.profiler`` session records."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str):
    """A context: a ``record_function`` range named ``name`` while a
    profiler session records; otherwise a shared no-op (no clock read, no
    allocation, no synchronise)."""
    if not active():
        return _OFF
    return torch.profiler.record_function(name)


def count(name: str, amount: int = 1) -> None:
    """Add ``amount`` to the host counter ``name`` while a session
    records."""
    if active():
        with _host_counters_lock:
            _host_counters[name] += int(amount)


def _device_key(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def counter_tensor(device) -> torch.Tensor:
    """The device's counters, ``(COUNTER_STRIPES, len(K2_COUNTERS))``
    int64, made zero at first use."""
    key = _device_key(device)
    t = _counter_tensors.get(key)
    if t is None:
        t = torch.zeros((COUNTER_STRIPES, len(K2_COUNTERS)),
                        dtype=torch.int64, device=key)
        _counter_tensors[key] = t
    return t


def counters(device=None) -> dict[str, int]:
    """K2's counters of ``device`` (of every device, summed, where None)
    and the host's counters, since the last :func:`reset_counters`; 0
    where nothing was counted. Reading them synchronises with the device
    once."""
    keys = (list(_counter_tensors) if device is None
            else [_device_key(device)])
    total = [0] * len(K2_COUNTERS)
    for key in keys:
        t = _counter_tensors.get(key)
        if t is not None:
            total = [a + b for a, b in zip(total, t.sum(0).tolist())]
    return {**dict(zip(K2_COUNTERS, total)), **_host_counters}


def reset_counters() -> None:
    """Drop every device's counters, so that the next counted launch
    starts them at zero, and zero the host's."""
    _counter_tensors.clear()
    _host_counters.update(dict.fromkeys(HOST_COUNTERS, 0))


class Timings:
    """Named wall-clock spans with a report, usable as context managers."""

    def __init__(self):
        self.spans: dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.spans[name] = self.spans.get(name, 0.0) + (
                time.perf_counter() - t)

    def report(self) -> str:
        total = sum(self.spans.values())
        lines = [f"{name:40s} {sec:10.3f}s {100 * sec / max(total, 1e-12):5.1f}%"
                 for name, sec in sorted(self.spans.items(),
                                         key=lambda kv: -kv[1])]
        return "\n".join(lines + [f"{'TOTAL':40s} {total:10.3f}s"])


class Trace:
    """The file a :func:`device_trace` wrote (``path``) and the block's
    :func:`counters` (``counters``), both set when its block ends."""

    path: str | None = None
    counters: dict[str, int] | None = None


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` around a block, CPU and CUDA activities, written
    as a Chrome trace (chrome://tracing, Perfetto) into ``log_dir``, also
    when the block raises; the program's spans are in it. Yields a
    :class:`Trace` that names the file and keeps the block's counters
    (reset when the block starts)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    trace = Trace()
    reset_counters()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        yield trace
    finally:
        prof.stop()
        trace.counters = counters()
        path = os.path.join(log_dir,
                            f"trace-{os.getpid()}-{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        trace.path = path
        logging.info("device trace written to %s", path)


def profile_dense_finder(graph_file: str, k: int = 31,
                         max_variant_nodes: int = 4,
                         device="cuda") -> float:
    """The reference run_profile.py scenario: full-graph DenseKmerFinder,
    its tape hashed on ``device`` (DenseKmerFinder's rule)."""
    from ..finder import DenseKmerFinder
    from ..graph import Graph

    graph = Graph.from_file(graph_file)
    t = time.perf_counter()
    finder = DenseKmerFinder(graph, k=k, max_variant_nodes=max_variant_nodes,
                             device=device)
    finder.find()
    finder.get_flat_kmers(v="1")
    elapsed = time.perf_counter() - t
    logging.info("Took %.2f sec to find kmers", elapsed)
    return elapsed
