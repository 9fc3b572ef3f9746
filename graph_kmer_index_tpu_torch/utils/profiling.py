"""Profiling harness: the port of graph_kmer_index_tpu/utils/profiling.py.
Span timing on the host's clock, ``torch.profiler`` traces of device work,
and the reference's run_profile.py scenario.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time


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
    """The file a :func:`device_trace` wrote (``path``, set when its
    block ends)."""

    path: str | None = None


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` around a block, CPU and CUDA activities, written
    as a Chrome trace (chrome://tracing, Perfetto) into ``log_dir``, also
    when the block raises. Yields a :class:`Trace` that names the file."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    trace = Trace()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        yield trace
    finally:
        prof.stop()
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
