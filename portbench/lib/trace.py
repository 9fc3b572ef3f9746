"""Spans and the device trace of a run.

``Spans`` keeps the harness's own spans: host-clock seconds of named
stages, per request, in memory. In a traced run each span is also a
``torch.profiler.record_function`` range, so the trace can say what the
host was doing while the device sat idle. Spans come only from the
benchmark's files, around calls into the port.

``read_trace`` reduces a ``torch.profiler`` chrome trace to what the
per-layer metrics read: the device's busy time (the union of kernel,
copy and memset intervals inside the measured window), device seconds by
operation name, and idle seconds by the innermost harness span that was
open on the host.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

WINDOW_SPAN = "portbench.window"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    def __init__(self, annotate: bool):
        self.annotate = annotate
        self.seconds = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        ctx = (torch.profiler.record_function(name) if self.annotate
               else contextlib.nullcontext())
        t0 = time.perf_counter()
        with ctx:
            yield
        self.seconds[name].append(time.perf_counter() - t0)


def start_profiler():
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def short_name(name: str, width: int = 96) -> str:
    """A device operation's name without its parameter list and the
    namespaces that every kernel of a library shares, cut to ``width``
    (a copy or memset keeps its kinds of memory)."""
    if name.startswith(("Memcpy", "Memset")):
        return name[:width]
    for prefix in ("void ", "(anonymous namespace)::"):
        if name.startswith(prefix):
            name = name[len(prefix):]
    name = name.replace("at::native::", "").replace("(anonymous namespace)::", "")
    depth = 0
    for i, c in enumerate(name):
        if c == "<":
            depth += 1
        elif c == ">":
            depth -= 1
        elif c == "(" and depth == 0 and i:
            name = name[:i]
            break
    return name[:width]


def _union(intervals):
    """Merged (start, end) intervals of a list of (start, end)."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def read_trace(prof) -> dict:
    """Stop ``prof`` and reduce its trace: ``window_s``, ``busy_s``,
    ``device_s`` {operation name: seconds}, ``idle_s`` {span: seconds},
    ``spans`` {name: seconds} (host-clock time inside the trace). Times
    in the trace are microseconds on one clock for host and device."""
    prof.__exit__(None, None, None)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    window = None
    device, spans = [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        start, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat in DEVICE_CATEGORIES:
            device.append((start, start + dur, short_name(ev["name"])))
        elif cat == "user_annotation":
            if ev["name"] == WINDOW_SPAN:
                window = (start, start + dur)
            else:
                spans.append((start, start + dur, ev["name"]))
    if window is None:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = window
    by_name = defaultdict(float)
    clipped = []
    for s, e, name in device:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            by_name[name] += (e - s) / 1e6
            clipped.append((s, e))
    busy = _union(clipped)
    busy_s = sum(e - s for s, e in busy) / 1e6
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    spans.sort()
    starts = [s for s, _, _ in spans]
    longest = max((e - s for s, e, _ in spans), default=0.0)
    idle = defaultdict(float)
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        open_spans = []
        i = bisect.bisect_right(starts, mid) - 1
        while i >= 0 and starts[i] >= mid - longest:
            s, e, name = spans[i]
            if mid <= e:
                open_spans.append((e - s, name))
            i -= 1
        label = min(open_spans)[1] if open_spans else "outside any span"
        idle[label] += (g1 - g0) / 1e6
    span_s = defaultdict(float)
    for s, e, name in spans:
        span_s[name] += (e - s) / 1e6
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy_s,
            "device_s": dict(by_name), "idle_s": dict(idle),
            "spans": dict(span_s)}


def device_seconds(trace: dict, kernel: str) -> float:
    """Device seconds of the operations whose name holds ``kernel``."""
    return sum(s for name, s in trace["device_s"].items() if kernel in name)


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
