"""Helpers of the per-layer metric readers (``metrics/<name>.py``): each
returns None where the run holds nothing to read, never 0 for a share."""
from __future__ import annotations

from . import roofline, trace as tracing


def mean_span_ms(run, name: str):
    values = run.spans.seconds.get(name)
    if not values:
        return None
    return sum(values) / len(values) * 1e3


def mean_stage(run, *names):
    """Mean over requests of the port's own stage seconds (summed over
    ``names``), or None where the port reported none."""
    per = [sum(st.get(n, 0.0) for n in names) for st in run.program_stages
           if any(n in st for n in names)]
    return sum(per) / len(per) if per else None


def idle_share_percent(run):
    t = run.trace_summary
    if t is None or t["window_s"] <= 0:
        return None
    return (1.0 - t["busy_s"] / t["window_s"]) * 100.0


def kernel_roofline(run, kernel: str, bytes_key: str):
    t = run.trace_summary
    nbytes = run.yard.get(bytes_key)
    if t is None or not nbytes:
        return None
    return roofline.roofline_percent(nbytes,
                                     tracing.device_seconds(t, kernel))


def copy_ms_per_request(run, direction: str):
    """Device milliseconds of the window's copies in ``direction`` (as the
    trace names them, e.g. "HtoD") a request."""
    t = run.trace_summary
    if t is None or not run.requests:
        return None
    s = sum(v for name, v in t["device_s"].items()
            if "Memcpy" in name and direction in name)
    return s / run.requests * 1e3 if s > 0 else None
