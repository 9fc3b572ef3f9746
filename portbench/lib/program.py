"""Helpers of the readers of the port's own spans and counters
(``graph_kmer_index_tpu_torch/utils/profiling.py``): each returns None
where the run holds nothing to read, as ``readers.py``'s do. A port
without the spans or the counters reads as None, and nothing raises."""
from __future__ import annotations


def span_ms(run, name: str):
    """Milliseconds a request inside the port's span ``name``: the sum of
    its ranges in the traced window over the requests, or None."""
    t = run.trace_summary
    if t is None or not run.requests or name not in t["spans"]:
        return None
    return t["spans"][name] / run.requests * 1e3


def k2_counters(run):
    """K2's counters of the traced window (``profiling.counters`` of the
    run's device), or None where K2 counted no query."""
    if not run.trace:
        return None
    from graph_kmer_index_tpu_torch.utils import profiling

    read = getattr(profiling, "counters", None)
    if read is None:
        return None
    counts = read(run.device)
    return counts if counts.get("k2.queries") else None
