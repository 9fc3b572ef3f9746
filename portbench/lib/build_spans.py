"""Helpers of the readers of a traced build (``indexes/dense.py`` keeps
it on the run as ``run.dense_build``): the port's spans and its find's
counters, each None where the run holds nothing to read. A port without
a span or a counter reads as None, and nothing raises."""
from __future__ import annotations


def build_ms(run, name: str):
    """Milliseconds of the build inside the port's span ``name``, summed
    over its ranges (one build a run), or None."""
    build = getattr(run, "dense_build", None)
    if not build or name not in build["spans"]:
        return None
    return build["spans"][name] * 1e3


def find_walk_share(run):
    """Percent of the find's worker time that the workers spent walking:
    100 x ``find.walk_us`` over the workers times the span
    ``build.find``, or None."""
    build = getattr(run, "dense_build", None)
    if not build:
        return None
    walk = build["counters"].get("find.walk_us")
    find_s = build["spans"].get("build.find")
    if not walk or not find_s:
        return None
    return 100.0 * walk / 1e6 / (build["workers"] * find_s)
