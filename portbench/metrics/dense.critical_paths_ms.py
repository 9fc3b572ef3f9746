"""The dense build's critical paths (``CriticalGraphPaths.from_graph``, a
walk of the graph in Python on the host), as the port's span
``build.critical_paths`` times it, in ms a build."""
from portbench.lib import build_spans


def read(run):
    return build_spans.build_ms(run, "build.critical_paths")
