"""The share of the pooled find's worker time spent walking the graph:
100 x the port's counter ``find.walk_us`` (the walk time each chunk
returns) over the workers times the span ``build.find``, in percent.
The rest is the workers' start-up, the transfer of their results and
the wait for the parent's expansions."""
from portbench.lib import build_spans


def read(run):
    return build_spans.find_walk_share(run)
