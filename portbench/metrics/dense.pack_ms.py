"""The dense build's packed table (``DeviceKmerIndex.packed``, which K2
reads), as the port's span ``lookup.pack`` times it on the host, in ms a
build."""
from portbench.lib import build_spans


def read(run):
    return build_spans.build_ms(run, "lookup.pack")
