"""The dense build's pooled find (``find_kmers_parallel_device``: the
workers' start-up, their span walk and the rows' expansion on the card
as chunks come back), as the port's span ``build.find`` times it, in ms
a build."""
from portbench.lib import build_spans


def read(run):
    return build_spans.build_ms(run, "build.find")
