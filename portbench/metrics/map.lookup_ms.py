"""``KmerIndex.map_kmers`` of a request, counts on the host: the host clock
around the call, in ms a request."""
from portbench.lib import readers


def read(run):
    return readers.mean_span_ms(run, "map_kmers")
