"""The dense build's index (``KmerIndex.from_rows``: the rows sorted into
buckets at the configuration's modulo and their frequencies), as the
port's span ``kmer_index.build`` times it on the host, in ms a build."""
from portbench.lib import build_spans


def read(run):
    return build_spans.build_ms(run, "kmer_index.build")
