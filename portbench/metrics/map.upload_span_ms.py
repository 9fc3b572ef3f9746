"""The queries' upload a request, host to card, as the port's span
``kmer_index.upload`` (``KmerIndex._queries``: ``np.asarray`` and the
pageable copy) times it on the host, in ms a request."""
from portbench.lib import program


def read(run):
    return program.span_ms(run, "kmer_index.upload")
