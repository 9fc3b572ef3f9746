"""The node counts to the host a request, as the port's span
``kmer_index.counts_to_host`` (``KmerIndex.map_kmers``'
``counts.cpu().numpy()``: the wait for K2 and the copy into fresh
pageable memory) times it on the host, in ms a request."""
from portbench.lib import program


def read(run):
    return program.span_ms(run, "kmer_index.counts_to_host")
