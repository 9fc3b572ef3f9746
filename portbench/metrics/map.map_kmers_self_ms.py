"""``KmerIndex.map_kmers``' own host time a request: its span
``kmer_index.map_kmers`` less the spans inside it (``kmer_index.upload``,
``lookup.k2``, ``kmer_index.counts_to_host``), in ms a request."""
from portbench.lib import program

INNER = ("kmer_index.upload", "lookup.k2", "kmer_index.counts_to_host")


def read(run):
    outer = program.span_ms(run, "kmer_index.map_kmers")
    if outer is None:
        return None
    return outer - sum(program.span_ms(run, name) or 0.0 for name in INNER)
