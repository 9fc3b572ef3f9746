"""Host read and parse a request (``read_kmers._iter_record_blocks`` and
``native.fasta_encode``), as the port's spans ``read_kmers.read`` and
``read_kmers.parse`` time them in a traced run, with no synchronise, in
ms a request."""
from portbench.lib import program


def read(run):
    parts = [program.span_ms(run, name)
             for name in ("read_kmers.read", "read_kmers.parse")]
    if all(p is None for p in parts):
        return None
    return sum(p or 0.0 for p in parts)
