"""Rows of the bucket-sorted k-mers that K2's bucket scan reads (once per
distinct pending k-mer of a tile of 256 queries) per thousand queries:
1000 x ``k2.scan_rows`` / ``k2.queries``, from the port's K2 counters
over the traced window."""
from portbench.lib import program


def read(run):
    c = program.k2_counters(run)
    if c is None:
        return None
    return 1000.0 * c["k2.scan_rows"] / c["k2.queries"]
