"""Rows that the CSR bucket scan compares per thousand queries whose
bucket holds a row: 1000 x ``csr.scan_rows`` / ``csr.queries``, from the
port's host counters over the traced window. None where the port has no
such counters or scanned nothing."""
from portbench.lib import csr_counters


def read(run):
    c = csr_counters.read(run)
    if c is None:
        return None
    return 1000.0 * c["csr.scan_rows"] / c["csr.queries"]
