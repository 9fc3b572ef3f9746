"""Passes of the CSR bucket scan a request, each a few ``nonzero`` calls
and so waits of the host for the card (the passes by depth, and the one
that compares the deeper buckets' rest once per distinct k-mer):
``csr.passes`` over the window's requests, from the port's host counters.
None where the port has no such counters or scanned nothing."""
from portbench.lib import csr_counters


def read(run):
    c = csr_counters.read(run)
    if c is None or not run.requests:
        return None
    return c["csr.passes"] / run.requests
