"""The CSR lookup against its bytes bound: the yardstick's ``csr_bytes``
(``lib/csr_roofline.py``: the bytes any CSR lookup of the window's
queries must move, from the reads and the reference's rows) at 3.35 TB/s,
over the time of the port's span ``lookup.csr`` in the trace, in percent.

The layer's device work is generic ``aten`` kernels (gathers, compares,
boolean indexing, ``index_add_``) that the trace cannot tell from other
layers' by name, so the denominator is the span's time, which holds that
work: every pass of the scan waits for the card. None where the run has
no such span or no yardstick."""
from portbench.lib import roofline


def read(run):
    t = run.trace_summary
    nbytes = run.yard.get("csr_bytes")
    if t is None or not nbytes:
        return None
    seconds = t["spans"].get("lookup.csr")
    if not seconds:
        return None
    return roofline.roofline_percent(nbytes, seconds)
