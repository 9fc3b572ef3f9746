"""K2 (``csrc/packed_lookup.cu``) in the window of the dense cell: the
bytes bound of its lookups (the yardstick's ``k2_bytes`` of each
request's queries against the reference's rows) at 3.35 TB/s over K2's
device time in the trace, in percent."""
from portbench.lib import readers


def read(run):
    return readers.kernel_roofline(run, "packed_lookup_kernel", "k2_bytes")
