"""K1 (``csrc/sliding_hash.cu``): the bytes bound of the window's read
hashing (1 + 8 bytes a base of every tape hashed) at 3.35 TB/s over K1's
device time in the trace, in percent."""
from portbench.lib import readers


def read(run):
    return readers.kernel_roofline(run, "sliding_hash_kernel", "k1_bytes")
