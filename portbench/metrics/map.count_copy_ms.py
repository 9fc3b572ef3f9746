"""The node counts' copy to the host a request (``KmerIndex.map_kmers``'
``counts.cpu()``): the device time of the window's device-to-host copies
in the trace, in ms a request."""
from portbench.lib import readers


def read(run):
    return readers.copy_ms_per_request(run, "DtoH")
