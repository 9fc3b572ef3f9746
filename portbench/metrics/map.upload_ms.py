"""The upload a request, host to card: the read tape (``hash_fasta_file``)
or the query k-mers (``map_kmers`` on a host array); the device time of
the window's host-to-device copies in the trace, in ms a request."""
from portbench.lib import readers


def read(run):
    return readers.copy_ms_per_request(run, "HtoD")
