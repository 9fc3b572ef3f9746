"""Host read and parse a request (``read_kmers._iter_record_blocks`` and
``native.fasta_encode``): the "read" and "parse" seconds of
``hash_fasta_file(stage_seconds=)``, whose stages each end in a device
synchronise (so traced runs only), in ms a request."""
from portbench.lib import readers


def read(run):
    s = readers.mean_stage(run, "read", "parse")
    return None if s is None else s * 1e3
