"""The CSR lookup a request, as the port's span ``lookup.csr``
(``ops/lookup.DeviceKmerIndex.map_kmers`` where the packed table exceeds
its budget: the bucket scan by depth, which waits for the card at every
pass, and the counts' scatter) times it on the host, in ms a request.
None where the port has no such span or took the packed path."""
from portbench.lib import program


def read(run):
    return program.span_ms(run, "lookup.csr")
