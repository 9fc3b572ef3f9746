"""The port's CSR counters of a traced window (``utils/profiling.py``:
``csr.queries``, ``csr.passes``, ``csr.scan_rows``, ``csr.hits``), read
as ``program.k2_counters`` reads K2's: None where the run is untraced,
the port has no such counters, or the scan saw no query."""
from __future__ import annotations

NAMES = ("csr.queries", "csr.passes", "csr.scan_rows", "csr.hits")


def read(run):
    if not run.trace:
        return None
    from graph_kmer_index_tpu_torch.utils import profiling

    counters = getattr(profiling, "counters", None)
    if counters is None:
        return None
    c = counters(run.device)
    if any(c.get(name) is None for name in NAMES) or not c["csr.queries"]:
        return None
    return {name: c[name] for name in NAMES}
