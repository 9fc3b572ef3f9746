"""Share of ``KmerIndex.map_kmers``' count copies that went into a host
block the port had pinned before (``ops/host_buffers.py``): 100 x
``host_counts.reused`` / (``host_counts.reused`` +
``host_counts.allocated``), from the port's host counters over the traced
window, in percent. None where the port has no such counters or took no
block."""


def read(run):
    if not run.trace:
        return None
    from graph_kmer_index_tpu_torch.utils import profiling

    counters = getattr(profiling, "counters", None)
    if counters is None:
        return None
    c = counters(run.device)
    reused = c.get("host_counts.reused")
    allocated = c.get("host_counts.allocated")
    if reused is None or allocated is None or reused + allocated == 0:
        return None
    return 100.0 * reused / (reused + allocated)
