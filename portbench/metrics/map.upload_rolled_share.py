"""Share of a request's queries that went to the card as a 2-bit step of
the rolled form (``ops/rolled.py`` through ``ops/host_buffers.py``):
100 x ``upload.rolled`` / (``upload.rolled`` + ``upload.anchors`` +
``upload.staged_bytes`` / 8), from the port's host counters over the
traced window, in percent. None where the port has no such counters or
uploaded nothing through its ring."""


def read(run):
    if not run.trace:
        return None
    from graph_kmer_index_tpu_torch.utils import profiling

    counters = getattr(profiling, "counters", None)
    if counters is None:
        return None
    c = counters(run.device)
    rolled = c.get("upload.rolled")
    anchors = c.get("upload.anchors")
    staged = c.get("upload.staged_bytes")
    if rolled is None or anchors is None or staged is None:
        return None
    total = rolled + anchors + staged / 8
    if total == 0:
        return None
    return 100.0 * rolled / total
