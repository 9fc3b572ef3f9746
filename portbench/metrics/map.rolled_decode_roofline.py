"""K9 (``csrc/rolled_decode.cu``), the decode of the rolled upload: the
bytes bound of the window's decodes (the rolled form read once,
``upload.rolled_bytes``, and 8 bytes written for each query it holds,
``upload.rolled`` + ``upload.anchors``, from the port's host counters) at
3.35 TB/s over K9's device time in the trace, in percent. None where the
port has no such counters or kernel, or sent nothing in the rolled
form."""
from portbench.lib import roofline, trace as tracing

KERNEL = "rolled_decode_kernel"


def read(run):
    t = run.trace_summary
    if not run.trace or t is None:
        return None
    from graph_kmer_index_tpu_torch.utils import profiling

    counters = getattr(profiling, "counters", None)
    if counters is None:
        return None
    c = counters(run.device)
    form = c.get("upload.rolled_bytes")
    rolled = c.get("upload.rolled")
    anchors = c.get("upload.anchors")
    if not form or rolled is None or anchors is None:
        return None
    return roofline.roofline_percent(form + 8 * (rolled + anchors),
                                     tracing.device_seconds(t, KERNEL))
