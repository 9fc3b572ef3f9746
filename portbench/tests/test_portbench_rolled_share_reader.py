"""The readers of the rolled upload, ``map.upload_rolled_share`` (the
port's counters) and ``map.rolled_decode_roofline`` (the counters and K9's
device time): None on an untraced run, on a port without the counters
(the parent of the rolled form counts staged bytes alone, an older port
no host counters at all), without K9 in the trace, and where nothing was
uploaded; the share where they were counted."""
from types import SimpleNamespace

import pytest
import torch

from graph_kmer_index_tpu_torch.utils import profiling
from portbench.lib import harness
from portbench.tests import tiny

NAME = "map.upload_rolled_share"
ROOFLINE = "map.rolled_decode_roofline"
K2 = {"k2.queries": 200_000, "k2.pending": 4_000,
      "k2.scan_rows": 12_000, "k2.scan_matches": 3_000}


def _run(trace=True, device_s=None):
    summary = None if device_s is None else {"device_s": device_s}
    return SimpleNamespace(trace=trace, trace_summary=summary, requests=20,
                           device=torch.device("cpu"))


def _read(run, name=NAME):
    return harness.load_module("metrics", name).read(run)


def _counting(monkeypatch, values):
    monkeypatch.setattr(profiling, "counters",
                        lambda device=None: dict(values), raising=False)


@pytest.mark.parametrize("rolled, anchors, staged_bytes, share", [
    (990, 10, 0, 99.0), (0, 0, 800, 0.0), (300, 100, 800, 60.0),
    (1000, 0, 0, 100.0)])
def test_reads_the_share(monkeypatch, rolled, anchors, staged_bytes, share):
    _counting(monkeypatch, dict(K2, **{"upload.rolled": rolled,
                                       "upload.anchors": anchors,
                                       "upload.staged_bytes": staged_bytes}))
    assert _read(_run()) == pytest.approx(share)
    assert _read(_run(trace=False)) is None


@pytest.mark.parametrize("counters", [
    "staged_only", "none_uploaded", "no_counters"])
def test_none_without_the_counters(monkeypatch, counters):
    """A port whose ring counts staged bytes alone (the parent of the
    rolled form), one that uploaded nothing, and one with no counters."""
    if counters == "no_counters":
        monkeypatch.delattr(profiling, "counters", raising=False)
    else:
        extra = ({"upload.staged_bytes": 8000, "upload.ring_waits": 0}
                 if counters == "staged_only" else
                 {"upload.staged_bytes": 0, "upload.rolled": 0,
                  "upload.anchors": 0})
        _counting(monkeypatch, dict(K2, **extra))
    assert _read(_run()) is None


@pytest.mark.parametrize("name", [NAME, ROOFLINE])
def test_none_in_a_tiny_traced_cpu_run(name):
    """On the CPU the index reads its queries in place, through no ring:
    the traced run reads nothing, and still gives its line."""
    res, _ = tiny.run("map_hashes.wg_signature", trace=True)
    assert res["correct"]
    assert name not in res["metrics"]


# K9's device time in a trace, and another kernel's beside it
K9_TRACE = {"rolled_decode_kernel": 0.002, "packed_lookup_kernel": 0.5,
            "Memcpy HtoD (Pinned -> Device)": 0.1}


@pytest.mark.parametrize("rolled, anchors, form_bytes", [
    (990, 10, 3_350_000), (8_374_000, 70_000, 2_960_000)])
def test_the_decode_roofline_is_its_bytes_over_k9s_time(
        monkeypatch, rolled, anchors, form_bytes):
    _counting(monkeypatch, dict(K2, **{"upload.rolled": rolled,
                                       "upload.anchors": anchors,
                                       "upload.rolled_bytes": form_bytes,
                                       "upload.staged_bytes": 0}))
    nbytes = form_bytes + 8 * (rolled + anchors)
    want = nbytes / 3.35e12 / 0.002 * 100
    assert _read(_run(device_s=K9_TRACE), ROOFLINE) == pytest.approx(want)
    assert _read(_run(trace=False, device_s=K9_TRACE), ROOFLINE) is None


@pytest.mark.parametrize("case", [
    "no_k9", "staged_only", "no_counters", "no_trace"])
def test_the_decode_roofline_is_none_without_k9(monkeypatch, case):
    """A trace without K9 (the parent of the rolled form), a ring that sent
    raw chunks alone, a port with no counters, a run with no trace."""
    device_s = dict(K9_TRACE)
    counted = {"upload.rolled": 990, "upload.anchors": 10,
               "upload.rolled_bytes": 4000, "upload.staged_bytes": 0}
    if case == "no_k9":
        del device_s["rolled_decode_kernel"]
    elif case == "staged_only":
        counted = {"upload.staged_bytes": 8000, "upload.ring_waits": 0}
    _counting(monkeypatch, dict(K2, **counted))
    if case == "no_counters":
        monkeypatch.delattr(profiling, "counters", raising=False)
    run = _run(device_s=None if case == "no_trace" else device_s)
    assert _read(run, ROOFLINE) is None
