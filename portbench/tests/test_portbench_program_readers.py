"""The readers of the port's own spans and counters: None on an untraced
run and where the program has nothing to read (a port without the spans
or the counters), the expected number on a synthetic trace summary or
counter dict."""
from types import SimpleNamespace

import pytest
import torch

from graph_kmer_index_tpu_torch.utils import profiling
from portbench.lib import harness
from portbench.tests import tiny

SPANS = {"kmer_index.map_kmers": 40.0, "kmer_index.upload": 9.0,
         "lookup.k2": 0.5, "kmer_index.counts_to_host": 30.0,
         "read_kmers.read": 1.2, "read_kmers.parse": 6.8,
         "map_kmers": 40.1}
COUNTERS = {"k2.queries": 200_000, "k2.pending": 4_000,
            "k2.scan_rows": 12_000, "k2.scan_matches": 3_000}
# per request of 20: seconds a request in ms, and the counters' ratios
EXPECTED = {"map.upload_span_ms": 450.0,
            "map.counts_to_host_ms": 1500.0,
            "map.map_kmers_self_ms": (40.0 - 9.0 - 0.5 - 30.0) / 20 * 1e3,
            "map.read_parse_span_ms": 400.0,
            "map.k2_lane_share": 98.0,
            "map.k2_scan_rows_per_kquery": 60.0}


def _run(trace=True, spans=SPANS, requests=20):
    summary = ({"window_s": 51.0, "busy_s": 50.0, "device_s": {},
                "idle_s": {}, "spans": dict(spans)} if trace else None)
    return SimpleNamespace(trace=trace, trace_summary=summary,
                           requests=requests, device=torch.device("cpu"))


def _read(name, run):
    return harness.load_module("metrics", name).read(run)


def _counting(values):
    return lambda device=None: dict(values)


@pytest.fixture
def counters(monkeypatch):
    monkeypatch.setattr(profiling, "counters", _counting(COUNTERS),
                        raising=False)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_a_synthetic_run(name, counters):
    assert _read(name, _run()) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_an_untraced_run(name, counters):
    assert _read(name, _run(trace=False)) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_where_the_program_has_nothing(name, monkeypatch):
    """No program spans in the trace, no requests, no queries counted,
    and a port whose profiling module has no counters."""
    monkeypatch.setattr(profiling, "counters",
                        _counting(dict.fromkeys(COUNTERS, 0)), raising=False)
    assert _read(name, _run(spans={"map_kmers": 40.1})) is None
    assert _read(name, _run(requests=0)) is None
    monkeypatch.delattr(profiling, "counters", raising=False)
    assert _read(name, _run(spans={"map_kmers": 40.1})) is None


def test_new_readers_are_none_in_a_tiny_traced_cpu_run():
    """On the CPU the harness starts no profiler: the traced run reads
    nothing of the program, and still gives its line."""
    res, _ = tiny.run("map_hashes.wg_signature", trace=True)
    assert res["correct"]
    assert not set(EXPECTED) & set(res["metrics"])
