"""The reader of the port's host-block counters,
``map.count_block_reuse_share``: None on an untraced run, on a port
without the counters (the K2 counters alone, or no counters at all) and
where no block was taken; the share where they were counted."""
from types import SimpleNamespace

import pytest
import torch

from graph_kmer_index_tpu_torch.utils import profiling
from portbench.lib import harness
from portbench.tests import tiny

NAME = "map.count_block_reuse_share"
K2 = {"k2.queries": 200_000, "k2.pending": 4_000,
      "k2.scan_rows": 12_000, "k2.scan_matches": 3_000}


def _run(trace=True):
    return SimpleNamespace(trace=trace, trace_summary=None, requests=20,
                           device=torch.device("cpu"))


def _read(run):
    return harness.load_module("metrics", NAME).read(run)


def _counting(monkeypatch, values):
    monkeypatch.setattr(profiling, "counters",
                        lambda device=None: dict(values), raising=False)


@pytest.mark.parametrize("reused, allocated, share", [
    (97, 3, 97.0), (40, 0, 100.0), (0, 5, 0.0), (1, 3, 25.0)])
def test_reads_the_share(monkeypatch, reused, allocated, share):
    _counting(monkeypatch, dict(K2, **{"host_counts.reused": reused,
                                       "host_counts.allocated": allocated}))
    assert _read(_run()) == pytest.approx(share)
    assert _read(_run(trace=False)) is None


@pytest.mark.parametrize("counters", [
    "k2_only", "none_taken", "no_counters"])
def test_none_without_the_counters(monkeypatch, counters):
    """A port whose counters hold K2's alone (the parent of the pool),
    one that took no block, and one with no counters at all."""
    if counters == "no_counters":
        monkeypatch.delattr(profiling, "counters", raising=False)
    else:
        extra = ({"host_counts.reused": 0, "host_counts.allocated": 0}
                 if counters == "none_taken" else {})
        _counting(monkeypatch, dict(K2, **extra))
    assert _read(_run()) is None


def test_none_in_a_tiny_traced_cpu_run():
    """On the CPU the counts stay in host memory and no block is taken:
    the traced run reads nothing, and still gives its line."""
    res, _ = tiny.run("map_hashes.wg_signature", trace=True)
    assert res["correct"]
    assert NAME not in res["metrics"]
