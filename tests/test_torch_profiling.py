"""Port parity: graph_kmer_index_tpu_torch/utils/profiling.py against the
JAX package's utils/profiling.py."""
import json
import os

import numpy as np
import pytest
import torch

import graph_kmer_index_tpu as jgki
from graph_kmer_index_tpu.utils import profiling as jprof
from graph_kmer_index_tpu_torch.utils import profiling as tprof

TOY = ({1: "ACTGACTGTCTAGGACTGAC", 2: "A", 3: "G", 4: "CCCTACTGTTTAGTCA"},
       {1: [2, 3], 2: [4], 3: [4]}, [1, 2, 4])


def test_timings_equal_jax():
    """The same spans, in the same order, summed the same way; the same
    report for the same seconds."""
    jt, tt = jprof.Timings(), tprof.Timings()
    for name in ("find", "build", "find", "map"):
        for timings in (jt, tt):
            with timings.span(name):
                pass
    assert list(tt.spans) == list(jt.spans) == ["find", "build", "map"]
    seconds = dict(zip(["find", "build", "map"],
                       np.random.default_rng(0).random(3) * 10))
    jt.spans, tt.spans = dict(seconds), dict(seconds)
    assert tt.report() == jt.report()
    assert tprof.Timings().report() == jprof.Timings().report()


def test_timings_span_records_on_error():
    t = tprof.Timings()
    with pytest.raises(ValueError):
        with t.span("failing"):
            raise ValueError
    assert "failing" in t.spans


def test_device_trace_writes_a_trace(tmp_path):
    with tprof.device_trace(str(tmp_path / "traces")) as trace:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.dirname(trace.path) == str(tmp_path / "traces")
    with open(trace.path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


@pytest.mark.parametrize("k", [3, 5])
def test_profile_dense_finder_runs(tmp_path, k):
    path = str(tmp_path / "graph")
    jgki.Graph.from_dicts(*TOY).to_file(path)
    seconds = tprof.profile_dense_finder(path + ".npz", k=k, device="cpu")
    assert seconds >= 0.0
    assert jprof.profile_dense_finder(path + ".npz", k=k) >= 0.0
