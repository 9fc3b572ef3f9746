"""Port parity: the driver entry points (graph_kmer_index_tpu_torch/entry.py)
against the JAX package's __graft_entry__.py.

entry()'s forward on the CPU (K1's plain twin, the CSR scan) must give
the JAX forward's int32 node counts exactly, on the same seeded toy
index and reads; the multi-rank dry run must pass on gloo ranks."""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import __graft_entry__ as jentry  # noqa: E402
from graph_kmer_index_tpu_torch import entry as tentry  # noqa: E402

torch.set_num_threads(2)


def test_toy_setup_equals_jax():
    """The same graph, index rows and reads, draw for draw."""
    jindex, jn_nodes, jreads, _ = jentry._toy_setup(31)
    index, n_nodes, reads, _ = tentry.toy_setup(31, "cpu")
    assert n_nodes == jn_nodes
    assert np.array_equal(reads, jreads)
    assert np.array_equal(index.kmers.numpy().view(np.uint64),
                          np.asarray(jindex._kmers, np.uint64))
    assert np.array_equal(index.nodes.numpy(), np.asarray(jindex._nodes))


def test_entry_forward_equals_jax():
    jfn, (jreads,) = jentry.entry()
    want = np.asarray(jax.jit(jfn)(jnp.asarray(jreads)))
    fn, (reads,) = tentry.entry(device="cpu")
    assert reads.device.type == "cpu"
    got = fn(reads)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert want.sum() > 0


@pytest.mark.parametrize("n_devices", [2, 4])
def test_dryrun_multichip_on_gloo_ranks(n_devices):
    launches = tentry.dryrun_multichip(n_devices, device="cpu", timeout=300)
    assert set(launches) >= {"sliding_hash", "packed_lookup"}
    assert not any(launches.values())  # CPU tensors take the plain twins


def test_dryrun_rank_failure_raises(monkeypatch):
    """A rank that fails fails the call, with its log: here every rank
    runs a module that does not exist."""
    monkeypatch.setattr(tentry, "__name__", "graph_kmer_index_tpu_torch.no")
    with pytest.raises(RuntimeError, match=r"rank \d failed"):
        tentry.dryrun_multichip(2, device="cpu", timeout=120)
