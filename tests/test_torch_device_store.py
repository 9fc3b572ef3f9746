"""Port parity: the device-resident object store
(graph_kmer_index_tpu_torch/parallel/device_store.py), mirroring
tests/test_device_store.py on the CPU device: tensors of the arrays'
dtypes, rebuilt into the class with no copy."""
import jax  # noqa: F401  (same process set-up as the other port tests)
import numpy as np
import pytest
import torch

from graph_kmer_index_tpu_torch import Graph
from graph_kmer_index_tpu_torch.parallel.device_store import (
    SingleSharedArray, free, free_all, from_device_memory, to_device_memory)


def test_graph_roundtrip():
    graph = Graph.from_dicts(
        {1: "ACTG", 2: "A", 3: "G", 4: "AAAT"},
        {1: [2, 3], 2: [4], 3: [4]}, [1, 2, 4])
    to_device_memory(graph, "g1", device="cpu")
    g2 = from_device_memory(Graph, "g1")
    assert isinstance(g2.node_sizes, torch.Tensor)
    assert g2.sequence.dtype == torch.from_numpy(graph.sequence).dtype
    assert np.array_equal(np.asarray(g2.node_sizes),
                          np.asarray(graph.node_sizes))
    assert g2.get_node_sequence(1) == "actg"
    free("g1")


def test_free_all():
    graph = Graph.from_dicts({1: "ACTG"}, {}, [1])
    to_device_memory(graph, "tmp", device="cpu")
    free_all()
    with pytest.raises(KeyError):
        from_device_memory(Graph, "tmp")


def test_single_shared_array_roundtrip():
    a = np.arange(17, dtype=np.int64)
    to_device_memory(SingleSharedArray(a), "t_ssa", device="cpu")
    back = from_device_memory(SingleSharedArray, "t_ssa")
    assert back.array.device.type == "cpu"
    assert np.array_equal(back.array.numpy(), a)
    free("t_ssa")


def test_default_device_is_the_card():
    """An entry point runs on the card unless the caller asks for the
    CPU: without a CUDA device the default raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        to_device_memory(SingleSharedArray(np.arange(3)), "t_cuda")


def test_shared_pool_roundtrip():
    from graph_kmer_index_tpu_torch.parallel.host_pool import (
        close_shared_pool, get_shared_pool)
    pool = get_shared_pool(2)
    assert pool is get_shared_pool(2)  # process-wide: same object
    try:
        assert sorted(pool.map(abs, [-3, 1, -2])) == [1, 2, 3]
    finally:
        close_shared_pool()
