"""Port parity for the build slice as a whole: the pooled find
(find_kmers_parallel), its device-finalized twin
(find_kmers_parallel_device, on the CPU device here: K1's plain twin), the
index built from its rows and the read counts, against the JAX package on
the same graphs (tests/test_device_pipeline.py's pipeline cases). Exact
equality."""
import jax  # noqa: F401  (same process set-up as the other port tests)
import numpy as np
import pytest
import torch

from graph_kmer_index_tpu import CollisionFreeKmerIndex
from graph_kmer_index_tpu import Graph as JaxGraph
from graph_kmer_index_tpu.parallel import host_pool as jax_host_pool
from graph_kmer_index_tpu.utils.synthetic import (
    random_snp_graph as jax_random_snp_graph)

from graph_kmer_index_tpu_torch import Graph, KmerIndex
from graph_kmer_index_tpu_torch.flat_kmers import host_column, is_tensor
from graph_kmer_index_tpu_torch.parallel import host_pool, proc_pool
from graph_kmer_index_tpu_torch.utils.synthetic import random_snp_graph

torch.set_num_threads(2)

_COLUMNS = ("_hashes", "_nodes", "_ref_offsets", "_allele_frequencies")
_TOY = ({1: "ACTGACTGTCTAGGACTGAC", 2: "A", 3: "G", 4: "CCCTACTGTTTAGTCA"},
        {1: [2, 3], 2: [4], 3: [4]}, [1, 2, 4])


def _assert_flat_equal(got, want, same_dtypes=None):
    """A port FlatKmers (numpy or tensor columns) against a JAX-package
    one, bit for bit; host rows also in the dtypes (device rows carry
    int32 nodes in both packages, host rows uint32)."""
    if same_dtypes is None:
        same_dtypes = not is_tensor(got._hashes)
    for col in _COLUMNS:
        a = host_column(getattr(got, col), unsigned=True)
        b = np.asarray(getattr(want, col))
        assert np.array_equal(a, b), col
        if same_dtypes:
            assert a.dtype == b.dtype, (col, a.dtype, b.dtype)


def _both(graphs, k, n_workers, **kwargs):
    """(port host, port device, JAX host, JAX device) finds."""
    graph, jax_graph = graphs
    return (host_pool.find_kmers_parallel(graph, k, n_workers=n_workers),
            host_pool.find_kmers_parallel_device(
                graph, k, n_workers=n_workers, device="cpu", **kwargs),
            jax_host_pool.find_kmers_parallel(jax_graph, k,
                                              n_workers=n_workers),
            jax_host_pool.find_kmers_parallel_device(
                jax_graph, k, n_workers=n_workers, **kwargs))


def _random_graphs(n_bases, n_variants, seed, indel_fraction=0.0):
    return (random_snp_graph(n_bases, n_variants, seed=seed,
                             indel_fraction=indel_fraction)[0],
            jax_random_snp_graph(n_bases, n_variants, seed=seed,
                                 indel_fraction=indel_fraction)[0])


def test_device_pipeline_matches_host_toy():
    graphs = Graph.from_dicts(*_TOY), JaxGraph.from_dicts(*_TOY)
    host, dev, jax_host, jax_dev = _both(graphs, 5, 1)
    _assert_flat_equal(host, jax_host)
    _assert_flat_equal(dev, jax_host)
    # the device rows: tensors, with the JAX device rows' int32 nodes
    assert all(is_tensor(getattr(dev, col)) for col in _COLUMNS)
    _assert_flat_equal(dev, jax_dev, same_dtypes=False)
    assert dev._hashes.dtype == dev._ref_offsets.dtype == torch.int64
    assert dev._nodes.dtype == torch.int32
    assert dev._allele_frequencies.dtype == torch.float32


@pytest.mark.parametrize("seed", range(8))
def test_device_pipeline_matches_host_random(seed):
    graphs = _random_graphs(400, 10, seed, 0.3)
    for k in (4, 7):
        host, dev, jax_host, _ = _both(graphs, k, 2)
        _assert_flat_equal(host, jax_host)
        _assert_flat_equal(dev, jax_host)


@pytest.mark.parametrize("seed", [3, 12])
def test_device_pipeline_streamed_groups_match_host(seed):
    """Tiny stream thresholds force many group expansions; the assembled
    rows stay bit-equal to the host path: order and values."""
    graph, jax_graph = _random_graphs(1500, 25, seed, 0.3)
    want = jax_host_pool.find_kmers_parallel(jax_graph, 7, n_workers=2)
    stats = {}
    dev = host_pool.find_kmers_parallel_device(
        graph, 7, n_workers=2, stream_rows_target=200,
        stream_tape_target=400, device="cpu", stats=stats)
    _assert_flat_equal(dev, want)
    assert stats["groups"] > 3 and len(stats["tape_bases"]) == stats["groups"]
    assert stats["span_rows"] == len(dev) == len(want)
    assert 0 <= stats["flush_seconds"]
    assert stats["first_result_seconds"] > 0


def test_device_pipeline_streamed_matches_unstreamed_device():
    graph, jax_graph = _random_graphs(900, 15, 5)
    kwargs = dict(only_save_one_node_per_kmer=True,
                  only_store_nodes={1, 2, 3, 4, 5, 6, 7, 8, 9, 10})
    stats = {}
    one = host_pool.find_kmers_parallel_device(graph, 6, n_workers=2,
                                               device="cpu", stats=stats,
                                               **kwargs)
    assert stats["groups"] == 1
    streamed = host_pool.find_kmers_parallel_device(
        graph, 6, n_workers=2, stream_rows_target=100,
        stream_tape_target=300, device="cpu", **kwargs)
    want = jax_host_pool.find_kmers_parallel_device(
        jax_graph, 6, n_workers=2, stream_rows_target=100,
        stream_tape_target=300, **kwargs)
    for col in _COLUMNS:
        assert torch.equal(getattr(streamed, col), getattr(one, col))
    _assert_flat_equal(streamed, want, same_dtypes=False)


@pytest.mark.parametrize("filters", ["save_one", "store_nodes"])
def test_device_pipeline_only_save_one_and_store_nodes(filters):
    graph, jax_graph = _random_graphs(300, 8, 3)
    kwargs = ({"only_save_one_node_per_kmer": True} if filters == "save_one"
              else {"only_store_nodes": set(range(1, graph.n_nodes(), 2))})
    want = jax_host_pool.find_kmers_parallel(jax_graph, 5, n_workers=1,
                                             **kwargs)
    _assert_flat_equal(host_pool.find_kmers_parallel(
        graph, 5, n_workers=1, **kwargs), want)
    _assert_flat_equal(host_pool.find_kmers_parallel_device(
        graph, 5, n_workers=1, device="cpu", **kwargs), want)


def test_device_pipeline_index_build_matches():
    graph, jax_graph = _random_graphs(500, 12, 11, 0.2)
    jax_flat = jax_host_pool.find_kmers_parallel(jax_graph, 6, n_workers=2)
    want = CollisionFreeKmerIndex.from_flat_kmers(jax_flat, modulo=211)
    dev_flat = host_pool.find_kmers_parallel_device(graph, 6, n_workers=2,
                                                    device="cpu")
    index = KmerIndex.from_flat_kmers(dev_flat, modulo=211, device="cpu")
    for q in np.unique(np.asarray(jax_flat._hashes))[:50]:
        assert np.array_equal(np.sort(index.get_nodes(int(q))),
                              np.sort(want.get_nodes(int(q))))
        assert int(index.get(int(q), 10 ** 15)[2][0]) == int(
            want.get(int(q), 10 ** 15)[2][0])
    for name, attr in (("kmers", "_kmers"), ("nodes", "_nodes"),
                       ("ref_offsets", "_ref_offsets"),
                       ("frequencies", "_frequencies"),
                       ("hashes_to_index", "_hashes_to_index"),
                       ("n_kmers", "_n_kmers")):
        assert np.array_equal(index._file_column(name),
                              np.asarray(getattr(want, attr))), name


def test_device_pipeline_whitelist_falls_back():
    graph, jax_graph = _random_graphs(250, 6, 5)
    base = jax_host_pool.find_kmers_parallel(jax_graph, 5, n_workers=1)
    wl = set(int(h) for h in np.asarray(base._hashes)[::3])
    want = jax_host_pool.find_kmers_parallel(jax_graph, 5, n_workers=1,
                                             whitelist=wl)
    got = host_pool.find_kmers_parallel_device(graph, 5, n_workers=1,
                                               whitelist=wl, device="cpu")
    assert not is_tensor(got._hashes)  # the row-returning path served it
    _assert_flat_equal(got, want)


@pytest.mark.parametrize("mp_context", [None, "spawn"])
def test_slice_graph_to_read_counts(mp_context):
    """The slice as a whole: graph -> find_kmers_parallel_device ->
    from_flat_kmers -> map_kmers, equal to the JAX package's counts; once
    with spawned workers (the route of a process whose CUDA is live)."""
    k = 9
    graph, jax_graph = _random_graphs(3000, 40, 17, 0.25)
    dev_flat = host_pool.find_kmers_parallel_device(
        graph, k, n_workers=2, mp_context=mp_context,
        stream_rows_target=1500, stream_tape_target=1 << 20, device="cpu",
        require_native=True)
    index = KmerIndex.from_flat_kmers(dev_flat, modulo=1009, device="cpu")
    jax_flat = jax_host_pool.find_kmers_parallel_device(jax_graph, k,
                                                        n_workers=2)
    want = CollisionFreeKmerIndex.from_flat_kmers(jax_flat, modulo=1009)
    refseq = graph.linear_ref_sequence()[2]
    rng = np.random.default_rng(0)
    starts = rng.integers(0, len(refseq) - 60, 200)
    reads = refseq[starts[:, None] + np.arange(60)]
    reads = np.where(rng.random(reads.shape) < 0.02, 3 - reads, reads)
    from graph_kmer_index_tpu_torch.hashing import sliding_window_hashes
    queries = np.concatenate([sliding_window_hashes(r, k) for r in reads])
    n_nodes = graph.n_nodes()
    got = index.map_kmers(queries, n_nodes)
    assert got.sum() > len(queries) // 2
    assert np.array_equal(got, np.asarray(want.map_kmers(queries, n_nodes),
                                          dtype=np.int64))
    assert np.array_equal(index.has_kmers(queries),
                          np.asarray(want.has_kmers(queries)))
    # and through the CSR path over the built bucket tables
    index.device_index.PACKED_BYTE_BUDGET = 0
    index._invalidate_query_caches()
    index.device_index.PACKED_BYTE_BUDGET = 0
    assert np.array_equal(index.map_kmers(queries, n_nodes), got)


def test_plan_chunks_and_merge():
    for n_paths, n_workers, per in ((0, 2, 20), (7, 2, 20), (1000, 4, 20),
                                    (1000, 1, 3)):
        assert (host_pool.plan_chunks(n_paths, n_workers, per)
                == jax_host_pool.plan_chunks(n_paths, n_workers, per))
    graph, jax_graph = _random_graphs(1200, 20, 2, 0.3)
    host_pool._init_worker(graph, 7, None, None, {})
    jax_host_pool._init_worker(jax_graph, 7, None, None, {})
    chunks = host_pool.plan_chunks(20, 1, 4)
    ours = [host_pool._run_chunk_spans(c) for c in chunks]
    theirs = [jax_host_pool._run_chunk_spans(c) for c in chunks]
    for a, b in zip(host_pool._merge_span_results(ours, 7),
                    jax_host_pool._merge_span_results(theirs, 7),
                    strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # a gap in the tape slices is refused
    broken = [ours[0], ours[2]]
    broken[1] = (broken[1][0], broken[1][1] + 1) + tuple(broken[1][2:])
    with pytest.raises(AssertionError, match="not consecutive"):
        host_pool._merge_span_results(broken, 7)


def test_find_checkpoints_resume_and_refuse(tmp_path):
    graph, jax_graph = _random_graphs(1500, 25, 4, 0.3)
    want = jax_host_pool.find_kmers_parallel(jax_graph, 7, n_workers=2)
    first = host_pool.find_kmers_parallel_device(
        graph, 7, n_workers=2, checkpoint_dir=str(tmp_path), device="cpu")
    files = sorted(tmp_path.glob("chunk-*.npz"))
    assert len(files) > 5 and (tmp_path / "meta.json").exists()
    files[1].unlink()
    files[3].write_bytes(b"torn")
    again = host_pool.find_kmers_parallel_device(
        graph, 7, n_workers=1, chunks_per_worker=40,
        checkpoint_dir=str(tmp_path), device="cpu")
    _assert_flat_equal(first, want)
    _assert_flat_equal(again, want)
    with pytest.raises(ValueError, match="different inputs"):
        host_pool.find_kmers_parallel_device(
            graph, 8, n_workers=1, checkpoint_dir=str(tmp_path),
            device="cpu")
    # a chunk file written by the JAX package's pool is read by the port's
    other = tmp_path / "jax"
    jax_host_pool.find_kmers_parallel_device(jax_graph, 7, n_workers=1,
                                             chunks_per_worker=40,
                                             checkpoint_dir=str(other))
    stats = {}
    resumed = host_pool.find_kmers_parallel_device(
        graph, 7, n_workers=1, chunks_per_worker=40,
        checkpoint_dir=str(other), device="cpu", stats=stats)
    _assert_flat_equal(resumed, want)


def test_subprocess_pool_and_map_over_chunks():
    env = proc_pool._worker_env()
    assert env["CUDA_VISIBLE_DEVICES"] == ""
    assert env["PYTHONPATH"].split(":")[0] == str(
        __import__("pathlib").Path(proc_pool.__file__).resolve().parents[2])
    with proc_pool.SubprocessPool(2) as pool:
        got = dict(pool.imap_unordered(len, [(i, "x" * i)
                                             for i in range(7)]))
    assert got == {i: i for i in range(7)}
    # a worker has the package's host layer and no torch: its start-up is
    # an interpreter and numpy
    probe = ("[name in __import__('sys').modules for name in ('torch', "
             "'graph_kmer_index_tpu_torch.finder', 'numpy')]")
    with proc_pool.SubprocessPool(1, initializer=host_pool._init_worker,
                                  initargs=(None, 5, None, None, {})) as pool:
        assert list(pool.imap_unordered(eval, [(0, probe)])) == [
            (0, [False, True, True])]
    with proc_pool.SubprocessPool(1) as pool:
        with pytest.raises(RuntimeError, match="pool worker failed"):
            list(pool.imap_unordered(int, [("bad", "not a number")]))
    assert host_pool.map_over_chunks(len, ["a", "bb", ""], 1) == [1, 2, 0]
    assert host_pool.map_over_chunks(len, ["a", "bb", ""], 2) == [1, 2, 0]
    assert not host_pool._accelerator_backend_live()


def test_require_native_refuses_the_python_walker(monkeypatch):
    from graph_kmer_index_tpu_torch import native
    graph, _ = _random_graphs(300, 6, 1)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    flat = host_pool.find_kmers_parallel_device(graph, 5, n_workers=1,
                                                device="cpu")
    assert len(flat) > 100  # the Python walker and the numpy finalize
    with pytest.raises(RuntimeError, match="native span walker was required"):
        host_pool.find_kmers_parallel_device(graph, 5, n_workers=1,
                                             device="cpu",
                                             require_native=True)
