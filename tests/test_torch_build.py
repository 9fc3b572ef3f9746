"""Port parity: graph_kmer_index_tpu_torch.ops.build and
KmerIndex.from_flat_kmers / to_file against the JAX package's device and
host builds (tests/test_device_build.py's cases). Exact equality."""
import jax  # noqa: F401  (same process set-up as the other port tests)
import numpy as np
import pytest
import torch

from graph_kmer_index_tpu import CollisionFreeKmerIndex
from graph_kmer_index_tpu import FlatKmers as JaxFlatKmers
from graph_kmer_index_tpu.ops import build as jax_build

from graph_kmer_index_tpu_torch import FlatKmers, KmerIndex
from graph_kmer_index_tpu_torch.ops import build, lookup

torch.set_num_threads(2)

_COLUMNS = (("kmers", "_kmers"), ("nodes", "_nodes"),
            ("ref_offsets", "_ref_offsets"), ("frequencies", "_frequencies"),
            ("allele_frequencies", "_allele_frequencies"),
            ("hashes_to_index", "_hashes_to_index"), ("n_kmers", "_n_kmers"))


def _random_columns(n=5000, seed=0):
    rng = np.random.default_rng(seed)
    # heavy collisions: draw kmers from a small space
    return (rng.integers(0, 2000, n).astype(np.uint64),
            rng.integers(1, 500, n).astype(np.uint32),
            rng.integers(0, 3000, n).astype(np.uint64),
            rng.random(n).astype(np.single))


def _tensor_flat(cols):
    """The columns as a device finalize leaves them."""
    return FlatKmers(torch.from_numpy(cols[0].view(np.int64)),
                     torch.from_numpy(cols[1].astype(np.int32)),
                     torch.from_numpy(cols[2].view(np.int64)),
                     torch.from_numpy(cols[3]))


def _assert_index_equal(port, ref):
    for name, attr in _COLUMNS:
        got, want = port._file_column(name), np.asarray(getattr(ref, attr))
        assert np.array_equal(got, want), name
        if name not in ("nodes", "n_kmers", "hashes_to_index"):
            assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
    assert port.modulo == ref._modulo


@pytest.mark.parametrize("columns", ["numpy", "tensors"])
@pytest.mark.parametrize("jax_route", ["host", "device"])
def test_from_flat_kmers_matches_jax_builds(columns, jax_route):
    cols = _random_columns()
    ref = CollisionFreeKmerIndex.from_flat_kmers(
        JaxFlatKmers(*cols), modulo=997, use_device=jax_route == "device")
    flat = FlatKmers(*cols) if columns == "numpy" else _tensor_flat(cols)
    port = KmerIndex.from_flat_kmers(flat, modulo=997, device="cpu")
    _assert_index_equal(port, ref)
    assert port.dtypes["ref_offsets"] == np.uint64
    assert port.dtypes["frequencies"] == np.uint16


def test_build_queries_match():
    cols = _random_columns(seed=3)
    ref = CollisionFreeKmerIndex.from_flat_kmers(JaxFlatKmers(*cols),
                                                 modulo=211,
                                                 use_device=True)
    port = KmerIndex.from_flat_kmers(_tensor_flat(cols), modulo=211,
                                     device="cpu")
    for kmer in np.unique(cols[0])[:50]:
        want = ref.get(int(kmer), max_hits=10 ** 9)
        got = port.get(int(kmer), max_hits=10 ** 9)
        for g, w in zip(got, want, strict=True):
            assert np.array_equal(g, np.asarray(w))
        assert got[1].dtype == np.uint64
    q = np.concatenate([cols[0][:900], np.arange(5000, 5100, dtype=np.uint64)])
    assert np.array_equal(port.map_kmers(q, 500),
                          np.asarray(ref.map_kmers(q, 500), dtype=np.int64))
    assert np.array_equal(port.get_batched(q), ref.get_batched(q))


def test_build_empty():
    empty = (np.zeros(0, np.uint64), np.zeros(0, np.uint32),
             np.zeros(0, np.uint64), np.zeros(0, np.single))
    for flat in (FlatKmers(*empty), _tensor_flat(empty)):
        port = KmerIndex.from_flat_kmers(flat, modulo=101, device="cpu")
        assert port.get(5)[0] is None
        assert port.hashes_to_index.shape == (101,)
        assert not port.has_kmers(np.array([5], np.uint64)).any()


@pytest.mark.parametrize("columns", ["numpy", "tensors"])
@pytest.mark.parametrize("skip_frequencies", [False, True])
def test_skip_singletons(columns, skip_frequencies):
    """skip_singletons drops each hash's first occurrence, then adds 1 to
    all frequencies."""
    cols = _random_columns(2000, seed=9)
    ref = CollisionFreeKmerIndex.from_flat_kmers(
        JaxFlatKmers(*cols), modulo=499, skip_singletons=True,
        skip_frequencies=skip_frequencies, use_device=False)
    flat = FlatKmers(*cols) if columns == "numpy" else _tensor_flat(cols)
    port = KmerIndex.from_flat_kmers(flat, modulo=499, skip_singletons=True,
                                     skip_frequencies=skip_frequencies,
                                     device="cpu")
    _assert_index_equal(port, ref)
    u, c = np.unique(cols[0], return_counts=True)
    gone = set(u[c == 1].tolist())
    assert not set(port._file_column("kmers").tolist()) & gone
    assert int(port.frequencies.min()) >= 1


def test_frequencies_wide_ref_offsets():
    """Offsets past 2^32 stay distinct in the frequency count: the port's
    int64 sort has no narrow key to alias them."""
    offs = np.array([5, 5 + (1 << 32), 5, 9], dtype=np.uint64)
    kmers = np.array([7, 7, 7, 11], dtype=np.uint64)
    got = build.frequencies_device(kmers, offs, device="cpu")
    assert got.dtype == np.uint16 and got.tolist() == [2, 2, 2, 1]
    assert np.array_equal(got, jax_build.frequencies_device(kmers, offs))
    small = (np.array([3, 3, 4], dtype=np.uint64),
             np.array([1, 2, 1], dtype=np.uint64))
    assert build.frequencies_device(*small, device="cpu").tolist() == [2, 2, 1]
    rng = np.random.default_rng(1)
    kmers = rng.integers(0, 300, 4000).astype(np.uint64)
    offs = (rng.integers(0, 6, 4000).astype(np.uint64) << np.uint64(31))
    assert np.array_equal(build.frequencies_device(kmers, offs, device="cpu"),
                          jax_build.frequencies_device(kmers, offs))
    assert len(build.frequencies_device(kmers[:0], offs[:0],
                                        device="cpu")) == 0


@pytest.mark.parametrize("modulo", [211, 4099])
def test_build_modulo_layout_device_matches_jax(modulo):
    cols = _random_columns(seed=5)
    want = jax_build.build_modulo_layout_device(cols[0], modulo, list(cols))
    for hashes in (cols[0], torch.from_numpy(cols[0].view(np.int64))):
        got = build.build_modulo_layout_device(hashes, modulo, list(cols),
                                               device="cpu")
        assert got[0].dtype == got[1].dtype == torch.int32
        for g, w in zip((got[0], got[1], got[3]),
                        (want[0], want[1], want[3]), strict=True):
            assert np.array_equal(g.numpy(), np.asarray(w))
        # unsigned columns are int64 tensors: uint64 by its bits, uint32
        # widened
        for g, w in zip(got[2], want[2], strict=True):
            w = np.asarray(w)
            g = g.numpy()
            g = g.view(w.dtype) if g.itemsize == w.itemsize else g.astype(
                w.dtype)
            assert np.array_equal(g, w)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_index_files_cross_packages(tmp_path, writer):
    cols = _random_columns(seed=7)
    ref = CollisionFreeKmerIndex.from_flat_kmers(JaxFlatKmers(*cols),
                                                 modulo=997,
                                                 use_device=False)
    port = KmerIndex.from_flat_kmers(_tensor_flat(cols), modulo=997,
                                     device="cpu")
    q = np.concatenate([cols[0][:500], np.arange(3000, 3050, dtype=np.uint64)])
    if writer == "port":
        port.to_file(tmp_path / "index")
        back = CollisionFreeKmerIndex.from_file(tmp_path / "index")
        for _, attr in _COLUMNS:
            assert np.array_equal(np.asarray(getattr(back, attr)),
                                  np.asarray(getattr(ref, attr))), attr
        assert back._kmers.dtype == np.uint64
        assert back._n_kmers.dtype == np.uint32
        assert back._frequencies.dtype == np.uint16
        assert np.array_equal(back.get_batched(q), ref.get_batched(q))
    else:
        ref.to_file(tmp_path / "index")
        back = KmerIndex.from_file(tmp_path / "index", device="cpu")
        _assert_index_equal(back, ref)
        assert np.array_equal(back.get_batched(q), port.get_batched(q))
        # and written again it is the same file content
        back.to_file(tmp_path / "again")
        with np.load(tmp_path / "index.npz") as a, \
                np.load(tmp_path / "again.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for key in a.files:
                assert a[key].dtype == b[key].dtype, key
                assert np.array_equal(a[key], b[key]), key


def test_tables_left_on_the_device_serve_get_batched():
    """An index built on a device has its bucket tables there as tensors:
    get_batched takes them whatever the transfer budget says."""
    cols = _random_columns(seed=2)
    port = KmerIndex.from_flat_kmers(_tensor_flat(cols), modulo=997,
                                     device="cpu")
    view = lookup.DeviceKmerIndex(port)
    view.BUCKET_TABLE_BYTE_BUDGET = 0
    assert view._bucket_tables_cheap()
    loaded = KmerIndex.from_arrays(
        port.kmers, port.nodes, 997, "cpu",
        ref_offsets=port._file_column("ref_offsets"),
        frequencies=port._file_column("frequencies"),
        allele_frequencies=port._file_column("allele_frequencies"),
        hashes_to_index=port._file_column("hashes_to_index"),
        n_kmers=port._file_column("n_kmers"))
    host_view = lookup.DeviceKmerIndex(loaded)
    host_view.BUCKET_TABLE_BYTE_BUDGET = 0
    assert not host_view._bucket_tables_cheap()
    q = torch.from_numpy(cols[0][:700].view(np.int64))
    assert torch.equal(view.get_batched(q), host_view.get_batched(q))
    assert "starts_tbl" in view._cache and "starts_tbl" not in host_view._cache
