"""IndexBundle of the port against the JAX package's: the same entries
written by each package give files with the same keys, dtypes and arrays,
and each package reads the other's file. Mirrors the bundle cases of
tests/test_indexes.py on the port."""
import json
import pickle

import jax  # noqa: F401  (same process set-up as the other port tests)
import numpy as np
import pytest
import torch

import graph_kmer_index_tpu as jgki
import graph_kmer_index_tpu_torch as tgki
from graph_kmer_index_tpu.containers import Counter as JaxCounter
from graph_kmer_index_tpu_torch.containers import Counter

torch.set_num_threads(2)


def _rows(seed=0, n=600):
    rng = np.random.default_rng(seed)
    kmers = rng.integers(0, 1 << 40, n // 2).astype(np.uint64)
    kmers = np.concatenate([kmers, kmers])
    return (kmers, rng.integers(1, 90, n).astype(np.uint32),
            rng.integers(0, 50, n).astype(np.uint64),
            rng.random(n).astype(np.float32))


def _entries(pkg, rows, **kw):
    flat = pkg.FlatKmers(*rows)
    if pkg is tgki:
        index = pkg.KmerIndex.from_flat_kmers(flat, modulo=211, device="cpu",
                                              **kw)
    else:
        index = pkg.KmerIndex.from_flat_kmers(flat, modulo=211, **kw)
    return {"KmerIndex": index,
            "VariantToNodes": pkg.VariantToNodes(np.array([2, 4]),
                                                 np.array([3, 5])),
            "ReverseKmerIndex": pkg.ReverseKmerIndex.from_flat_kmers(flat),
            "ReferenceKmerIndex": pkg.ReferenceKmerIndex.from_flat_kmers(
                flat),
            "VariantNodesIndex": pkg.VariantNodesIndex(rows[2][:9],
                                                       rows[1][:9]),
            "TrickyVariants": np.array([0, 1, 0])}


def _raw(path):
    with np.load(path) as data:
        arrays = {key: data[key] for key in data.files
                  if key != "__manifest__"}
        manifest = json.loads(bytes(data["__manifest__"]).decode())
    return arrays, manifest


@pytest.mark.parametrize("kw", [{}, dict(skip_frequencies=True),
                                dict(skip_singletons=True)])
@pytest.mark.parametrize("compress", [True, False])
def test_bundle_files_are_equal(tmp_path, kw, compress):
    """Both packages' files: the same keys, the same manifest (class
    names and scalars), the same arrays in the same dtypes."""
    rows = _rows()
    jpath = jgki.IndexBundle(_entries(jgki, rows, **kw)).to_file(
        str(tmp_path / "jax"), compress=compress)
    tpath = tgki.IndexBundle(_entries(tgki, rows, **kw)).to_file(
        str(tmp_path / "port"), compress=compress)
    assert tpath.endswith(".npz")
    (jarrays, jmanifest), (tarrays, tmanifest) = _raw(jpath), _raw(tpath)
    assert tmanifest == jmanifest
    assert tmanifest["KmerIndex"]["class"] == "CollisionFreeKmerIndex"
    assert tmanifest["KmerIndex"]["scalars"] == {"_modulo": 211}
    assert sorted(tarrays) == sorted(jarrays)
    assert "KmerIndex/_kmers" in tarrays
    for key, want in jarrays.items():
        got = tarrays[key]
        assert got.dtype == want.dtype and np.array_equal(got, want), key


def test_each_package_reads_the_others_bundle(tmp_path):
    rows = _rows(1)
    jentries, tentries = _entries(jgki, rows), _entries(tgki, rows)
    jpath = jgki.IndexBundle(jentries).to_file(str(tmp_path / "jax"))
    tpath = tgki.IndexBundle(tentries).to_file(str(tmp_path / "port"))
    from_jax = tgki.IndexBundle.from_file(jpath, device="cpu")
    from_port = jgki.IndexBundle.from_file(tpath)
    # the port's reader: a KmerIndex of the port on the named device
    served = from_jax["KmerIndex"]
    assert isinstance(served, tgki.KmerIndex)
    assert served.device == torch.device("cpu")
    want = jentries["KmerIndex"]
    props = served.to_properties()
    for name in want.properties:
        a, b = np.asarray(props[name]), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    q = np.concatenate([rows[0][:100],
                        np.array([7, 1 << 41], dtype=np.uint64)])
    assert np.array_equal(served.map_kmers(q, 90), want.map_kmers(q, 90))
    assert np.array_equal(served.get_frequencies(q),
                          want.get_frequencies(q))
    assert np.array_equal(served.get_batched(q), want.get_batched(q))
    assert isinstance(from_jax["VariantToNodes"], tgki.VariantToNodes)
    assert list(from_jax["VariantToNodes"].ref_nodes) == [2, 4]
    assert np.array_equal(from_jax["TrickyVariants"], [0, 1, 0])
    # the JAX reader over the port's file
    back = from_port["KmerIndex"]
    assert isinstance(back, jgki.CollisionFreeKmerIndex)
    for name in want.properties:
        a, b = np.asarray(getattr(back, name)), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert np.array_equal(back.map_kmers(q, 90), want.map_kmers(q, 90))
    assert list(from_port["VariantToNodes"].var_nodes) == [3, 5]
    # classes the bundle does not know come back as namespaces of their
    # arrays, in both packages
    for name in ("ReverseKmerIndex", "ReferenceKmerIndex",
                 "VariantNodesIndex"):
        for prop in tentries[name].properties:
            want_prop = getattr(jentries[name], prop)
            for loaded in (from_jax, from_port):
                got = getattr(loaded[name], prop)
                assert got.dtype == want_prop.dtype
                assert np.array_equal(got, want_prop), (name, prop)


def test_index_bundle(tmp_path):
    flat = tgki.FlatKmers(np.array([5, 9], dtype=np.uint64), np.array([1, 2]))
    idx = tgki.KmerIndex.from_flat_kmers(flat, modulo=101, device="cpu")
    bundle = tgki.IndexBundle({"KmerIndex": idx, "TrickyVariants": [1, 2, 3]})
    f = str(tmp_path / "bundle.pkl")
    bundle.to_file(f)
    b2 = tgki.IndexBundle.from_file(f, device="cpu")
    assert "KmerIndex" in b2
    assert list(b2["KmerIndex"].get(5)[0]) == [1]
    b3 = tgki.IndexBundle.from_file(f, skip=["TrickyVariants"], device="cpu")
    assert "TrickyVariants" not in b3
    b3["Extra"] = np.arange(3)
    assert "Extra" in b3
    with pytest.raises(FileNotFoundError):
        tgki.IndexBundle.from_file(str(tmp_path / "missing"), device="cpu")


def test_index_bundle_foreign_npz(tmp_path):
    np.savez(str(tmp_path / "foreign.npz"),
             **{"VariantToNodes/ref_nodes": np.array([1, 2]),
                "VariantToNodes/var_nodes": np.array([3, 4]),
                "Mystery/data": np.array([7.0]), "flat": np.arange(4)})
    b = tgki.IndexBundle.from_file(str(tmp_path / "foreign.npz"),
                                   device="cpu")
    assert list(b["VariantToNodes"].ref_nodes) == [1, 2]
    assert b["Mystery"].data[0] == 7.0
    assert list(b["flat"]) == [0, 1, 2, 3]


def test_index_bundle_nested_counter_roundtrip(tmp_path):
    """Object-valued properties (CounterKmerIndex's Counter) decompose one
    level deep; either package reads the other's entry."""
    kmers = np.array([3, 7, 9], np.uint64)
    nodes = np.array([1, 2, 3], np.uint32)
    tcki = tgki.CounterKmerIndex(kmers, nodes,
                                 Counter(kmers, values=np.array([5, 6, 7])))
    jcki = jgki.CounterKmerIndex(
        kmers, nodes, JaxCounter(kmers, values=np.array([5, 6, 7])))
    tpath = tgki.IndexBundle({"KmerIndex": tcki}).to_file(
        str(tmp_path / "port"))
    jpath = jgki.IndexBundle({"KmerIndex": jcki}).to_file(
        str(tmp_path / "jax"))
    (jarrays, jmanifest), (tarrays, tmanifest) = _raw(jpath), _raw(tpath)
    assert tmanifest == jmanifest and sorted(tarrays) == sorted(jarrays)
    for path in (tpath, jpath):
        loaded = tgki.IndexBundle.from_file(path, device="cpu")["KmerIndex"]
        assert isinstance(loaded, tgki.CounterKmerIndex)
        assert list(loaded.counter[np.array([3, 7, 9])]) == [5, 6, 7]
    loaded = jgki.IndexBundle.from_file(tpath)["KmerIndex"]
    assert list(loaded.counter[np.array([3, 7, 9])]) == [5, 6, 7]


def test_index_with_tensor_columns_is_moved_to_the_host(tmp_path):
    """An index built from tensors (a device finalize's rows) holds every
    column as a tensor; the bundle stores the host arrays in the file's
    dtypes, uint64 k-mers and ref offsets among them."""
    rows = _rows(2)
    flat = tgki.FlatKmers(torch.from_numpy(rows[0].view(np.int64)),
                          torch.from_numpy(rows[1].astype(np.int32)),
                          torch.from_numpy(rows[2].view(np.int64)),
                          torch.from_numpy(rows[3]))
    idx = tgki.KmerIndex.from_flat_kmers(flat, modulo=211, device="cpu")
    path = tgki.IndexBundle({"KmerIndex": idx}).to_file(str(tmp_path / "b"))
    arrays, _ = _raw(path)
    assert arrays["KmerIndex/_kmers"].dtype == np.uint64
    assert arrays["KmerIndex/_ref_offsets"].dtype == np.uint64
    assert arrays["KmerIndex/_n_kmers"].dtype == np.uint32
    assert arrays["KmerIndex/_frequencies"].dtype == np.uint16
    assert arrays["KmerIndex/_nodes"].dtype == np.int32
    loaded = jgki.IndexBundle.from_file(path)["KmerIndex"]
    assert loaded.has_kmers(rows[0][:16]).all()
    assert not loaded.has_kmers(np.array([999999999], np.uint64))[0]


def test_removed_columns_and_scalar_only_entries(tmp_path):
    rows = _rows(3)
    jidx, tidx = _entries(jgki, rows)["KmerIndex"], \
        _entries(tgki, rows)["KmerIndex"]
    for idx in (jidx, tidx):
        idx.remove_ref_offsets()
        idx.remove_frequencies()
    jpath = jgki.IndexBundle({"KmerIndex": jidx}).to_file(
        str(tmp_path / "jax"))
    tpath = tgki.IndexBundle({"KmerIndex": tidx}).to_file(
        str(tmp_path / "port"))
    (jarrays, jmanifest), (tarrays, tmanifest) = _raw(jpath), _raw(tpath)
    assert tmanifest == jmanifest
    for key, want in jarrays.items():
        assert np.array_equal(tarrays[key], want), key
    back = tgki.IndexBundle.from_file(jpath, device="cpu")["KmerIndex"]
    assert np.array_equal(back.map_kmers(rows[0], 90),
                          jidx.map_kmers(rows[0], 90))


def test_pickle_bundles_are_read_inside_one_package(tmp_path):
    """The legacy pickle form names its classes' modules: the port reads
    what the port pickled."""
    path = tmp_path / "legacy"
    with open(path, "wb") as f:
        pickle.dump({"VariantToNodes": tgki.VariantToNodes(
            np.array([2]), np.array([3])), "x": np.arange(3)}, f)
    loaded = tgki.IndexBundle.from_file(str(path), skip=["x"], device="cpu")
    assert list(loaded["VariantToNodes"].ref_nodes) == [2]
    assert "x" not in loaded
