"""Port parity for the CSR lookup slice: the bucket layout, frequencies,
the CSR map/has path, ``get_batched`` through both range routes and the
``get`` API of graph_kmer_index_tpu_torch against the JAX package's
CollisionFreeKmerIndex and DeviceKmerIndex, on the CPU. Every comparison
is exact.

The table is the adversarial one of tests/test_indexes.py
(test_all_lookup_backends_agree_on_adversarial_table): dup2 buckets,
deep buckets, an ultra-deep bucket of k-mer 0, the largest 62-bit k-mer
and bucket-0 k-mers; here with random allele frequencies and ref offsets
that repeat within a k-mer, at the modulo 101 and at a modulo above the
row count."""
import functools

import jax  # noqa: F401  (same process set-up as the other port tests)
import numpy as np
import pytest
import torch

from graph_kmer_index_tpu.flat_kmers import FlatKmers
from graph_kmer_index_tpu.models import kmer_index as jax_models
from graph_kmer_index_tpu.models.kmer_index import CollisionFreeKmerIndex
from graph_kmer_index_tpu.ops.lookup import DeviceKmerIndex as JaxDevice
from graph_kmer_index_tpu.ops.lookup import SCAN_CAP
from graph_kmer_index_tpu_torch import KmerIndex
from graph_kmer_index_tpu_torch.models import kmer_index as port_models
from graph_kmer_index_tpu_torch.ops import lookup as port_lookup

torch.set_num_threads(2)

MODULOS = (101, 10007)  # 10007 > the 4,429 rows
CAPS_OFF = (1 << 31) - 1
CAPS = {"default": (10000, 20), "off": (CAPS_OFF, CAPS_OFF),
        "tight": (40, 3)}


def _rows():
    rng = np.random.default_rng(99)
    kmers = rng.integers(1, 1 << 50, 4000).astype(np.uint64)
    dup2 = rng.integers(1, 1 << 50, 30).astype(np.uint64)
    deep = np.repeat(rng.integers(1, 1 << 50, 10).astype(np.uint64), 5)
    ultra = np.repeat(np.uint64(0), SCAN_CAP + 40)        # kmer 0, ultra
    edge = np.array([4 ** 31 - 1, 101, 202], dtype=np.uint64)  # max, b0s
    kmers = np.concatenate([kmers, dup2, dup2, deep, ultra, edge])
    n = len(kmers)
    nodes = rng.integers(1, 300, n).astype(np.uint32)
    # offsets repeat inside the ultra and deep k-mers' rows
    ref_offsets = rng.integers(0, 3000, n).astype(np.uint64)
    afs = rng.random(n).astype(np.float32)
    return kmers, nodes, ref_offsets, afs


@functools.cache
def _indexes(modulo):
    kmers, nodes, ref_offsets, afs = _rows()
    jax_index = CollisionFreeKmerIndex.from_flat_kmers(
        FlatKmers(kmers, nodes, ref_offsets, afs), modulo=modulo)
    return jax_index, (kmers, nodes, ref_offsets, afs)


def _port(modulo):
    return KmerIndex.from_rows(*_indexes(modulo)[1], modulo, device="cpu")


def _queries(modulo):
    kmers = _rows()[0]
    rng = np.random.default_rng(modulo)
    return np.concatenate([
        kmers[rng.integers(0, len(kmers), 2000)],                # hits
        rng.integers(1 << 51, 1 << 60, 600).astype(np.uint64),   # misses
        kmers[rng.integers(0, len(kmers), 300)]                  # misses in
        + np.uint64(modulo) * rng.integers(1, 99, 300).astype(np.uint64),
        np.array([0, 4 ** 31 - 1, 101, 202, 0], dtype=np.uint64)])


def _tensor(q):
    return torch.from_numpy(q.view(np.int64))


# -- layout, frequencies, columns ---------------------------------------------------

@pytest.mark.parametrize("modulo", MODULOS)
def test_from_rows_layout_is_the_jax_packages(modulo):
    jax_index, _ = _indexes(modulo)
    port = _port(modulo)
    assert port.modulo == modulo
    assert np.array_equal(port.kmers.numpy().view(np.uint64),
                          jax_index._kmers)
    for name, jax_col in (("nodes", jax_index._nodes),
                          ("ref_offsets", jax_index._ref_offsets),
                          ("allele_frequencies",
                           jax_index._allele_frequencies),
                          ("hashes_to_index", jax_index._hashes_to_index),
                          ("n_kmers", jax_index._n_kmers),
                          ("frequencies", jax_index._frequencies)):
        col = getattr(port, name).numpy()
        assert np.array_equal(col, np.asarray(jax_col)), name
    assert port.hashes_to_index.dtype == torch.int32
    assert jax_index._hashes_to_index.dtype == np.int32
    # the frequencies wrap the way the JAX package's uint16 column does
    assert port.dtypes["frequencies"] == jax_index._frequencies.dtype
    assert port.dtypes["nodes"] == jax_index._nodes.dtype
    assert port.device_index.max_scan == int(jax_index._n_kmers.max())
    assert port.device_index.max_scan > SCAN_CAP


def test_from_rows_skip_frequencies():
    rows = _indexes(101)[1]
    want = CollisionFreeKmerIndex.from_flat_kmers(
        FlatKmers(*rows), modulo=101, skip_frequencies=True)
    port = KmerIndex.from_rows(*rows, 101, device="cpu",
                               skip_frequencies=True)
    assert not port.frequencies.any() and not want._frequencies.any()
    assert port.frequencies.shape == want._frequencies.shape
    q = _queries(101)
    assert np.array_equal(port.get_batched(q), want.get_batched(q))


@pytest.mark.parametrize("n,modulo", [(0, 7), (1, 7), (3000, 13),
                                      (3000, 4099)])
def test_build_modulo_layout_is_bit_identical(n, modulo):
    rng = np.random.default_rng(n + modulo)
    kmers = rng.integers(0, 1 << 40, n).astype(np.uint64)
    nodes = rng.integers(0, 50, n).astype(np.uint32)
    hashes = kmers % np.uint64(modulo)
    lookup, n_kmers, (ks, ns), sorting = jax_models._build_modulo_layout(
        hashes, modulo, [kmers, nodes])
    starts, sizes, (pks, pns), psorting = port_models.build_modulo_layout(
        _tensor(hashes), modulo, [_tensor(kmers),
                                  torch.from_numpy(nodes.astype(np.int64))])
    assert starts.dtype == torch.int32 and lookup.dtype == np.int32
    assert np.array_equal(starts.numpy(), lookup)
    assert np.array_equal(sizes.numpy().view(np.uint32), n_kmers)
    assert np.array_equal(pks.numpy().view(np.uint64), ks)
    assert np.array_equal(pns.numpy(), ns.astype(np.int64))
    assert np.array_equal(psorting.numpy(), sorting)


@pytest.mark.parametrize("case", ["random", "wrap"])
def test_set_frequencies_matches_jax(case):
    rng = np.random.default_rng(4)
    kmers = np.sort(rng.integers(0, 60, 5000)).astype(np.uint64)
    offsets = rng.integers(0, 40, 5000).astype(np.uint64)
    if case == "wrap":
        # one k-mer at 65,537 distinct offsets: its frequency wraps to 1
        kmers = np.concatenate([kmers, np.full(65537, 77, np.uint64)])
        offsets = np.concatenate([offsets,
                                  np.arange(65537, dtype=np.uint64)])
    want = jax_models._frequencies_by_distinct_ref_offsets(kmers, offsets)
    got = port_models.frequencies_by_distinct_ref_offsets(
        _tensor(kmers), _tensor(offsets))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    if case == "wrap":
        assert int(got[-1]) == 1
    assert port_models.frequencies_by_distinct_ref_offsets(
        _tensor(kmers[:0]), _tensor(offsets[:0])).shape == (0,)


def test_from_file_reads_every_column(tmp_path):
    jax_index, _ = _indexes(101)
    path = str(tmp_path / "index")
    jax_index.to_file(path)
    port = KmerIndex.from_file(path, device="cpu")
    assert port.modulo == 101
    assert np.array_equal(port.kmers.numpy().view(np.uint64),
                          jax_index._kmers)
    assert np.array_equal(port.nodes.numpy(),
                          jax_index._nodes.astype(np.int64))
    for name in ("ref_offsets", "frequencies", "allele_frequencies",
                 "hashes_to_index", "n_kmers"):
        want = getattr(jax_index, "_" + name)
        got = getattr(port, name)
        assert isinstance(got, np.ndarray), name  # moved only when read
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    assert port.dtypes["nodes"] == jax_index._nodes.dtype
    # no allele frequencies in the file: float64 zeros, as in JAX
    with np.load(path + ".npz") as data:
        cols = {k: data[k] for k in data.files if k != "allele_frequencies"}
    np.savez(str(tmp_path / "no_af"), **cols)
    want = CollisionFreeKmerIndex.from_file(str(tmp_path / "no_af"))
    port = KmerIndex.from_file(str(tmp_path / "no_af"), device="cpu")
    assert port.allele_frequencies.dtype == np.float64
    assert np.array_equal(port.allele_frequencies,
                          want._allele_frequencies)
    q = _queries(101)
    assert np.array_equal(port.get_batched(q),
                          JaxDevice.from_host_index(want).get_batched(q))


# -- the CSR map/has path -------------------------------------------------------------

@pytest.mark.parametrize("modulo", MODULOS)
def test_csr_map_and_has_match_jax(modulo):
    jax_index, _ = _indexes(modulo)
    q = _queries(modulo)
    jax_dev = JaxDevice.from_host_index(jax_index)
    jax_dev.PACKED_BYTE_BUDGET = 0
    want_counts = np.asarray(jax_dev.map_kmers(q, 301), dtype=np.int64)
    want_has = np.asarray(jax_dev.has_kmers(q))
    assert jax_dev._packed() is None
    port = _port(modulo)
    port.device_index.PACKED_BYTE_BUDGET = 0
    assert np.array_equal(port.map_kmers(q, 301), want_counts)
    assert np.array_equal(port.has_kmers(q), want_has)
    assert port.device_index.packed() is None
    # nodes >= n_nodes are dropped, as the JAX scatters drop them
    assert np.array_equal(port.map_kmers(q, 150), np.asarray(
        jax_dev.map_kmers(q, 150), dtype=np.int64))
    # the packed path over the same bucket-sorted rows agrees
    packed = _port(modulo)
    assert np.array_equal(packed.map_kmers(q, 301), want_counts)
    assert np.array_equal(packed.has_kmers(q), want_has)


def _tables_to_host(index):
    """The bucket tables as numpy arrays, as KmerIndex.from_file leaves
    them; the index makes its views anew from them."""
    index.hashes_to_index = index.hashes_to_index.numpy()
    index.n_kmers = index.n_kmers.numpy()
    index._invalidate_query_caches()


# -- get_batched ------------------------------------------------------------------------

@pytest.mark.parametrize("caps", sorted(CAPS))
@pytest.mark.parametrize("route", ["tables", "searchsorted"])
@pytest.mark.parametrize("modulo", MODULOS)
def test_get_batched_matches_jax(modulo, route, caps):
    jax_index, _ = _indexes(modulo)
    q = _queries(modulo)
    hit_cap, freq_cap = CAPS[caps]
    jax_dev = JaxDevice.from_host_index(jax_index)
    port = _port(modulo)
    port_dev = port_lookup.DeviceKmerIndex(port)
    # tables that the build left on the index's device are taken whatever
    # the budget says, as in the JAX package
    port_dev.BUCKET_TABLE_BYTE_BUDGET = 0
    assert port_dev._bucket_tables_cheap()
    port_dev.BUCKET_TABLE_BYTE_BUDGET = (
        port_lookup.DeviceKmerIndex.BUCKET_TABLE_BYTE_BUDGET)
    if route == "searchsorted":
        # host tables (an index read from a file) over the budget
        _tables_to_host(port)
        port_dev = port.device_index
        jax_dev.BUCKET_TABLE_BYTE_BUDGET = 0
        port_dev.BUCKET_TABLE_BYTE_BUDGET = 0
    assert jax_dev._bucket_tables_cheap() == (route == "tables")
    assert port_dev._bucket_tables_cheap() == (route == "tables")
    want = jax_dev.get_batched(q, hit_cap=hit_cap, frequency_cap=freq_cap)
    got = port_dev.get_batched(_tensor(q), hit_cap=hit_cap,
                               frequency_cap=freq_cap)
    assert got.dtype == torch.int64 and got.shape[0] == 5
    assert got.shape[1] > 0
    assert np.array_equal(got.numpy().astype(np.uint64), want)
    # the searchsorted route never moved the modulo-sized tables
    assert ("starts_tbl" in port_dev._cache) == (route == "tables")
    if caps == "tight":  # whole queries skipped by the hit cap
        assert int(port_dev.max_scan) > hit_cap


def test_ref_bucket_ranges_match_numpy():
    rng = np.random.default_rng(7)
    modulo = 97
    tb = np.sort(rng.integers(0, modulo, 5000)).astype(np.int32)
    qb = np.concatenate([rng.integers(0, modulo, 900),
                         [0, 0, modulo - 1, 42, 42]])
    start, size = port_lookup._ref_bucket_ranges(torch.from_numpy(qb),
                                                 torch.from_numpy(tb))
    left = np.searchsorted(tb, qb, side="left")
    right = np.searchsorted(tb, qb, side="right")
    assert np.array_equal(start.numpy(), left)
    assert np.array_equal(size.numpy(), right - left)


@pytest.mark.parametrize("route", ["tables", "searchsorted"])
def test_get_batched_on_an_empty_index(route):
    port = KmerIndex.from_rows(np.zeros(0, np.uint64), np.zeros(0, np.uint32),
                               np.zeros(0, np.uint64),
                               np.zeros(0, np.float32), 101, device="cpu")
    if route == "searchsorted":
        _tables_to_host(port)
        port.device_index.BUCKET_TABLE_BYTE_BUDGET = 0
        assert not port.device_index._bucket_tables_cheap()
    q = np.array([0, 5, 4 ** 31 - 1], dtype=np.uint64)
    assert port.get_batched(q).shape == (5, 0)
    assert not port.has_kmers(q).any()


@pytest.mark.parametrize("column", ["ref_offsets", "frequencies"])
def test_removed_columns_read_as_zeros(column):
    jax_index, rows = _indexes(101)
    jax_index = CollisionFreeKmerIndex.from_flat_kmers(FlatKmers(*rows),
                                                       modulo=101)
    port = _port(101)
    getattr(jax_index, "remove_" + column)()
    getattr(port, "remove_" + column)()
    q = _queries(101)
    want = jax_index.get_batched(q)
    assert not want[1 if column == "ref_offsets" else 3].any()
    assert np.array_equal(port.get_batched(q), want)
    for max_hits in (10, 1):
        got = port.get_nodes_and_ref_offsets_from_multiple_kmers(q, max_hits)
        ref = jax_index.get_nodes_and_ref_offsets_from_multiple_kmers(
            q, max_hits)
        for a, b in zip(got, ref, strict=True):
            assert a.dtype == b.dtype and np.array_equal(a, b)


# -- the get API ------------------------------------------------------------------------

def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("modulo", MODULOS)
def test_get_and_contains_match_jax(modulo):
    jax_index, _ = _indexes(modulo)
    port = _port(modulo)
    q = _queries(modulo)
    picks = np.concatenate([q[:40], q[2000:2010], q[2600:2610], q[-5:]])
    for kmer in picks:
        for max_hits in (10, 1, 10 ** 9):
            want = jax_index.get(kmer, max_hits)
            got = port.get(kmer, max_hits)
            assert all(_same(a, b) for a, b in zip(got, want)), (kmer,
                                                                 max_hits)
        assert (kmer in port) == (kmer in jax_index)
        assert _same(port.get_nodes(kmer), jax_index.get_nodes(kmer))
    assert 0 in port and (1 << 61) not in port


@pytest.mark.parametrize("size", ["batched", "scalar"])
@pytest.mark.parametrize("max_hits", [10, 1])
@pytest.mark.parametrize("modulo", MODULOS)
def test_get_from_multiple_kmers_matches_jax(modulo, max_hits, size):
    jax_index, _ = _indexes(modulo)
    port = _port(modulo)
    q = _queries(modulo)
    if size == "scalar":  # below _BATCH_QUERY_THRESHOLD
        q = np.concatenate([q[:12], q[2000:2004], q[-5:]])
    want = jax_index.get_nodes_and_ref_offsets_from_multiple_kmers(
        q, max_hits=max_hits)
    got = port.get_nodes_and_ref_offsets_from_multiple_kmers(
        q, max_hits=max_hits)
    assert len(got[0]) > 0
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    want = jax_index.get_nodes_from_multiple_kmers(q, max_hits=max_hits)
    got = port.get_nodes_from_multiple_kmers(q, max_hits=max_hits)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_get_from_multiple_kmers_without_hits():
    jax_index, _ = _indexes(101)
    port = _port(101)
    for q in (np.full(40, 1 << 61, np.uint64), np.full(3, 1 << 61,
                                                          np.uint64)):
        want = jax_index.get_nodes_and_ref_offsets_from_multiple_kmers(q)
        got = port.get_nodes_and_ref_offsets_from_multiple_kmers(q)
        for a, b in zip(got, want, strict=True):
            assert a.dtype == b.dtype and a.shape == b.shape == (0,)
