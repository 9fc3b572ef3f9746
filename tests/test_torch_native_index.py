"""NativeKmerIndex of the port (the host C++ lookup over a KmerIndex's
columns) against the JAX package's, on the same tables and queries, exact;
and how it takes its columns from an index that holds tensors."""
import jax  # noqa: F401  (same process set-up as the other port tests)
import numpy as np
import pytest
import torch

import graph_kmer_index_tpu as jgki
import graph_kmer_index_tpu_torch as tgki
from graph_kmer_index_tpu.models.native_index import (
    NativeKmerIndex as JaxNativeKmerIndex)
from graph_kmer_index_tpu_torch import native
from graph_kmer_index_tpu_torch.models.native_index import (
    NativeKmerIndex, _host_contig)
from graph_kmer_index_tpu_torch.ops.lookup import SCAN_CAP

torch.set_num_threads(2)

pytestmark = pytest.mark.skipif(
    not native.available(), reason="the native host library needs g++")


def _adversarial(seed=99):
    """tests/test_indexes.py's table that hits every lookup path: dup2,
    deep and ultra-deep buckets, bucket-0 k-mers, k-mer 0 and the largest
    62-bit k-mer; and queries that hit and miss."""
    rng = np.random.default_rng(seed)
    kmers = rng.integers(1, 1 << 50, 4000).astype(np.uint64)
    dup2 = rng.integers(1, 1 << 50, 30).astype(np.uint64)
    deep = np.repeat(rng.integers(1, 1 << 50, 10).astype(np.uint64), 5)
    ultra = np.repeat(np.uint64(0), SCAN_CAP + 40)
    edge = np.array([4**31 - 1, 101, 202], dtype=np.uint64)
    kmers = np.concatenate([kmers, dup2, dup2, deep, ultra, edge])
    n = len(kmers)
    rows = (kmers, rng.integers(1, 300, n).astype(np.uint32),
            rng.integers(0, 10000, n).astype(np.uint64),
            rng.random(n).astype(np.float32))
    q = np.concatenate([
        kmers[rng.integers(0, n, 2000)],
        rng.integers(1 << 51, 1 << 60, 1000).astype(np.uint64),
        np.array([0, 4**31 - 1, 101], dtype=np.uint64)])
    rng.shuffle(q)
    return rows, q


def _pair(rows, modulo=101, **kw):
    jidx = jgki.CollisionFreeKmerIndex.from_flat_kmers(
        jgki.FlatKmers(*rows), modulo=modulo, use_device=False, **kw)
    tidx = tgki.KmerIndex.from_flat_kmers(
        tgki.FlatKmers(*rows), modulo=modulo, device="cpu", **kw)
    return jidx, tidx


@pytest.mark.parametrize("caps", [{}, dict(hit_cap=45, freq_cap=1),
                                  dict(hit_cap=1 << 60, freq_cap=1 << 60)])
def test_get_matches_jax(caps):
    rows, q = _adversarial()
    jidx, tidx = _pair(rows)
    want = JaxNativeKmerIndex(jidx).get(q, **caps)
    got = NativeKmerIndex(tidx).get(q, **caps)
    assert got.dtype == np.uint64 and got.shape[0] == 5
    assert np.array_equal(got, want) and got.shape[1] > 0
    # and the device lookup's rows are the same rows
    if not caps:
        assert np.array_equal(got, tidx.get_batched(q))


@pytest.mark.parametrize("prefer_packed", [False, True])
def test_map_and_has_kmers_match_jax(prefer_packed):
    rows, q = _adversarial()
    jidx, tidx = _pair(rows, skip_frequencies=True)
    jn, tn = JaxNativeKmerIndex(jidx), NativeKmerIndex(tidx)
    jn.prefer_packed = tn.prefer_packed = prefer_packed
    counts = tn.map_kmers(q, 301)
    assert np.array_equal(counts, jn.map_kmers(q, 301))
    assert np.array_equal(tn.has_kmers(q), jn.has_kmers(q))
    assert np.array_equal(np.asarray(counts, np.int64),
                          tidx.map_kmers(q, 301))
    assert bool(getattr(tn, "_packed_np", None)) == prefer_packed


def test_packed_tables_are_built_once_the_queries_pay_for_them():
    rows, q = _adversarial()
    _, tidx = _pair(rows)
    tn = NativeKmerIndex(tidx)
    first = tn.map_kmers(q[:100], 301)
    assert getattr(tn, "_packed_np", None) is None
    for _ in range(-(-4 * len(rows[0]) // len(q))):
        counts = tn.map_kmers(q, 301)
    assert tn._packed_np
    assert np.array_equal(counts, tidx.map_kmers(q, 301))
    assert np.array_equal(first, tidx.map_kmers(q[:100], 301))
    tn.PACKED_BYTE_BUDGET = 0
    tn._packed_np = None
    assert tn._packed() is None


def test_columns_of_a_cpu_index_are_read_where_they_lie():
    """int64 k-mer bits viewed as uint64, int32 bucket tables passed at
    their width, int32 sizes viewed as uint32: no copy; columns of another
    width are converted once and kept."""
    rows, _ = _adversarial()
    _, tidx = _pair(rows)
    tn = NativeKmerIndex(tidx)
    assert tn.table_kmers.dtype == np.uint64
    assert np.shares_memory(tn.table_kmers, tidx.kmers.numpy())
    assert tn.starts_tbl.dtype == np.int32
    assert np.shares_memory(tn.starts_tbl, tidx.hashes_to_index.numpy())
    assert tn.sizes_tbl.dtype == np.uint32
    assert np.shares_memory(tn.sizes_tbl, tidx.n_kmers.numpy())
    assert tn.table_nodes.dtype == np.uint32
    assert tn.table_nodes is tn.table_nodes
    assert np.array_equal(tn.table_nodes, rows[1][np.argsort(
        rows[0] % np.uint64(101), kind="stable")])
    assert tn.table_frequencies.dtype == np.uint16
    assert tn.table_allele_frequencies.dtype == np.float32
    assert tn.modulo == 101 and tn._n == len(rows[0])


def test_host_contig():
    a = np.arange(10, dtype=np.int64)
    assert np.shares_memory(_host_contig(a, np.uint64), a)
    assert np.shares_memory(_host_contig(torch.from_numpy(a), np.int64), a)
    strided = _host_contig(a[::2], np.int64)
    assert strided.flags.c_contiguous and strided.tolist() == [0, 2, 4, 6, 8]
    narrowed = _host_contig(torch.from_numpy(a), np.uint32)
    assert narrowed.dtype == np.uint32 and narrowed.tolist() == a.tolist()
    floats = _host_contig(np.ones(3), np.float32)
    assert floats.dtype == np.float32


def test_file_index_with_numpy_columns():
    """An index read from a file keeps numpy columns (uint32 sizes, uint16
    frequencies): the native view takes them as they are."""
    rows, q = _adversarial()
    jidx, tidx = _pair(rows)
    from_state = tgki.KmerIndex.from_properties(
        {p: getattr(jidx, p) for p in jidx.properties}, device="cpu")
    tn = NativeKmerIndex(from_state)
    assert np.shares_memory(tn.sizes_tbl, jidx._n_kmers)
    assert np.shares_memory(tn.table_frequencies, jidx._frequencies)
    assert np.array_equal(tn.get(q), JaxNativeKmerIndex(jidx).get(q))


def test_native_lookup_after_remove_ref_offsets():
    kmers = np.arange(1, 40, dtype=np.uint64) * 7
    rows = (kmers, np.arange(1, 40, dtype=np.uint32),
            np.arange(40, 79, dtype=np.uint64), np.ones(39, np.float32))
    jidx, tidx = _pair(rows)
    jidx.remove_ref_offsets()
    tidx.remove_ref_offsets()
    out = NativeKmerIndex(tidx).get(kmers[:8])
    assert out.shape == (5, 8) and (out[1] == 0).all()
    assert np.array_equal(out, JaxNativeKmerIndex(jidx).get(kmers[:8]))
    assert np.array_equal(out, tidx.get_batched(kmers[:8]))


def test_index_without_frequencies_reads_zeros():
    rows, q = _adversarial()
    _, tidx = _pair(rows)
    tidx.remove_frequencies()
    tn = NativeKmerIndex(tidx)
    assert not tn.table_frequencies.any()
    assert not tn.get(q)[3].any()


def test_modulo_zero_is_refused():
    rows, q = _adversarial()
    _, tidx = _pair(rows)
    tn = NativeKmerIndex(tidx)
    tn.modulo = 0
    with pytest.raises(ValueError):
        tn.get(q)
