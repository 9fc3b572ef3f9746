"""The index family of the port against the JAX package: the same seeded
numpy inputs through each JAX class and its counterpart, exact equality
(every output is an integer array, or float32 allele frequencies copied
through), and each npz/dict file written by one package read by the other.
Mirrors tests/test_indexes.py on the port."""
import pickle
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (same process set-up as the other port tests)
import numpy as np
import pytest
import torch

import graph_kmer_index_tpu as jgki
import graph_kmer_index_tpu_torch as tgki
from graph_kmer_index_tpu.models import counters as jcounters
from graph_kmer_index_tpu.utils import synthetic as jsynthetic
from graph_kmer_index_tpu_torch.models import counters as tcounters
from graph_kmer_index_tpu_torch.utils import synthetic as tsynthetic

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
K = 13
MODULO = 1009


def _rows(seed, n=4000, n_distinct=900):
    """Index rows with repeated k-mers (several ref offsets each), and for
    a part of them the reverse complement present too."""
    rng = np.random.default_rng(seed)
    distinct = rng.integers(0, 1 << (2 * K), n_distinct).astype(np.uint64)
    distinct[:200] = jgki.kmer_hashes_to_reverse_complement_hash(
        distinct[200:400], K)
    pick = rng.integers(0, n_distinct, n)
    kmers = distinct[pick]
    nodes = rng.integers(1, 500, n).astype(np.uint32)
    ref_offsets = rng.integers(0, 60, n).astype(np.uint64)
    af = rng.random(n).astype(np.float32)
    return kmers, nodes, ref_offsets, af


def _pair(seed=0, modulo=MODULO, **kw):
    rows = _rows(seed)
    jidx = jgki.CollisionFreeKmerIndex.from_flat_kmers(
        jgki.FlatKmers(*rows), modulo=modulo, **kw)
    tidx = tgki.KmerIndex.from_flat_kmers(
        tgki.FlatKmers(*rows), modulo=modulo, device="cpu", **kw)
    return jidx, tidx, rows


def _queries(rows, seed=1):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rows[0][rng.integers(0, len(rows[0]), 300)],
        rng.integers(0, 1 << (2 * K), 200).astype(np.uint64)])


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and np.array_equal(a, b)


def _assert_index_equals_jax(tidx, jidx):
    props = tidx.to_properties()
    assert sorted(props) == sorted(jidx.properties)
    for name in jidx.properties:
        want = getattr(jidx, name)
        if np.ndim(want) == 0:
            assert props[name] == want, name
        else:
            assert _same(props[name], want), name


@pytest.fixture
def small():
    """tests/test_indexes.py's seven-row index, in both packages."""
    rows = (np.array([1, 1, 2, 2, 4, 5, 3], dtype=np.uint64),
            np.array([5, 6, 7, 8, 10, 11, 100]),
            np.array([1, 1, 2, 3, 10, 11, 100]))
    return (jgki.CollisionFreeKmerIndex.from_flat_kmers(
                jgki.FlatKmers(*rows), modulo=4),
            tgki.KmerIndex.from_flat_kmers(tgki.FlatKmers(*rows), modulo=4,
                                           device="cpu"))


def test_simple(small, tmp_path):
    jidx, tidx = small
    assert list(tidx.get(1)[0]) == [5, 6] and list(tidx.get(1)[1]) == [1, 1]
    f = str(tmp_path / "tmp.index")
    tidx.to_file(f)
    tidx = tgki.KmerIndex.from_file(f, device="cpu")
    assert list(tidx.get(5)[0]) == [11]
    got = tidx.get_nodes_and_ref_offsets_from_multiple_kmers(np.array([1, 5]))
    want = jidx.get_nodes_and_ref_offsets_from_multiple_kmers(
        np.array([1, 5]))
    for a, b in zip(got, want):
        assert _same(a, b)


def test_frequencies(small):
    _, tidx = small
    assert tidx.get(1, max_hits=10)[2][0] == 1
    assert tidx.get(2, max_hits=10)[2][0] == 2


def test_has_kmers_parallel(small):
    jidx, tidx = small
    tidx.convert_to_int32()
    kmers = np.array([1, 2, 3, 10, 10, 12, 100, 101, 102, 5],
                     dtype=np.uint64)
    result = tidx.has_kmers_parallel(kmers, n_threads=3)
    assert result.dtype == bool
    assert list(result) == [True, True, True, False, False, False, False,
                            False, False, True]
    assert np.array_equal(result, jidx.has_kmers(kmers))


def test_built_index_has_the_jax_properties():
    jidx, tidx, _ = _pair()
    _assert_index_equals_jax(tidx, jidx)


@pytest.mark.parametrize("backend", ["device", "native", None])
@pytest.mark.parametrize("include_rc,k", [(True, 31), (True, K), (False, 31)])
def test_get_frequencies_matches_jax(backend, include_rc, k):
    """Both routes of the port (the bucket ranges in torch, the native
    library) against the JAX package, with the k = 31 default that differs
    from the index's k and with the index's own."""
    jidx, tidx, rows = _pair(seed=3)
    q = _queries(rows)
    want = jidx.get_frequencies(q, include_rc, k)
    got = tidx.get_frequencies(q, include_rc, k, backend=backend)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    assert got.max() > 1 and (got == 0).any()
    # a tensor of queries, and the scalar method
    assert np.array_equal(tidx.get_frequencies(
        torch.from_numpy(q.view(np.int64)), include_rc, k, backend=backend),
        want)
    for h in q[:20]:
        assert tidx.get_frequency(int(h), include_rc, k) == \
            jidx.get_frequency(int(h), include_rc, k)


def test_get_frequencies_first_hit_wins():
    """A k-mer whose rows carry different frequencies answers with its
    first row's, on both routes, as the JAX package's reversed write."""
    jidx, tidx, rows = _pair(seed=4)
    freqs = np.arange(len(rows[0]), dtype=np.uint16) % 7
    jidx._frequencies = freqs.copy()
    jidx._invalidate_query_caches()
    tidx.frequencies = freqs.copy()
    tidx._invalidate_query_caches()
    q = _queries(rows)
    want = jidx.get_frequencies(q)
    assert np.array_equal(tidx.get_frequencies(q, backend="device"), want)
    assert np.array_equal(tidx.get_frequencies(q, backend="native"), want)


def test_get_frequencies_empty_batch_and_unknown_backend():
    _, tidx, _ = _pair()
    for backend in ("device", "native"):
        out = tidx.get_frequencies(np.zeros(0, np.uint64), backend=backend)
        assert out.dtype == np.int64 and out.shape == (0,)
    with pytest.raises(ValueError, match="unknown backend"):
        tidx.get_frequencies(np.zeros(1, np.uint64), backend="tpu")


def test_flat_kmers_frequency_scoring_works_on_a_port_index():
    """FlatKmers.maximum_kmer_frequency and sum_of_kmer_frequencies call
    ``get_frequencies`` of the index they are given: a port index has it,
    and answers as the JAX package's."""
    jidx, tidx, rows = _pair(seed=5)
    q = _queries(rows)
    nodes = np.ones(len(q), np.uint32)
    jflat, tflat = jgki.FlatKmers(q, nodes), tgki.FlatKmers(q, nodes)
    assert tflat.maximum_kmer_frequency(tidx) == \
        jflat.maximum_kmer_frequency(jidx) > 1
    assert tflat.sum_of_kmer_frequencies(tidx) == \
        jflat.sum_of_kmer_frequencies(jidx)
    empty = tgki.FlatKmers(np.zeros(0, np.uint64), np.zeros(0, np.uint32))
    assert empty.maximum_kmer_frequency(tidx) == 0


@pytest.mark.parametrize("multiplier,min_frequency", [(1, 1), (3, 2)])
def test_set_frequencies_using_other_index(multiplier, min_frequency):
    jidx, tidx, _ = _pair(seed=6)
    jother, tother, _ = _pair(seed=7)
    # share some k-mers with the other index
    jother2 = jgki.CollisionFreeKmerIndex.from_flat_kmers(
        jgki.FlatKmers(*_rows(6, n=1500)), modulo=503)
    tother2 = tgki.KmerIndex.from_flat_kmers(
        tgki.FlatKmers(*_rows(6, n=1500)), modulo=503, device="cpu")
    for jo, to in ((jother, tother), (jother2, tother2)):
        jidx.set_frequencies_using_other_index(jo, multiplier, min_frequency)
        tidx.set_frequencies_using_other_index(to, multiplier, min_frequency)
        assert _same(tidx.to_properties()["_frequencies"], jidx._frequencies)
    # any object with get_frequencies serves, e.g. a frequency index
    kmers = _rows(6)[0]
    jidx.set_frequencies_using_other_index(
        jgki.KmerFrequencyIndex.from_kmers(kmers), multiplier)
    tidx.set_frequencies_using_other_index(
        tgki.KmerFrequencyIndex.from_kmers(kmers), multiplier)
    assert _same(tidx.to_properties()["_frequencies"], jidx._frequencies)
    q = _queries(_rows(6))
    assert np.array_equal(tidx.get_frequencies(q), jidx.get_frequencies(q))


def test_maintenance_methods_match_jax():
    jidx, tidx, rows = _pair(seed=8)
    assert _same(tidx.get_kmers(), jidx.get_kmers())
    assert tidx.set_allele_frequencies(np.ones(3)) is None
    _assert_index_equals_jax(tidx, jidx)
    jcopy, tcopy = jidx.copy(), tidx.copy()
    _assert_index_equals_jax(tcopy, jcopy)
    tcopy.nodes[0] += 1
    assert int(tcopy.nodes[0]) == int(tidx.nodes[0]) + 1
    for h in rows[0][:30]:
        got, want = tidx.get_grouped_nodes(h), jidx.get_grouped_nodes(h)
        assert len(got) == len(want)
        assert all(_same(a, b) for a, b in zip(got, want))
    assert tidx.get_grouped_nodes(1 << 40) is None
    jidx.convert_to_int32()
    tidx.convert_to_int32()
    for name in ("_hashes_to_index", "_nodes", "_n_kmers"):
        assert _same(tidx.to_properties()[name], getattr(jidx, name)), name
    q = _queries(rows)
    assert np.array_equal(tidx.map_kmers(q, 500), jidx.map_kmers(q, 500))
    tidx.clear()
    assert tidx.kmers is None and tidx.nodes is None and tidx.modulo is None


@pytest.mark.parametrize("skip_frequencies", [True, False])
def test_convert_kmers_to_complement(skip_frequencies):
    jidx, tidx, _ = _pair(seed=9)
    _assert_index_equals_jax(
        tidx.convert_kmers_to_complement(K, skip_frequencies),
        jidx.convert_kmers_to_complement(K, skip_frequencies))


@pytest.mark.parametrize("backend", ["device", "native"])
def test_map_and_has_kmers_backends(backend):
    jidx, tidx, rows = _pair(seed=10)
    q = _queries(rows)
    assert np.array_equal(tidx.map_kmers(q, 500, backend=backend),
                          jidx.map_kmers(q, 500, backend=backend))
    assert np.array_equal(tidx.has_kmers(q, backend=backend),
                          jidx.has_kmers(q, backend=backend))
    tq = torch.from_numpy(q.view(np.int64))
    assert np.array_equal(tidx.map_kmers(tq, 500, backend=backend),
                          jidx.map_kmers(q, 500))


def test_mutation_invalidates_query_caches():
    _, tidx, rows = _pair(seed=11)
    q = _queries(rows)
    before = tidx.get_frequencies(q, backend="native")
    assert tidx._native_index is not None
    tidx.remove_frequencies()
    assert tidx._native_index is None
    after = tidx.get_frequencies(q, backend="native")
    assert before.max() > 0 and not after.any()
    assert not tidx.get_frequencies(q, backend="device").any()


def test_from_properties_carries_all_eight_columns():
    jidx, _, rows = _pair(seed=12)
    tidx = tgki.KmerIndex.from_properties(
        {name: getattr(jidx, name) for name in jidx.properties},
        device="cpu")
    _assert_index_equals_jax(tidx, jidx)
    q = _queries(rows)
    assert np.array_equal(tidx.get_frequencies(q), jidx.get_frequencies(q))
    assert np.array_equal(tidx.get_batched(q), jidx.get_batched(q))


def test_minimal_index(tmp_path):
    kmers, nodes, ref_offsets, _ = _rows(13)
    jm = jgki.MinimalKmerIndex.from_flat_kmers(
        jgki.FlatKmers(kmers, nodes, ref_offsets), modulo=MODULO)
    tm = tgki.MinimalKmerIndex.from_flat_kmers(
        tgki.FlatKmers(kmers, nodes, ref_offsets), modulo=MODULO)
    names = ("_hashes_to_index", "_n_kmers", "_nodes", "_kmers", "_modulo")
    for name in names:
        assert _same(getattr(tm, name), getattr(jm, name)), name
    assert tm.max_node_id() == jm.max_node_id()
    tm.to_file(str(tmp_path / "port"))
    jm.to_file(str(tmp_path / "jax"))
    from_port = jgki.MinimalKmerIndex.from_file(str(tmp_path / "port"))
    from_jax = tgki.MinimalKmerIndex.from_file(str(tmp_path / "jax"))
    state = tgki.MinimalKmerIndex(*(getattr(jm, n) for n in (
        "_hashes_to_index", "_n_kmers", "_nodes", "_kmers", "_modulo")))
    for name in names:
        assert _same(getattr(from_port, name), getattr(jm, name)), name
        assert _same(getattr(from_jax, name), getattr(jm, name)), name
        assert _same(getattr(state, name), getattr(jm, name)), name


def _flat2(pkg, seed):
    rng = np.random.default_rng(seed)
    n = 400
    return pkg.FlatKmers2(rng.integers(0, 60, n), rng.integers(1, 9, n),
                          rng.integers(0, 5, n), rng.integers(1, 50, n),
                          rng.random(n))


def test_kmer_index2():
    ji = jgki.KmerIndex2.from_flat_kmers(_flat2(jgki, 14))
    ti = tgki.KmerIndex2.from_flat_kmers(_flat2(tgki, 14))
    assert _same(np.sort(ti.get_all_kmers()), np.sort(ji.get_all_kmers()))
    for kmer in np.unique(ji.get_all_kmers()):
        assert ti.get_kmer_frequency(kmer) == ji.get_kmer_frequency(kmer)
        assert _same(ti.get_start_nodes(kmer), ji.get_start_nodes(kmer))
        assert _same(ti.get_start_offsets(kmer), ji.get_start_offsets(kmer))
        assert _same(ti.get_nodes(kmer), ji.get_nodes(kmer))
    empty = tgki.FlatKmers2(*(np.zeros(0, np.int64),) * 4, np.zeros(0))
    assert len(tgki.KmerIndex2.from_flat_kmers(empty)._frequencies._keys) \
        == 0


def _npz_pairs(tmp_path, jobj, tobj, jcls, tcls, names):
    """Both objects equal; each one's file read by the other package."""
    for name in names:
        assert _same(getattr(tobj, name), getattr(jobj, name)), name
    tobj.to_file(str(tmp_path / "port"))
    jobj.to_file(str(tmp_path / "jax"))
    from_port = jcls.from_file(str(tmp_path / "port.npz"))
    from_jax = tcls.from_file(str(tmp_path / "jax.npz"))
    for name in names:
        assert _same(getattr(from_port, name), getattr(jobj, name)), name
        assert _same(getattr(from_jax, name), getattr(jobj, name)), name


def test_reverse_kmer_index(tmp_path):
    kmers, nodes, ref_offsets, _ = _rows(15)
    jr = jgki.ReverseKmerIndex.from_flat_kmers(
        jgki.FlatKmers(kmers, nodes, ref_offsets))
    tr = tgki.ReverseKmerIndex.from_flat_kmers(
        tgki.FlatKmers(kmers, nodes, ref_offsets))
    _npz_pairs(tmp_path, jr, tr, jgki.ReverseKmerIndex,
               tgki.ReverseKmerIndex, sorted(jr.properties))
    for node in (1, 7, 499):
        assert _same(tr.get_node_kmers(node), jr.get_node_kmers(node))
        for a, b in zip(tr.get_node_kmers_and_ref_positions(node),
                        jr.get_node_kmers_and_ref_positions(node)):
            assert _same(a, b)
    state = tgki.ReverseKmerIndex(**{p: getattr(jr, p)
                                     for p in jr.properties})
    assert _same(state.get_node_kmers(7), jr.get_node_kmers(7))
    assert str(tr) == str(jr)


def test_count_min_sketch(tmp_path):
    rng = np.random.default_rng(16)
    kmers = rng.integers(0, 1 << 62, 3000).astype(np.uint64)
    kmers[:500] = kmers[500:1000]
    modulos = [1009, 2003, 4001]
    jc = jgki.CountMinSketchKmerCounter.create_empty(modulos)
    tc = tgki.CountMinSketchKmerCounter.create_empty(modulos)
    for part in np.array_split(kmers, 3):
        jc.count_kmers(part)
        tc.count_kmers(part)
    _npz_pairs(tmp_path, jc, tc, jgki.CountMinSketchKmerCounter,
               tgki.CountMinSketchKmerCounter, ("_data", "_modulos"))
    assert _same(tc.get_counts(kmers), jc.get_counts(kmers))
    assert tc.get_count(kmers[0]) == jc.get_count(kmers[0]) >= 2
    assert _same(tc.get_frequencies(kmers[:9]), jc.get_frequencies(kmers[:9]))
    state = tgki.CountMinSketchKmerCounter(jc._data, jc._modulos)
    assert _same(state.get_counts(kmers), jc.get_counts(kmers))


@pytest.mark.parametrize("n", [10, 999_999, 1_000_000, 9_999_999,
                               10_000_000])
def test_choose_modulo(n):
    assert tcounters.choose_modulo(n) == jcounters.choose_modulo(n)


@pytest.mark.parametrize("maker,args", [
    ("from_flat_kmers", (101,)), ("from_flat_kmersv2", (0, 2)),
    ("from_flat_kmersv2", (211, 1))])
def test_kmer_counter(maker, args):
    rng = np.random.default_rng(17)
    kmers = rng.integers(0, 300, 2000).astype(np.uint64)
    nodes = np.arange(2000)
    jc = getattr(jgki.KmerCounter, maker)(jgki.FlatKmers(kmers, nodes), *args)
    tc = getattr(tgki.KmerCounter, maker)(tgki.FlatKmers(kmers, nodes), *args)
    q = np.arange(320, dtype=np.uint64)
    assert _same(tc.get_frequencies(q), jc.get_frequencies(q))
    for kmer in (0, 5, 299, 1234):
        assert tc.get_frequency(kmer) == jc.get_frequency(kmer)
    if maker == "from_flat_kmers":
        assert tc.score_kmers(q[:9]) == jc.score_kmers(q[:9])
        assert tc.score_kmers(np.array([], dtype=np.uint64)) == 1


def test_kmer_frequency_index(tmp_path):
    rng = np.random.default_rng(18)
    kmers = rng.integers(0, 1 << 40, 500).astype(np.uint64)
    kmers = np.concatenate([kmers, kmers[:100], kmers[:30]])
    ji = jgki.KmerFrequencyIndex.from_kmers(kmers)
    ti = tgki.KmerFrequencyIndex.from_kmers(kmers)
    _npz_pairs(tmp_path, ji, ti, jgki.KmerFrequencyIndex,
               tgki.KmerFrequencyIndex, ("_kmers", "_frequencies"))
    q = np.concatenate([kmers[:50], np.array([7, 1 << 41], dtype=np.uint64)])
    assert _same(ti.get_frequencies(q), ji.get_frequencies(q))
    assert ti.get(kmers[0]) == ji.get(kmers[0]) == 3 and ti.get(7) == 0
    state = tgki.KmerFrequencyIndex(ji._kmers, ji._frequencies)
    assert _same(state.get_frequencies(q), ji.get_frequencies(q))
    empty = tgki.KmerFrequencyIndex.from_kmers(np.zeros(0, np.uint64))
    assert _same(empty.get_frequencies(q), np.zeros(len(q), np.int64))


def test_reference_kmer_index(tmp_path):
    # the quirk of the reference is kept: the first row is never registered
    flat = (np.array([11, 12, 13, 14], dtype=np.uint64),
            np.array([1, 1, 1, 1]), np.array([1, 2, 3, 6]))
    ti = tgki.ReferenceKmerIndex.from_flat_kmers(tgki.FlatKmers(*flat))
    assert list(ti.ref_position_to_index) == [1, 1, 1, 2, 3, 3, 3]
    assert list(ti.get_between(1, 4)) == [12, 13]
    kmers, nodes, ref_offsets, _ = _rows(19)
    ji = jgki.ReferenceKmerIndex.from_flat_kmers(
        jgki.FlatKmers(kmers, nodes, ref_offsets))
    ti = tgki.ReferenceKmerIndex.from_flat_kmers(
        tgki.FlatKmers(kmers, nodes, ref_offsets))
    _npz_pairs(tmp_path, ji, ti, jgki.ReferenceKmerIndex,
               tgki.ReferenceKmerIndex, sorted(ji.properties))
    for a, b in zip(ti.get_all_between(3, 40), ji.get_all_between(3, 40)):
        assert _same(a, b)
    assert _same(ti.get_between(5, 10_000), ji.get_between(5, 10_000))
    state = tgki.ReferenceKmerIndex(**{p: getattr(ji, p)
                                       for p in ji.properties})
    assert _same(state.get_between(3, 40), ji.get_between(3, 40))


@pytest.mark.parametrize("k,only_store_kmers", [(5, False), (17, False),
                                                (16, True)])
def test_reference_kmer_index_from_linear_reference(tmp_path, k,
                                                    only_store_kmers):
    rng = np.random.default_rng(20)
    seq = "".join(rng.choice(list("ACGT"), 300))
    fasta = tmp_path / "ref.fa"
    fasta.write_text(">other\nACGT\n>chr1 x\n" + seq[:150] + "\n"
                     + seq[150:] + "\n")
    ji = jgki.ReferenceKmerIndex.from_linear_reference(
        str(fasta), "chr1", k, only_store_kmers)
    ti = tgki.ReferenceKmerIndex.from_linear_reference(
        str(fasta), "chr1", k, only_store_kmers)
    assert _same(ti.kmers, ji.kmers)
    if only_store_kmers:
        assert ti.ref_position_to_index is None
    else:
        assert _same(ti.ref_position_to_index, ji.ref_position_to_index)
        assert _same(ti.get_between(3, 20), ji.get_between(3, 20))
    assert _same(ti.get_between_except(2, 9, 4), ji.get_between_except(2, 9, 4))
    ti.to_file(str(tmp_path / "port"))
    back = jgki.ReferenceKmerIndex.from_file(str(tmp_path / "port"))
    assert _same(back.kmers, ji.kmers) and back.nodes is None


def test_counter_kmer_index(small):
    jidx, tidx = small
    jc = jgki.CounterKmerIndex.from_kmer_index(jidx)
    tc = tgki.CounterKmerIndex.from_kmer_index(tidx)
    reads = np.array([1, 1, 5], dtype=np.uint64)
    jc.count_kmers(reads)
    tc.count_kmers(reads)
    counts = tc.get_node_counts()
    assert counts[5] == 2 and counts[6] == 2 and counts[11] == 1
    assert np.array_equal(counts, jc.get_node_counts())
    jidx, tidx, rows = _pair(seed=21)
    jc = jgki.CounterKmerIndex.from_kmer_index(jidx, 307)
    tc = tgki.CounterKmerIndex.from_kmer_index(tidx, 307)
    q = _queries(rows).astype(np.int64)
    for update in (True, False):
        jc.count_kmers(q, update_counter=update)
        tc.count_kmers(q, update_counter=update)
        assert np.array_equal(tc.get_node_counts(600),
                              jc.get_node_counts(600))
    # an object pickle round-trips inside the port
    back = pickle.loads(pickle.dumps(tc))
    assert np.array_equal(back.get_node_counts(600), tc.get_node_counts(600))


def _snp_graph(pkg):
    return pkg.Graph.from_dicts(
        {1: "ACTGACTGAA", 2: "A", 3: "G", 4: "CCTACGTGCA"},
        {1: [2, 3], 2: [4], 3: [4]}, [1, 2, 4])


def test_unique_kmer_index(tmp_path):
    dicts = {}
    for name, pkg in (("jax", jgki), ("port", tgki)):
        graph = _snp_graph(pkg)
        finder = pkg.DenseKmerFinder(graph, k=5)
        finder.find()
        flat = finder.get_flat_kmers(v="0")
        reverse = pkg.ReverseKmerIndex.from_flat_kmers(flat)
        dense = pkg.UniqueKmerIndex.from_flat_kmers_and_snps_graph(
            flat, graph, reverse)
        dicts["dense " + name] = dict(dense._index_dict)
        # one unique k-mer on each allele node of the SNP, one shared
        flat = pkg.FlatKmers(np.array([10, 11, 12, 12], dtype=np.uint64),
                             np.array([2, 3, 1, 4]), np.array([9, 9, 2, 11]))
        reverse = pkg.ReverseKmerIndex.from_flat_kmers(flat)
        unique = pkg.UniqueKmerIndex.from_flat_kmers_and_snps_graph(
            flat, graph, reverse)
        unique.to_file(str(tmp_path / name))
        dicts[name] = dict(unique._index_dict)
    assert dicts["dense port"] == dicts["dense jax"]
    assert dicts["port"] == dicts["jax"] == {10: [2], 11: [3]}
    # the file is a pickle of a plain dict: each package reads the other's
    assert dict(tgki.UniqueKmerIndex.from_file(
        str(tmp_path / "jax"))._index_dict) == dicts["jax"]
    from_port = jgki.UniqueKmerIndex.from_file(str(tmp_path / "port"))
    assert dict(from_port._index_dict) == dicts["jax"]
    kmer = next(iter(dicts["port"]))
    assert from_port.get(kmer) == dicts["port"][kmer]


def test_variant_nodes_index(tmp_path):
    jg, _ = jsynthetic.random_snp_graph(3000, 40, seed=3, indel_fraction=0.3)
    tg, _ = tsynthetic.random_snp_graph(3000, 40, seed=3, indel_fraction=0.3)
    ji = jgki.VariantNodesIndex.from_graph(jg)
    ti = tgki.VariantNodesIndex.from_graph(tg)
    _npz_pairs(tmp_path, ji, ti, jgki.VariantNodesIndex,
               tgki.VariantNodesIndex, sorted(ji.properties))
    assert _same(ti.get_variant_nodes_between_ref_positions(100, 900),
                 ji.get_variant_nodes_between_ref_positions(100, 900))
    assert len(ti.variant_nodes) == len(ji.variant_nodes) >= 39
    state = tgki.VariantNodesIndex(ji.ref_positions, ji.variant_nodes)
    assert _same(state.variant_nodes, ji.variant_nodes)
    # the reference's writer spells the key ``ref_position``
    np.savez(tmp_path / "foreign.npz", ref_position=ji.ref_positions,
             variant_nodes=ji.variant_nodes)
    foreign = tgki.VariantNodesIndex.from_file(str(tmp_path / "foreign.npz"))
    assert _same(foreign.ref_positions, ji.ref_positions)


def test_empty_flat_kmers_builds():
    e = (np.zeros(0, np.uint64), np.zeros(0, np.uint32),
         np.zeros(0, np.uint64), np.zeros(0, np.float32))
    tidx = tgki.KmerIndex.from_flat_kmers(tgki.FlatKmers(*e), modulo=17,
                                          device="cpu")
    q = np.array([1, 2, 3], dtype=np.uint64)
    for backend in ("device", "native"):
        assert not tidx.get_frequencies(q, backend=backend).any()
    assert not tidx.has_kmers(q).any()
    tm = tgki.MinimalKmerIndex.from_flat_kmers(tgki.FlatKmers(*e), modulo=17)
    jm = jgki.MinimalKmerIndex.from_flat_kmers(jgki.FlatKmers(*e), modulo=17)
    assert _same(tm._hashes_to_index, jm._hashes_to_index)
    for cls in ("ReverseKmerIndex", "ReferenceKmerIndex"):
        ti = getattr(tgki, cls).from_flat_kmers(tgki.FlatKmers(*e))
        ji = getattr(jgki, cls).from_flat_kmers(jgki.FlatKmers(*e))
        for prop in ji.properties:
            assert _same(getattr(ti, prop), getattr(ji, prop)), (cls, prop)


def _public_names():
    return sorted(n for n in vars(jgki) if not n.startswith("_")
                  and not isinstance(getattr(jgki, n), type(sys)))


@pytest.mark.parametrize("name", _public_names())
def test_every_jax_export_resolves_in_the_port(name):
    value = getattr(tgki, name)
    assert callable(value)
    assert value.__module__.startswith("graph_kmer_index_tpu_torch")
    if name == "CollisionFreeKmerIndex":
        assert value is tgki.KmerIndex


def test_exports_resolve_at_first_use_without_torch():
    """Importing the package, and taking a host class from it, imports no
    torch: the pooled find's workers rely on it."""
    probe = ("import sys, graph_kmer_index_tpu_torch as p; "
             "p.Graph, p.VcfVariants, p.ReverseKmerIndex, p.KmerCounter, "
             "p.build_graph_from_vcf, p.power_array; "
             "assert 'torch' not in sys.modules; p.KmerIndex; "
             "assert 'torch' in sys.modules; print('ok')")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
