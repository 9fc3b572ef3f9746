"""Port parity: the host data layer that graph_kmer_index_tpu_torch copies
from the JAX package (hugepages, containers, hashing, serialize, fasta,
Graph / PositionId / VariantToNodes, CriticalGraphPaths, random_snp_graph,
FlatKmers) against the originals on the same seeded inputs, and the files
one package writes read by the other, both ways. Exact equality."""
import jax  # noqa: F401  (same process set-up as the other port tests)
import numpy as np
import pytest
import torch

import graph_kmer_index_tpu as jax_pkg
from graph_kmer_index_tpu import containers as jax_containers
from graph_kmer_index_tpu import hashing as jax_hashing
from graph_kmer_index_tpu.utils import fasta as jax_fasta
from graph_kmer_index_tpu.utils import hugepages as jax_hugepages
from graph_kmer_index_tpu.utils import serialize as jax_serialize
from graph_kmer_index_tpu.utils.synthetic import (
    random_snp_graph as jax_random_snp_graph)

import graph_kmer_index_tpu_torch as port_pkg
from graph_kmer_index_tpu_torch import containers, hashing
from graph_kmer_index_tpu_torch.flat_kmers import host_column
from graph_kmer_index_tpu_torch.utils import fasta, hugepages, serialize
from graph_kmer_index_tpu_torch.utils.synthetic import random_snp_graph

torch.set_num_threads(2)

GRAPH_ARRAYS = sorted(jax_pkg.Graph.properties)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and np.array_equal(a, b)


# -- hugepages, serialize, fasta ------------------------------------------------

@pytest.mark.parametrize("size", [10, (1 << 20) + 17])
def test_hugepage_allocators(size):
    rng = np.random.default_rng(0)
    for module in (hugepages, jax_hugepages):
        a = module.hp_empty(size, np.int32)
        assert a.shape == (size,) and a.dtype == np.int32
        z = module.hp_zeros((2, size), np.uint16, populate=True)
        assert z.shape == (2, size) and not z.any()
        a[:] = 7
        assert a.sum() == 7 * size
    parts = [rng.integers(0, 9, n).astype(t)
             for n, t in ((size, np.int16), (3, np.int64), (0, np.int8))]
    got, want = (m.hp_concatenate(parts) for m in (hugepages, jax_hugepages))
    assert _same(got, want) and _same(got, np.concatenate(parts))
    with pytest.raises(ValueError):
        hugepages.hp_concatenate([])
    assert hugepages.cap_malloc_mmap_threshold() in (True, False)


def test_serialize_and_fasta_helpers(tmp_path):
    obj = {"a": np.arange(5), "b": ("x", 3)}
    for writer, reader in ((serialize, jax_serialize),
                           (jax_serialize, serialize)):
        path = writer.to_file(obj, tmp_path / "obj.pkl")
        back = reader.from_file(path)
        assert back["b"] == obj["b"] and _same(back["a"], obj["a"])
    fa = tmp_path / "ref.fa"
    fa.write_text(">chr1 first\nACGT\nTTGA\n\n>chr2\nGGGCC\n")
    for name in (None, "chr2"):
        assert (fasta.read_fasta_sequence(str(fa), name)
                == jax_fasta.read_fasta_sequence(str(fa), name))
    assert fasta.read_fasta_sequences(str(fa)) == {"chr1": "ACGTTTGA",
                                                   "chr2": "GGGCC"}
    assert (list(fasta.iter_fasta_reads(str(fa)))
            == list(jax_fasta.iter_fasta_reads(str(fa))))


# -- hashing ------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 5, 16, 31])
def test_hashing_functions(k):
    rng = np.random.default_rng(k)
    text = "".join(rng.choice(list("ACGTacgtNm"), size=6000))
    codes = jax_hashing.letter_sequence_to_numeric(text)
    for arg in (text, text.encode(), np.array(list(text[:50])), codes[:40]):
        assert _same(hashing.letter_sequence_to_numeric(arg),
                     jax_hashing.letter_sequence_to_numeric(arg))
    assert _same(hashing.numeric_to_letter_sequence(codes[:100]),
                 jax_hashing.numeric_to_letter_sequence(codes[:100]))
    assert _same(hashing.power_array(k), jax_hashing.power_array(k))
    assert _same(hashing.reverse_power_array(k),
                 jax_hashing.reverse_power_array(k))
    # below and above the native route's threshold (4096 windows)
    for n in (k, 300, 6000):
        assert _same(hashing.sliding_window_hashes(codes[:n], k),
                     jax_hashing.sliding_window_hashes(codes[:n], k))
    h = jax_hashing.sliding_window_hashes(codes, k)
    for name in ("kmer_hashes_to_bases", "kmer_hashes_to_complement_bases",
                 "kmer_hashes_to_complement_hashes",
                 "kmer_hashes_to_reverse_complement_hash"):
        assert _same(getattr(hashing, name)(h[:500], k),
                     getattr(jax_hashing, name)(h[:500], k)), name
    assert _same(
        hashing.kmer_hashes_to_reverse_complement_hash_chunked(h, k, 1000),
        jax_hashing.kmer_hashes_to_reverse_complement_hash_chunked(h, k,
                                                                   1000))
    one = int(h[3])
    assert (hashing.kmer_hash_to_reverse_complement_hash(one, k)
            == jax_hashing.kmer_hash_to_reverse_complement_hash(one, k))
    assert (hashing.kmer_hash_to_sequence(one, k)
            == jax_hashing.kmer_hash_to_sequence(one, k))
    assert (hashing.sequence_to_kmer_hash(text[:k])
            == jax_hashing.sequence_to_kmer_hash(text[:k]) == int(h[0]))
    assert (hashing.kmer_to_hash_fast(codes[:k], k)
            == jax_hashing.kmer_to_hash_fast(codes[:k], k))
    for only_add in (False, 3):
        assert (hashing.update_hash(2, one, 1, k, only_add)
                == jax_hashing.update_hash(2, one, 1, k, only_add))


# -- containers -----------------------------------------------------------------------

def test_nplist():
    rng = np.random.default_rng(1)
    lists = [m.NpList(dtype=np.int32) for m in (containers, jax_containers)]
    for _ in range(300):
        if rng.random() < 0.5:
            v = int(rng.integers(0, 1000))
            for lst in lists:
                lst.append(v)
        else:
            chunk = rng.integers(0, 1000, int(rng.integers(0, 400)))
            for lst in lists:
                lst.extend(chunk)
    assert _same(lists[0].get_nparray(), lists[1].get_nparray())
    assert len(lists[0]) == len(lists[1]) > 1000
    for lst in lists:
        lst.set_n_elements(17)
    assert _same(lists[0].copy().get_nparray(), lists[1].get_nparray())
    assert lists[0] == lists[1] and str(lists[0]) == str(lists[1])
    assert _same(lists[0][3:9], lists[1][3:9])


def test_hash_tables_and_counters():
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 300, 2000).astype(np.uint64)
    values = rng.integers(0, 10 ** 6, 2000)
    tables = [m.HashTable(keys, values) for m in (containers,
                                                  jax_containers)]
    for key in (int(keys[0]), int(keys[7]), 10 ** 9):
        assert _same(tables[0][np.uint64(key)], tables[1][np.uint64(key)])
    with pytest.raises(ValueError, match="repeated"):
        tables[0][keys[:5]]
    uniq = np.unique(keys)
    unique_tables = [m.HashTable(uniq, np.arange(len(uniq)) * 3)
                     for m in (containers, jax_containers)]
    q = np.concatenate([uniq[:50], [10 ** 9]]).astype(np.uint64)
    assert _same(unique_tables[0][q], unique_tables[1][q])
    seen = np.random.default_rng(3).integers(0, 400, 5000).astype(np.uint64)
    counters = [m.Counter(uniq, values=1) for m in (containers,
                                                    jax_containers)]
    for c in counters:
        c.count(seen)
    assert _same(counters[0].values(), counters[1].values())
    assert _same(counters[0][q], counters[1][q])
    assert _same(counters[0][q[0]], counters[1][q[0]])
    assert _same(counters[0].keys(), counters[1].keys())
    weighted = [m.Counter(keys, values=values) for m in (containers,
                                                         jax_containers)]
    assert _same(weighted[0].values(), weighted[1].values())
    sets = [m.NpSet(keys) for m in (containers, jax_containers)]
    for item in (int(keys[5]), 10 ** 9):
        assert (item in sets[0]) == (item in sets[1])
    columns = {"nodes": rng.integers(0, 99, 2000),
               "offsets": rng.integers(0, 9, 2000)}
    multi = [m.MultiValueHashTable.from_keys_and_values(keys, columns)
             for m in (containers, jax_containers)]
    for key in (int(keys[11]), 10 ** 9):
        got, want = multi[0][np.uint64(key)], multi[1][np.uint64(key)]
        assert sorted(got) == sorted(want)
        for name in got:
            assert _same(got[name], want[name])
    assert _same(multi[0].row_keys(), keys)
    assert _same(multi[0].get_unique_keys(), multi[1].get_unique_keys())
    assert _same(multi[0].get_all_keys(), multi[1].get_all_keys())


def test_hash_maps(tmp_path):
    rng = np.random.default_rng(4)
    hashes = np.sort(rng.integers(1, 10 ** 9, 500))
    maps = [m.ModuloHashMap.from_sorted_array(hashes, modulo=10007)
            for m in (containers, jax_containers)]
    assert _same(maps[0]._hashes, maps[1]._hashes)
    for key in (int(hashes[3]), 5):
        assert maps[0].hash(key, 10007) == maps[1].hash(key, 10007)
    logn = [m.LogNHashMap(hashes) for m in (containers, jax_containers)]
    for key in (int(hashes[3]), 5):
        assert logn[0].hash(key) == logn[1].hash(key)
    logn[0].to_file(tmp_path / "map")
    back = jax_containers.LogNHashMap.from_file(tmp_path / "map")
    assert _same(back._hashes, logn[1]._hashes)
    assert back.unhash(4) == logn[0].unhash(4)


# -- graph, position ids, critical paths ------------------------------------------

_SEQS = {1: "CCCCC", 2: "G", 3: "", 4: "ACT", 5: "", 6: "GC", 7: "A",
         8: "T", 9: "G", 10: "GGG"}
_EDGES = {1: [2, 3], 2: [4], 3: [4], 4: [5, 6], 5: [7], 6: [7], 7: [8, 9],
          8: [10], 9: [10]}
_REF = [1, 2, 4, 7, 8, 10]


def _graphs(**kwargs):
    return (port_pkg.Graph.from_dicts(_SEQS, _EDGES, _REF, **kwargs),
            jax_pkg.Graph.from_dicts(_SEQS, _EDGES, _REF, **kwargs))


def _assert_graphs_equal(a, b):
    for name in GRAPH_ARRAYS:
        assert _same(getattr(a, name), getattr(b, name)), name
    assert a.chromosome_names == b.chromosome_names


def test_graph_from_dicts_and_accessors():
    port, ref = _graphs(allele_frequencies={2: 0.25, 3: 0.75},
                        chromosome_names=["chr7"])
    _assert_graphs_equal(port, ref)
    assert port.n_nodes() == ref.n_nodes() == 11
    assert port.chromosome_start_nodes == ref.chromosome_start_nodes
    assert port.linear_ref_nodes() == ref.linear_ref_nodes()
    assert port.linear_ref_length() == ref.linear_ref_length()
    for got, want in zip(port.linear_ref_sequence(),
                         ref.linear_ref_sequence(), strict=True):
        assert _same(got, want)
    for node in range(1, 11):
        assert _same(port.get_edges(node), ref.get_edges(node))
        assert _same(port.get_reverse_edges(node),
                     ref.get_reverse_edges(node))
        assert port.n_in_edges(node) == ref.n_in_edges(node)
        assert port.get_node_sequence(node) == ref.get_node_sequence(node)
        assert port.get_node_size(node) == ref.get_node_size(node)
        assert (port.is_linear_ref_node_or_linear_ref_dummy_node(node)
                == ref.is_linear_ref_node_or_linear_ref_dummy_node(node))
        assert (port.get_node_allele_frequency(node)
                == ref.get_node_allele_frequency(node))
    assert port.get_node_subsequence(4, 1, 3) == "ct"
    assert port.get_numeric_base_sequence(4, 1) == 1
    for offset in (0, 4, 5, 9, 12):
        assert (port.get_node_at_ref_offset(offset)
                == ref.get_node_at_ref_offset(offset))
        assert (port.get_node_offset_at_ref_offset(offset)
                == ref.get_node_offset_at_ref_offset(offset))
        for chrom in ("chr7", "7", 1):
            assert (port.get_node_at_chromosome_and_chromosome_offset(
                chrom, offset) == ref.
                get_node_at_chromosome_and_chromosome_offset(chrom, offset))
    got = port_pkg.PositionId.from_graph(port)
    want = jax_pkg.PositionId.from_graph(ref)
    assert _same(got._start_ids, want._start_ids)
    assert _same(got.get([1, 3, 10], [4, 0, 2]), want.get([1, 3, 10],
                                                          [4, 0, 2]))


@pytest.mark.parametrize("seed,indels", [(0, 0.0), (3, 0.3), (12, 1.0)])
def test_random_snp_graph_and_critical_paths(seed, indels):
    port, port_v2n = random_snp_graph(3000, 40, seed=seed,
                                      indel_fraction=indels)
    ref, ref_v2n = jax_random_snp_graph(3000, 40, seed=seed,
                                        indel_fraction=indels)
    _assert_graphs_equal(port, ref)
    assert _same(port_v2n.ref_nodes, ref_v2n.ref_nodes)
    assert _same(port_v2n.var_nodes, ref_v2n.var_nodes)
    assert len(port_v2n) == len(list(port_v2n)) == len(ref_v2n) >= 39
    for k in (4, 31):
        got = port_pkg.CriticalGraphPaths.from_graph(port, k)
        want = jax_pkg.CriticalGraphPaths.from_graph(ref, k)
        assert _same(got.nodes, want.nodes)
        assert _same(got.offsets, want.offsets)
        assert len(got) == len(want) > 0 and list(got) == list(want)
        assert _same(got.dense_index(port.n_nodes() + 5),
                     want.dense_index(ref.n_nodes() + 5))
        for a, b in zip(got.reversed_points(), want.reversed_points(),
                        strict=True):
            assert _same(a, b)
        node, offset = list(got)[len(got) // 2]
        assert got.is_critical(node, offset)
        assert not got.is_critical(node, offset + 1)
    assert len(port_pkg.CriticalGraphPaths.empty()) == 0


# -- files written by one package, read by the other ---------------------------

@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_graph_files_cross_packages(tmp_path, writer, reader):
    pkgs = {"port": port_pkg, "jax": jax_pkg}
    w, r = pkgs[writer], pkgs[reader]
    graph = w.Graph.from_dicts(_SEQS, _EDGES, _REF,
                               chromosome_names=["chrX"])
    graph.to_file(tmp_path / "graph")
    back = r.Graph.from_file(tmp_path / "graph")
    _assert_graphs_equal(back, graph)
    cpaths = w.CriticalGraphPaths.from_graph(graph, 3)
    cpaths.to_file(tmp_path / "crit")
    back = r.CriticalGraphPaths.from_file(tmp_path / "crit")
    assert _same(back.nodes, cpaths.nodes)
    assert _same(back.offsets, cpaths.offsets)
    v2n = w.VariantToNodes(np.array([2, 6], np.int32),
                           np.array([3, 5], np.int32))
    v2n.to_file(tmp_path / "v2n")
    back = r.VariantToNodes.from_file(tmp_path / "v2n")
    assert _same(back.ref_nodes, v2n.ref_nodes)
    assert _same(back.var_nodes, v2n.var_nodes)


def _flat_columns(seed=0, n=400):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 1 << 62, n).astype(np.uint64),
            rng.integers(1, 500, n).astype(np.uint32),
            rng.integers(0, 1 << 40, n).astype(np.uint64),
            rng.random(n).astype(np.single))


_FLAT_KEYS = ("hashes", "nodes", "ref_offsets", "allele_frequencies")


@pytest.mark.parametrize("columns", ["numpy", "tensors"])
def test_flat_kmers_files_cross_packages(tmp_path, columns):
    cols = _flat_columns()
    jax_pkg.FlatKmers(*cols).to_file(tmp_path / "jax.npz")
    if columns == "numpy":
        port = port_pkg.FlatKmers(*cols)
    else:  # as a device finalize leaves them
        port = port_pkg.FlatKmers(
            torch.from_numpy(cols[0].view(np.int64)),
            torch.from_numpy(cols[1].astype(np.int32)),
            torch.from_numpy(cols[2].view(np.int64)),
            torch.from_numpy(cols[3]))
    port.to_file(tmp_path / "port.npz")
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path
                                                     / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files) == sorted(_FLAT_KEYS)
        for key in _FLAT_KEYS:
            if columns == "tensors" and key == "nodes":
                # the JAX package's device rows carry int32 nodes too
                assert b[key].dtype == np.int32
                assert np.array_equal(a[key], b[key])
            else:
                assert _same(a[key], b[key]), key
    if columns == "numpy":
        assert ((tmp_path / "jax.npz").read_bytes()
                == (tmp_path / "port.npz").read_bytes())
    back = jax_pkg.FlatKmers.from_file(tmp_path / "port.npz")
    there = port_pkg.FlatKmers.from_file(tmp_path / "jax")
    for attr, col in zip(("_hashes", "_nodes", "_ref_offsets",
                          "_allele_frequencies"), cols):
        assert np.array_equal(getattr(back, attr), col)
        assert _same(getattr(there, attr), col)
    assert len(port) == len(back) == 400


@pytest.mark.parametrize("columns", ["numpy", "tensors"])
def test_flat_kmers_transforms(columns):
    rng = np.random.default_rng(6)
    hashes = rng.integers(0, 150, 600).astype(np.uint64)
    cols = (hashes,) + _flat_columns(6, 600)[1:]
    ref = jax_pkg.FlatKmers(*cols)
    if columns == "numpy":
        port = port_pkg.FlatKmers(*cols)
    else:
        port = port_pkg.FlatKmers(
            torch.from_numpy(cols[0].view(np.int64)),
            torch.from_numpy(cols[1].astype(np.int32)),
            torch.from_numpy(cols[2].view(np.int64)),
            torch.from_numpy(cols[3]))
    pairs = [(port.get_new_without_singletons(),
              ref.get_new_without_singletons()),
             (port.get_reverse_complement_flat_kmers(9),
              ref.get_reverse_complement_flat_kmers(9))]
    for got, want in pairs:
        assert 0 < len(got) == len(want)
        for attr in ("_hashes", "_nodes", "_ref_offsets",
                     "_allele_frequencies"):
            assert np.array_equal(
                host_column(getattr(got, attr), unsigned=True),
                getattr(want, attr)), attr
    merged = port_pkg.FlatKmers.from_multiple_flat_kmers(
        [port, pairs[0][0]], consume=False)
    want = jax_pkg.FlatKmers.from_multiple_flat_kmers([ref, pairs[0][1]])
    for attr in ("_hashes", "_nodes", "_ref_offsets", "_allele_frequencies"):
        assert _same(getattr(merged, attr), getattr(want, attr)), attr
    assert port.describtion()[:40] == ref.describtion()[:40]
