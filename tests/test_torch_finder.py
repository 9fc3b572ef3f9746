"""Port parity: graph_kmer_index_tpu_torch.finder.DenseKmerFinder against
the JAX package's on the graphs of tests/test_kmer_finder.py, by the native
C++ span walker and by the Python walker: the span stream, all five result
columns (k-mers, nodes, start nodes, start offsets, allele frequencies),
both FlatKmers versions and the debug list. Exact equality."""
import jax  # noqa: F401  (same process set-up as the other port tests)
import numpy as np
import pytest
import torch

from graph_kmer_index_tpu import DenseKmerFinder as JaxFinder
from graph_kmer_index_tpu import Graph as JaxGraph
from graph_kmer_index_tpu.utils.synthetic import (
    random_snp_graph as jax_random_snp_graph)

from graph_kmer_index_tpu_torch import DenseKmerFinder, Graph, native
from graph_kmer_index_tpu_torch.utils.synthetic import random_snp_graph

torch.set_num_threads(2)

_SNP = ({1: [2, 3], 2: [4], 3: [4]})
_DUMMIES = ({1: "ACT", 2: "", 3: "GGG", 4: "", 5: "A", 6: "CCC"},
            {1: [2, 3], 2: [4, 5], 3: [4, 5], 4: [6], 5: [6]}, [1, 5, 6])

# name: (node sequences, edges, linear reference, k, finder kwargs,
#        None for find() or the (node, offset) to start at)
CASES = {
    "very_simple": ({0: "AAA", 1: "C", 2: "T", 3: "AAA"},
                    {0: [1, 2], 2: [3], 1: [3]}, [0, 1, 3], 3, {}, None),
    "simple": ({0: "ACTGACTG", 1: "A", 2: "T", 3: "AAAAA", 4: "C", 5: "T",
                6: "TGGGGG"},
               {0: [1, 2], 2: [3], 1: [3], 3: [4, 5], 4: [6], 5: [6]},
               [0, 1, 3, 4, 6], 3, {}, None),
    "nested_paths": ({0: "AAA", 1: "C", 2: "T", 3: "AAAA", 4: "C", 5: "G",
                      6: "AAA", 7: "TTT"},
                     {0: [1, 2, 7], 1: [3], 2: [3], 3: [4, 5], 4: [6],
                      5: [6], 7: [6]}, [0, 1, 3, 4, 6], 3, {}, None),
    "long_node": ({1: "ATC", 2: "AAAAAAAA", 3: "T", 4: "CTA"}, _SNP,
                  [1, 2, 4], 3, {}, None),
    "empty_dummy_nodes": ({1: "ACT", 2: "C", 3: "", 4: "ACT"},
                          {1: [2, 3], 3: [4], 2: [4]}, [1, 2, 4], 3, {},
                          None),
    "empty_dummy_nodes2": ({1: "AAAAA", 2: "", 3: "CCCCCC"},
                           {1: [2], 2: [3]}, [1, 3], 3, {}, None),
    "empty_dummy_nodes3": ({1: "AAAAA", 2: "G", 3: "", 4: "CCCCCC"},
                           {1: [2], 2: [3], 3: [4]}, [1, 2, 4], 3, {},
                           None),
    "empty_dummy_nodes4": ({1: "CC", 2: "", 3: "CCTCTG"}, {1: [2], 2: [3]},
                           [1, 3], 4, {}, (1, 0)),
    "multiple_critical_points": (
        {1: "CCCCC", 2: "G", 3: "", 4: "ACT", 5: "", 6: "GC", 7: "A",
         8: "T", 9: "G", 10: "GGG"},
        {1: [2, 3], 2: [4], 3: [4], 4: [5, 6], 5: [7], 6: [7], 7: [8, 9],
         8: [10], 9: [10]}, [1, 2, 4, 7, 8, 10], 3, {}, None),
    "two_long_nodes1": ({1: "CCCCCCCCCC", 2: "AAAA"}, {1: [2]}, [1, 2], 3,
                        {}, None),
    "two_long_nodes2": ({1: "CATGCATGCCTG", 2: "CCAAG"}, {1: [2]}, [1, 2],
                        5, {}, None),
    "neighbouring_dummy_nodes": (*_DUMMIES, 3, {}, None),
    "max_variant_nodes_0": (*_DUMMIES, 3, {"max_variant_nodes": 0}, None),
    "max_variant_nodes_1": (*_DUMMIES, 3, {"max_variant_nodes": 1}, None),
    "snp_and_long_node": ({1: "ACTACTACTACT", 2: "G", 3: "C", 4: "GCAGCA"},
                          _SNP, [1, 2, 4], 3, {}, None),
    "large_k": ({1: "G" * 100, 2: "C", 3: "T", 4: "G" * 10}, _SNP,
                [1, 2, 4], 31, {}, None),
    "from_position_k3": ({1: "ACTACT", 2: "G", 3: "C", 4: "GCAGCA"}, _SNP,
                         [1, 2, 4], 3, {"only_store_nodes": {2, 3}}, (1, 4)),
    "from_position_k5": ({1: "ACTACT", 2: "G", 3: "C", 4: "GCAGCA"}, _SNP,
                         [1, 2, 4], 5, {"only_store_nodes": {2, 3}}, (1, 5)),
    "special_case": ({1: "taacccctaacccctaaccctaaccctaac", 2: "", 3: "G",
                      4: "ccctaaccctaaccctaacccctaacccta"}, _SNP, [1, 4], 31,
                     {"only_store_nodes": {2, 3}}, (1, 22)),
    "indel": ({1: "ACTGA", 2: "", 3: "C", 4: "GGGGGGGGG"}, _SNP, [1, 4], 9,
              {"only_store_nodes": {2, 3}}, (1, 2)),
    "snp_and_indel": (
        {1: "ACTGAACTG", 2: "A", 3: "C", 4: "GGGG", 5: "", 6: "T",
         7: "CCCCCC"},
        {1: [3, 2], 2: [4], 3: [4], 4: [5, 6], 5: [7], 6: [7]},
        [1, 2, 4, 6, 7], 13,
        {"only_store_nodes": {5, 6}, "max_variant_nodes": 5}, (1, 6)),
    "some_case": (
        {1: "AAAAAACTG", 2: "A", 3: "G", 4: "GC", 5: "T", 6: "C",
         7: "TGAGCCCCC", 8: "A", 9: "T", 10: "AAAAA"},
        {1: [2, 3], 2: [4], 3: [4], 4: [5, 6], 5: [7], 6: [7], 7: [8, 9],
         9: [10], 8: [10]}, [1, 2, 4, 5, 7, 8, 10], 5, {}, None),
    "case1_row_order": (
        {0: "AGTAGA", 1: "G", 2: "CT", 3: "ACTA", 5: "G", 6: "A",
         7: "TCATA"},
        {0: [1, 2], 1: [3], 2: [3], 3: [5, 6], 5: [7], 6: [7], 7: []},
        [0, 1, 3, 5, 7], 3, {}, None),
    "save_one_node": (
        {0: "AGTAGA", 1: "G", 2: "CT", 3: "ACTA", 5: "G", 6: "A",
         7: "TCATA"},
        {0: [1, 2], 1: [3], 2: [3], 3: [5, 6], 5: [7], 6: [7], 7: []},
        [0, 1, 3, 5, 7], 3, {"only_save_one_node_per_kmer": True}, None),
}
_SPANS = ("_tape", "_span_tape_start", "_span_n_windows", "_span_node",
          "_span_first_offset", "_span_nodes_len", "_span_nodes")


def _run(finder_cls, graph, k, kwargs, start, use_native):
    finder = finder_cls(graph, k=k, **kwargs)
    if start is None:
        finder.find(use_native=use_native)
    else:
        finder.find_only_kmers_starting_at_position(*start,
                                                    use_native=use_native)
    return finder


def _assert_same(port, ref, what):
    for name in _SPANS:
        assert np.array_equal(getattr(port, name).get_nparray(),
                              getattr(ref, name).get_nparray()), (what, name)
    for i, (got, want) in enumerate(zip(port._results(), ref._results(),
                                        strict=True)):
        assert got.dtype == want.dtype, (what, i)
        assert np.array_equal(got, want), (what, i)
    assert list(port.kmers_found) == list(ref.kmers_found), what
    for v in ("1", "0"):
        got, want = port.get_flat_kmers(v=v), ref.get_flat_kmers(v=v)
        for col in ("_hashes", "_nodes", "_ref_offsets",
                    "_allele_frequencies"):
            a, b = getattr(got, col), getattr(want, col)
            assert a.dtype == b.dtype and np.array_equal(a, b), (what, v, col)
    got, want = port.get_flat_kmers(), ref.get_flat_kmers()
    for col in ("_hashes", "_start_nodes", "_start_offsets", "_nodes",
                "_allele_frequencies"):
        assert np.array_equal(getattr(got, col), getattr(want, col)), col


@pytest.mark.parametrize("walker", ["native", "python"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_finder_matches_jax(case, walker):
    assert native.available(), "the native library must build for this test"
    seqs, edges, ref, k, kwargs, start = CASES[case]
    use_native = walker == "native"
    port = _run(DenseKmerFinder, Graph.from_dicts(seqs, edges, ref), k,
                kwargs, start, use_native)
    want = _run(JaxFinder, JaxGraph.from_dicts(seqs, edges, ref), k, kwargs,
                start, use_native)
    if start is None:
        assert port.used_native_walker == use_native
    assert len(port._results()[0]) > 0
    _assert_same(port, want, (case, walker))


def test_case1_exact_row_order():
    """The strongest ordering contract of tests/test_kmer_finder.py, on the
    port alone."""
    from graph_kmer_index_tpu_torch.hashing import kmer_hash_to_sequence
    seqs, edges, ref, k, kwargs, _ = CASES["case1_row_order"]
    finder = DenseKmerFinder(Graph.from_dicts(seqs, edges, ref), k=k)
    finder.find()
    kmers, nodes = finder.get_found_kmers_and_nodes()
    rows = [(kmer_hash_to_sequence(int(h), 3).upper(), int(n))
            for h, n in zip(kmers, nodes)]
    assert rows[:9] == [("AGT", 0), ("GTA", 0), ("TAG", 0), ("AGA", 0),
                        ("GAG", 0), ("GAG", 1), ("AGA", 0), ("AGA", 1),
                        ("AGA", 3)]
    assert len(rows) == 38 and rows[-1] == ("ATA", 7)


@pytest.mark.parametrize("path", ["small", "vector", "native", "device"])
@pytest.mark.parametrize("filters", ["none", "save_one", "store_nodes"])
def test_finalize_paths_match_jax(path, filters):
    """Every finalize route of the port (scalar, vectorized numpy, native
    finalize_rows, and the device hashing branch: K1's twin on a CPU
    tensor) against the JAX package's vectorized route, on random
    SNP/indel graphs."""
    rng = np.random.default_rng(31337)
    for _ in range(3):
        seed = int(rng.integers(0, 1 << 30))
        graph, v2n = random_snp_graph(1500, 20, seed=seed,
                                      indel_fraction=0.4)
        jax_graph, _ = jax_random_snp_graph(1500, 20, seed=seed,
                                            indel_fraction=0.4)
        kwargs = {"none": {},
                  "save_one": {"only_save_one_node_per_kmer": True},
                  "store_nodes": {"only_store_nodes": set(
                      int(v) for v in v2n.var_nodes[:10])}}[filters]
        ref = JaxFinder(jax_graph, k=7, max_variant_nodes=4, **kwargs)
        ref.find()
        ref._finalize(force_path="vector")
        if path == "device":
            port = DenseKmerFinder(graph, k=7, max_variant_nodes=4,
                                   use_device=True, device="cpu", **kwargs)
            port.find()
            port._finalize()
        else:
            port = DenseKmerFinder(graph, k=7, max_variant_nodes=4, **kwargs)
            port.find()
            port._finalize(force_path=path)
        for got, want in zip(port._finalized, ref._finalized, strict=True):
            assert got.dtype == want.dtype and np.array_equal(got, want), (
                seed, path, filters)
        assert list(port.kmers_found) == list(ref.kmers_found)


def test_device_hashing_needs_an_explicit_device():
    seqs, edges, ref, k, _, _ = CASES["case1_row_order"]
    graph = Graph.from_dicts(seqs, edges, ref)
    finder = DenseKmerFinder(graph, k=k, use_device=True)
    finder.find()
    with pytest.raises(ValueError, match="explicit device"):
        finder._finalize(force_path="vector")
    # left to itself a finder without a CUDA device hashes on the host
    auto = DenseKmerFinder(graph, k=k)
    auto.find()
    host = DenseKmerFinder(graph, k=k, use_device=False)
    host.find()
    for a, b in zip(auto._results(), host._results(), strict=True):
        assert np.array_equal(a, b)


def test_whitelist_and_unsupported_flag():
    seqs, edges, ref, k, _, _ = CASES["simple"]
    base = DenseKmerFinder(Graph.from_dicts(seqs, edges, ref), k=k)
    base.find()
    whitelist = set(int(h) for h in base._results()[0][::3])
    port = DenseKmerFinder(Graph.from_dicts(seqs, edges, ref), k=k,
                           whitelist=whitelist)
    port.find()
    want = JaxFinder(JaxGraph.from_dicts(seqs, edges, ref), k=k,
                     whitelist=whitelist)
    want.find()
    for a, b in zip(port._results(), want._results(), strict=True):
        assert np.array_equal(a, b)
    assert port._n_skipped_whitelist == want._n_skipped_whitelist > 0
    with pytest.raises(NotImplementedError):
        DenseKmerFinder(Graph.from_dicts(seqs, edges, ref), k=k,
                        only_store_variant_nodes=True)
