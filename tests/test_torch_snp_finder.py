"""SnpKmerFinder of the port against the JAX package's: the same graphs and
flags through both, every column and ``kmers_found`` equal, with the sweep's
tape hashed on the host and by K1's plain twin (``use_device=True`` on the
CPU). Mirrors tests/test_snp_finder.py on the port."""
from collections import Counter as C

import jax  # noqa: F401  (same process set-up as the other port tests)
import numpy as np
import pytest
import torch

import graph_kmer_index_tpu as jgki
import graph_kmer_index_tpu_torch as tgki
from graph_kmer_index_tpu import snp_finder as jsnp
from graph_kmer_index_tpu_torch import snp_finder as tsnp
from graph_kmer_index_tpu_torch.hashing import (
    kmer_hash_to_reverse_complement_hash, sequence_to_kmer_hash)

torch.set_num_threads(2)

COLUMNS = ("_hashes", "_nodes", "_ref_offsets", "_allele_frequencies")


def _assert_flat_equal(got, want):
    for name in COLUMNS:
        a, b = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def _both(dicts, kwargs, force=False):
    """find_kmers of the JAX finder and of the port's (host hashing and
    the twin of K1), compared; returns the port's finder and rows."""
    jfinder = jgki.SnpKmerFinder(jgki.Graph.from_dicts(*dicts), **kwargs)
    want = jfinder.find_kmers(_force_branch_walk=force)
    for use_device in (False, True):
        tfinder = tgki.SnpKmerFinder(tgki.Graph.from_dicts(*dicts),
                                     use_device=use_device, device="cpu",
                                     **kwargs)
        got = tfinder.find_kmers(_force_branch_walk=force)
        _assert_flat_equal(got, want)
        assert tfinder.kmers_found == jfinder.kmers_found
        for counter in ("_n_kmers_pruned", "_n_kmers_skipped",
                        "_n_skipped_due_to_frequency",
                        "_n_skipped_due_to_max_variant_nodes",
                        "_n_skipped_whitelist", "_n_skipped_blacklist_nodes"):
            assert getattr(tfinder, counter) == getattr(jfinder, counter)
    return tfinder, got


SNP = ({1: "ACTG", 2: "A", 3: "G", 4: "AAAT"},
       {1: [2, 3], 2: [4], 3: [4]}, [1, 2, 4])
INDEL = ({1: "ACTG", 2: "A", 3: "", 4: "TAAT"},
         {1: [2, 3], 2: [4], 3: [4]}, [1, 2, 4])
LONG = ({1: "gggggaggcttgtggttagcagagagtgggtggaagacagaggtttgag",
         2: "ga",
         3: "gagagagacccaggggagaaaaccagctgcagaggcaggaggggtccag"
            "ggcagcccgaggccagagatgggcgtcttccttacagccacctgtggtccc",
         100: ""},
        {1: [2, 100], 2: [3], 100: [3]}, [1, 2, 3])
FLAGS = ({1: "ACTG", 2: "A", 3: "G", 4: "AAATCCGG"},
         {1: [2, 3], 2: [4], 3: [4]}, [1, 2, 4])


def test_simple_snp_graph():
    finder, _ = _both(SNP, dict(k=3))
    assert finder.has_kmer("ACT", {1})
    assert finder.has_kmer("GAA", {1, 2, 4})
    assert finder.has_kmer("GGA", {1, 3, 4})
    assert finder.has_kmer("AAT", {4})


def test_indel_graph():
    _, flat = _both(INDEL, dict(k=3))
    index = tgki.KmerIndex.from_flat_kmers(flat, modulo=1021, device="cpu")
    assert sorted(index.get(sequence_to_kmer_hash("GTA"))[0].tolist()) == \
        [1, 3, 4]
    assert sorted(index.get(sequence_to_kmer_hash("GAT"))[0].tolist()) == \
        [1, 2, 4]


def test_long_nodes_k31():
    _, flat = _both(LONG, dict(k=31))
    assert len(flat._hashes) > 0


def test_whitelist_filters_kmers():
    wl = {sequence_to_kmer_hash("ACT"), sequence_to_kmer_hash("GAA")}
    _, flat = _both(FLAGS, dict(k=3, whitelist=wl))
    got = set(int(x) for x in flat._hashes)
    assert got
    for g in got:
        assert g in wl or kmer_hash_to_reverse_complement_hash(g, 3) in wl


def test_skip_kmers_with_nodes():
    _, flat = _both(FLAGS, dict(k=3, skip_kmers_with_nodes={3}))
    assert 3 not in set(int(n) for n in flat._nodes)


def test_max_frequency_caps_repeats():
    _, flat = _both(FLAGS, dict(k=3, max_frequency=1))
    pairs = set(zip((int(x) for x in flat._hashes),
                    (int(r) for r in flat._ref_offsets)))
    assert max(C(h for h, _ in pairs).values()) <= 1


def test_only_save_one_node_per_kmer_and_include_revcomp():
    _, flat = _both(FLAGS, dict(k=3, include_reverse_complements=True,
                                only_save_one_node_per_kmer=True))
    hashes = [int(x) for x in flat._hashes]
    assert len(hashes) % 2 == 0
    for i in range(0, len(hashes), 2):
        assert hashes[i + 1] == kmer_hash_to_reverse_complement_hash(
            hashes[i], 3)


def test_only_add_variant_kmers():
    finder, flat = _both(FLAGS, dict(k=3, only_add_variant_kmers=True))
    assert len(flat._hashes) > 0
    for found in finder.kmers_found:
        assert any(n in (2, 3) for n in found[1]), found


@pytest.mark.parametrize("flags", [
    dict(only_save_variant_nodes=True), dict(only_store_nodes={2, 4}),
    dict(max_variant_nodes=1), dict(max_variant_nodes=0),
    dict(max_kmers_same_position=0), dict(start_position=3, end_position=9),
    dict(spacing=2, include_reverse_complements=True)])
def test_other_flags(flags):
    _both(FLAGS, dict(k=3, **flags))


def test_pruning_skips_nearby_novel_ref_kmers():
    rng = np.random.default_rng(0)
    seq = "".join(rng.choice(list("ACGT"), size=400))
    dicts = ({1: seq}, {}, [1])
    _, plain = _both(dicts, dict(k=6))
    _, pruned = _both(dicts, dict(k=6, pruning=True))
    assert len(pruned._hashes) < len(plain._hashes) / 10


def _random_graph(rng):
    """An alternating ref / SNP-or-indel graph (tests/test_snp_finder.py)."""
    seqs, edges, linear = {}, {}, []
    nid, tail = 1, None
    for seg in range(int(rng.integers(2, 10))):
        seqs[nid] = "".join(rng.choice(list("acgt"),
                                       size=int(rng.integers(1, 12))))
        linear.append(nid)
        for t in tail or []:
            edges.setdefault(t, []).append(nid)
        seg_node = nid
        nid += 1
        if rng.random() < 0.75 and seg < 8:
            ref_arm, var_arm = nid, nid + 1
            seqs[ref_arm] = str(rng.choice(list("acgt")))
            seqs[var_arm] = ("" if rng.random() < 0.3
                             else str(rng.choice(list("acgt"))))
            edges[seg_node] = [ref_arm, var_arm]
            linear.append(ref_arm)
            tail = [ref_arm, var_arm]
            nid += 2
        else:
            tail = [seg_node]
    return seqs, edges, linear


@pytest.mark.parametrize("trial", range(12))
def test_sweep_and_branch_walk_match_jax_on_random_graphs(trial):
    """Both packages, both the vectorized sweep and the forced branch walk,
    rows and order."""
    rng = np.random.default_rng(100 + trial)
    dicts = _random_graph(rng)
    for k, spacing in ((4, None), (6, 2), (3, 1)):
        kwargs = dict(k=k, spacing=spacing)
        if trial % 3 == 0:
            kwargs["include_reverse_complements"] = True
        if trial % 5 == 0:
            kwargs["max_frequency"] = 2
        if trial % 7 == 0:
            kwargs["pruning"] = True
        _, fast = _both(dicts, kwargs)
        _, slow = _both(dicts, kwargs, force=True)
        _assert_flat_equal(fast, slow)


def test_short_ref_with_revcomp_and_whitelist():
    dicts = ({1: "ACTG", 2: "A", 3: "ATTTTTTTTTTTTTTTT", 4: "AT"},
             {1: [2, 3], 2: [4], 3: [4]}, [1, 2, 4])  # ref len 7 < k
    _, flat = _both(dicts, dict(k=15, spacing=2))
    _, flat_rc = _both(dicts, dict(k=15, spacing=2,
                                   include_reverse_complements=True))
    _, flat_wl = _both(dicts, dict(k=15, spacing=2, whitelist={0}))
    assert len(flat._hashes) > 0
    assert len(flat_rc._hashes) == 2 * len(flat._hashes)
    assert len(flat_wl._hashes) <= len(flat._hashes)


def test_dense_finder_rejects_only_store_variant_nodes():
    g = tgki.Graph.from_dicts({1: "ACTGAC"}, {}, [1])
    with pytest.raises(NotImplementedError):
        tgki.DenseKmerFinder(g, k=3, only_store_variant_nodes=True)


def test_linear_reference_mode_and_single_position():
    rng = np.random.default_rng(3)
    reference = "".join(rng.choice(list("ACGT"), size=300))
    for kwargs in (dict(k=7, spacing=3), dict(k=7, spacing=1,
                                              start_position=10,
                                              end_position=200)):
        want = jgki.SnpKmerFinder(None, reference=reference,
                                  **kwargs).find_kmers()
        got = tgki.SnpKmerFinder(None, reference=reference,
                                 **kwargs).find_kmers()
        _assert_flat_equal(got, want)
    jfinder = jgki.SnpKmerFinder(jgki.Graph.from_dicts(*FLAGS), k=3)
    tfinder = tgki.IndelKmerFinder(tgki.Graph.from_dicts(*FLAGS), k=3)
    for pos in (0, 2, 5):
        jfinder.find_kmers_from_linear_ref_position(pos)
        tfinder.find_kmers_from_linear_ref_position(pos)
    _assert_flat_equal(tfinder.get_flat_kmers(), jfinder.get_flat_kmers())
    assert tfinder.kmers_found == jfinder.kmers_found


def test_linear_ref_specials_match_jax():
    rng = np.random.default_rng(5)
    dicts = _random_graph(rng)
    assert np.array_equal(
        tsnp.linear_ref_specials(tgki.Graph.from_dicts(*dicts)),
        jsnp.linear_ref_specials(jgki.Graph.from_dicts(*dicts)))


def test_device_selection():
    """``use_device=None`` hashes on the host unless the device is a CUDA
    device and the reference is long; ``use_device=True`` needs a device."""
    graph = tgki.Graph.from_dicts(*FLAGS)
    calls = []
    real = tsnp.sliding_window_hashes

    def spy(seq, k):
        calls.append(len(seq))
        return real(seq, k)

    finder = tgki.SnpKmerFinder(graph, k=3, device="cpu")
    try:
        tsnp.sliding_window_hashes = spy
        finder.find_kmers()
    finally:
        tsnp.sliding_window_hashes = real
    assert calls, "a CPU device with use_device=None hashes on the host"
    with pytest.raises(ValueError, match="explicit device"):
        tgki.SnpKmerFinder(graph, k=3, use_device=True).find_kmers()


def test_long_reference_against_the_jax_device_branch():
    """A linear reference of 2^20 bases and more takes the JAX sweep's
    device branch (its u32-lane hashing program); the port hashes the same
    tape with K1's twin. A few SNPs, a wide spacing: the rows are equal."""
    rng = np.random.default_rng(11)
    n = (1 << 20) + 5000
    bases = rng.integers(0, 4, n)
    seq = "".join(np.array(list("ACGT"))[bases])
    cuts = [200_000, 600_001, 1_000_000]
    nodes, edges, ref = {}, {}, []
    nid, cursor, tails = 1, 0, []
    for cut in cuts:
        seg, a, b = nid, nid + 1, nid + 2
        nodes[seg] = seq[cursor:cut]
        nodes[a] = seq[cut]
        nodes[b] = "ACGT"[(bases[cut] + 1) % 4]
        for t in tails:
            edges[t] = [seg]
        edges[seg] = [a, b]
        ref += [seg, a]
        tails, cursor, nid = [a, b], cut + 1, nid + 3
    nodes[nid] = seq[cursor:]
    for t in tails:
        edges[t] = [nid]
    ref.append(nid)
    kwargs = dict(k=31, spacing=4001)
    jfinder = jgki.SnpKmerFinder(jgki.Graph.from_dicts(nodes, edges, ref),
                                 **kwargs)
    assert jfinder.graph.linear_ref_length() >= 1 << 20
    want = jfinder.find_kmers()
    tfinder = tgki.SnpKmerFinder(tgki.Graph.from_dicts(nodes, edges, ref),
                                 use_device=True, device="cpu", **kwargs)
    got = tfinder.find_kmers()
    _assert_flat_equal(got, want)
    assert len(got._hashes) > 250 and tfinder.kmers_found == \
        jfinder.kmers_found
