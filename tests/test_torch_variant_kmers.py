"""The VCF side of the port against the JAX package: VcfVariants,
build_graph_from_vcf, UniqueVariantKmersFinder (per-variant and batched selection) and
the structural-variant sampler, on the same seeded inputs, exact equality.
Mirrors tests/test_variant_kmers.py, test_graph_builder.py and
test_structural_variants.py on the port."""
import logging

import jax  # noqa: F401  (same process set-up as the other port tests)
import numpy as np
import pytest
import torch

import graph_kmer_index_tpu as jgki
import graph_kmer_index_tpu_torch as tgki
from graph_kmer_index_tpu_torch.hashing import (letter_sequence_to_numeric,
                                                sequence_to_kmer_hash)

torch.set_num_threads(2)

COLUMNS = ("_hashes", "_nodes", "_ref_offsets", "_allele_frequencies")
GRAPH_ARRAYS = ("sequence", "node_sizes", "seq_start", "edge_targets",
                "edge_index", "linear_ref_mask", "ref_dummy_mask",
                "node_to_ref_offset", "allele_frequencies",
                "chromosome_start_nodes_array")
PACKAGES = (("jax", jgki), ("port", tgki))


def _assert_flat_equal(got, want):
    for name in COLUMNS:
        a, b = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def _assert_graphs_equal(tgraph, jgraph):
    for name in GRAPH_ARRAYS:
        assert np.array_equal(getattr(tgraph, name), getattr(jgraph, name)), \
            name
    assert tgraph.chromosome_names == jgraph.chromosome_names


def _index(pkg, flat, modulo=4099):
    if pkg is tgki:
        return pkg.KmerIndex.from_flat_kmers(flat, modulo=modulo,
                                             device="cpu")
    return pkg.KmerIndex.from_flat_kmers(flat, modulo=modulo)


def _build_both(refs, records):
    """build_graph_from_vcf in both packages over the same records
    (chromosome, position, ref, alt); the graphs and tables are equal."""
    out = {}
    for name, pkg in PACKAGES:
        variants = pkg.VcfVariants([
            pkg.VcfVariant(*r, vcf_line_number=i)
            for i, r in enumerate(records)])
        graph, v2n = pkg.build_graph_from_vcf(refs, variants)
        out[name] = (graph, v2n, variants)
    _assert_graphs_equal(out["port"][0], out["jax"][0])
    for attr in ("ref_nodes", "var_nodes"):
        assert np.array_equal(getattr(out["port"][1], attr),
                              getattr(out["jax"][1], attr))
    return out


# -- variants and build_graph_from_vcf ---------------------------------------------

def test_snp_graph():
    built = _build_both({"1": "ACTGAAATGC"}, [("1", 5, "A", "G")])
    graph, v2n, _ = built["port"]
    ref_node, var_node = int(v2n.ref_nodes[0]), int(v2n.var_nodes[0])
    assert graph.get_node_sequence(ref_node) == "a"
    assert graph.get_node_sequence(var_node) == "g"
    assert graph.linear_ref_length() == 10
    finder = tgki.DenseKmerFinder(graph, k=4)
    finder.find()
    idx = _index(tgki, finder.get_flat_kmers(v="0"), 1021)
    assert idx.get(sequence_to_kmer_hash("GAAA"))[0] is not None
    assert var_node in idx.get(sequence_to_kmer_hash("GGAA"))[0]


def test_insertion_and_deletion():
    built = _build_both({"1": "ACTGAAATGC"},
                        [("1", 4, "G", "GTT"), ("1", 7, "AT", "A")])
    graph, v2n, _ = built["port"]
    ins_ref, ins_alt = int(v2n.ref_nodes[0]), int(v2n.var_nodes[0])
    del_ref, del_alt = int(v2n.ref_nodes[1]), int(v2n.var_nodes[1])
    assert graph.get_node_size(ins_ref) == 0
    assert graph.get_node_sequence(ins_alt) == "tt"
    assert graph.get_node_sequence(del_ref) == "t"
    assert graph.get_node_size(del_alt) == 0
    assert graph.linear_ref_length() == 10


def test_ref_mismatch_overlap_and_unsupported_type_are_skipped():
    built = _build_both(
        {"1": "ACTGACTGACTG"},
        [("1", 2, "G", "T"),             # REF mismatch
         ("1", 4, "GAC", "G"), ("1", 5, "A", "T"),   # the second overlaps
         ("1", 9, "AC", "GT")])           # a substitution: unsupported
    _, v2n, variants = built["port"]
    assert v2n.ref_nodes.tolist()[0] == 0 and v2n.var_nodes.tolist()[0] == 0
    assert v2n.ref_nodes[1] > 0 and v2n.ref_nodes[2] == 0
    assert variants[3].type == "SUBSTITUTION" and v2n.ref_nodes[3] == 0
    assert repr(variants[1]) == repr(built["jax"][2][1])


def _write_case(tmp_path):
    fa = tmp_path / "ref.fa"
    fa.write_text(">1\nACTGAAATGC\n>2\nTTTTCCCC\n")
    vcf = tmp_path / "v.vcf"
    vcf.write_text(
        "##fileformat=VCFv4.2\n"
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
        "1\t3\t.\tT\tG,A\t.\t.\t.\n"
        "1\t7\t.\tA\t<DEL>\t.\t.\t.\n"
        "1\t9\t.\tG\tA\t.\t.\t.\n"
        "2\t3\t.\tT\tA\t.\t.\t.\n")
    return str(fa), str(vcf)


def test_from_files_and_multiallelic_records(tmp_path):
    fa, vcf = _write_case(tmp_path)
    jvariants = jgki.VcfVariants.from_vcf(vcf)
    tvariants = tgki.VcfVariants.from_vcf(vcf)
    as_tuples = lambda vs: [  # noqa: E731
        (v.chromosome, v.position, v.ref_sequence, v.variant_sequence,
         v.type, v.vcf_line_number) for v in vs]
    assert as_tuples(tvariants) == as_tuples(jvariants)
    assert [v[1] for v in as_tuples(tvariants)] == [3, 3, 9, 3]
    assert len(tvariants.get_chunks(3)) == 2 and len(tvariants) == 4
    encoded = tgki.VcfVariants.from_vcf(vcf, dont_encode_chromosomes=False,
                                        limit_to_n_lines=2)
    assert [v.chromosome for v in encoded] == [1, 1]
    jgraph, jv2n = jgki.build_graph_from_files(fa, vcf)
    tgraph, tv2n = tgki.build_graph_from_files(fa, vcf)
    _assert_graphs_equal(tgraph, jgraph)
    assert np.array_equal(tv2n.var_nodes, jv2n.var_nodes)
    assert len(tgraph.chromosome_start_nodes_array) == 2
    assert tgraph.linear_ref_length() == 18
    # both alleles of the tri-allelic site share one ref node
    assert tv2n.ref_nodes[0] == tv2n.ref_nodes[1] > 0


@pytest.mark.parametrize("trial", range(6))
def test_random_multiallelic_and_non_minimal_records(trial):
    rng = np.random.default_rng(900 + trial)
    n = 400
    seq = "".join(rng.choice(list("ACGT"), n))
    records, pos = [], 10
    while pos < n - 12:
        ref = seq[pos - 1]
        kind = rng.random()
        if kind < 0.4:
            alts = rng.permutation([b for b in "ACGT" if b != ref])
            for alt in alts[:int(rng.integers(1, 4))]:
                records.append(("1", pos, ref, str(alt)))
        elif kind < 0.7:   # a non-minimal insertion: two anchor bases
            anchor = seq[pos - 1:pos + 1]
            records.append(("1", pos, anchor, anchor + "TG"))
        else:
            records.append(("1", pos, seq[pos - 1:pos + 3], ref))
        pos += int(rng.integers(5, 30))
    built = _build_both({"1": seq}, records)
    graph = built["port"][0]
    letters = "".join("acgt"[b] for b in graph.linear_ref_sequence()[2])
    assert letters == seq.lower()


def test_multi_chromosome_offset_conversion():
    refs = {"chrA": "ACGTACGTAC", "chrB": "TTTTGGGGCC"}
    built = _build_both(refs, [("chrA", 4, "T", "C"), ("chrB", 6, "G", "A")])
    tg, jg = built["port"][0], built["jax"][0]
    for chrom, offset in (("chrA", 3), ("chrB", 0), ("chrB", 7)):
        assert tg.convert_chromosome_ref_offset_to_graph_ref_offset(
            offset, chrom) == \
            jg.convert_chromosome_ref_offset_to_graph_ref_offset(
                offset, chrom)
        assert tg.get_node_at_chromosome_and_chromosome_offset(
            chrom, offset) == \
            jg.get_node_at_chromosome_and_chromosome_offset(chrom, offset)


# -- signature selection -------------------------------------------------------

SMALL_GRAPH = (
    {1: "AAAAAACTG", 2: "A", 3: "G", 4: "GC", 5: "T", 6: "C",
     7: "TGAGCCCCC", 8: "", 9: "TC", 10: "AAAAA"},
    {1: [2, 3], 2: [4], 3: [4], 4: [5, 6], 5: [7], 6: [7],
     7: [8, 9], 9: [10], 8: [10]},
    [1, 2, 4, 5, 7, 10])
SMALL_VARIANTS = [(1, 10, "A", "G", "SNP"), (1, 13, "T", "C", "SNP"),
                  (1, 22, "C", "CTC", "INDEL")]


def _small_case(pkg, k=5, **kw):
    graph = pkg.Graph.from_dicts(*SMALL_GRAPH)
    v2n = pkg.VariantToNodes(np.array([2, 5, 8]), np.array([3, 6, 9]))
    variants = pkg.VcfVariants([
        pkg.VcfVariant(c, p, r, a, vcf_line_number=i, type=t)
        for i, (c, p, r, a, t) in enumerate(SMALL_VARIANTS)])
    finder = pkg.DenseKmerFinder(graph, k)
    finder.find()
    index = _index(pkg, finder.get_flat_kmers(v="1"))
    assert index.get_frequency(sequence_to_kmer_hash("CTGAG"), k=k) == 2
    return pkg.UniqueVariantKmersFinder(
        graph, v2n, variants, k=k, kmer_index_with_frequencies=index,
        use_dense_kmer_finder=True,
        position_id_index=pkg.PositionId.from_graph(graph), **kw)


def test_kmers_from_position():
    want = _small_case(jgki).find_unique_kmers()
    got = _small_case(tgki).find_unique_kmers()
    _assert_flat_equal(got, want)
    index = _index(tgki, got)
    assert index.get_nodes(sequence_to_kmer_hash("CTGAG")) is None
    reverse = tgki.ReverseKmerIndex.from_flat_kmers(got)
    assert len(reverse.get_node_kmers(2)) > 0
    assert len(reverse.get_node_kmers(3)) > 0


def test_simple_mode():
    want = _small_case(jgki, use_simple=True).find_unique_kmers()
    got = _small_case(tgki, use_simple=True).find_unique_kmers()
    _assert_flat_equal(got, want)
    for node in (2, 3, 5, 6):
        assert node in set(np.asarray(got._nodes).tolist())


def _random_records(rng, n_bases=700, clustered=False):
    ref = "".join(rng.choice(list("ACGT"), size=n_bases))
    records, pos = [], 40
    while pos < n_bases - 60:
        refb = ref[pos - 1]
        r = rng.random()
        if r < 0.55:
            alt = str(rng.choice([b for b in "ACGT" if b != refb]))
            records.append(("1", pos, refb, alt))
        elif r < 0.78:
            ins = "".join(rng.choice(list("ACGT"),
                                     size=int(rng.integers(1, 4))))
            records.append(("1", pos, refb, refb + ins))
        else:
            dl = int(rng.integers(1, 4))
            records.append(("1", pos, ref[pos - 1:pos + dl], refb))
        pos += int(rng.integers(4, 25)) if clustered \
            else int(rng.integers(18, 70))
    return ref, records


def _selectors(built, k, **kw):
    """A factory of finders per package over a scoring index of the
    graph's sweep."""
    make = {}
    for name, pkg in PACKAGES:
        graph, v2n, variants = built[name]
        index = _index(pkg, pkg.SnpKmerFinder(graph, k=k).find_kmers())
        make[name] = (lambda pkg=pkg, graph=graph, v2n=v2n,
                      variants=variants, index=index:
                      pkg.UniqueVariantKmersFinder(
                          graph, v2n, variants, k=k,
                          kmer_index_with_frequencies=index, **kw))
    return make


@pytest.mark.parametrize("trial", range(8))
def test_batched_and_per_variant_selection_match_jax(trial):
    """find_unique_kmers and find_unique_kmers_batched of the port equal
    each other and the JAX package's, bit for bit, on random VCFs:
    isolated bubbles take the vectorized path, clusters the fallback."""
    rng = np.random.default_rng(1100 + trial)
    ref, records = _random_records(rng, clustered=trial % 2 == 1)
    make = _selectors(_build_both({"1": ref}, records), 15)
    jexact = make["jax"]()
    want = jexact.find_unique_kmers()
    texact, tbatched, jbatched = make["port"](), make["port"](), make["jax"]()
    _assert_flat_equal(texact.find_unique_kmers(), want)
    _assert_flat_equal(tbatched.find_unique_kmers_batched(), want)
    jbatched.find_unique_kmers_batched()
    for counter in ("n_batched_variants", "n_fallback_variants",
                    "n_zero_node_variants", "n_failed_variants"):
        assert getattr(tbatched, counter) == getattr(jbatched, counter)
    assert (tbatched.n_batched_variants + tbatched.n_fallback_variants
            + tbatched.n_zero_node_variants) == len(records)
    assert tbatched._nodes_found == texact._nodes_found == \
        jexact._nodes_found
    if trial % 2 == 0:
        assert tbatched.n_batched_variants > 3


@pytest.mark.parametrize("kw", [
    dict(do_not_choose_lowest_frequency_kmers=True),
    dict(max_variant_nodes=1), dict(kmer_index_with_frequencies=None)])
def test_batched_selection_options(kw):
    rng = np.random.default_rng(77)
    ref, records = _random_records(rng)
    make = _selectors(_build_both({"1": ref}, records), 15)
    if "kmer_index_with_frequencies" in kw:
        # no scoring index: everything falls back, and the exact search
        # needs one for its ranking, so only the routing is compared
        finders = {}
        for name, pkg in PACKAGES:
            finder = make[name]()
            finder._kmer_index_with_frequencies = None
            geo = finder._batched_geometry(list(finder.variants))
            finders[name] = geo["eligible"]
        assert np.array_equal(finders["port"], finders["jax"])
        return
    rebuilt = _selectors(_build_both({"1": ref}, records), 15, **kw)
    want = rebuilt["jax"]().find_unique_kmers_batched()
    _assert_flat_equal(rebuilt["port"]().find_unique_kmers_batched(), want)
    _assert_flat_equal(rebuilt["port"]().find_unique_kmers(), want)


def test_multi_chromosome_variant_signatures():
    rng = np.random.default_rng(23)
    refs, records = {}, []
    for chrom in ("1", "2"):
        seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 400))
        refs[chrom] = seq
        for pos in (100, 250):
            ref_b = seq[pos - 1]
            records.append((chrom, pos, ref_b,
                            "ACGT"[("ACGT".index(ref_b) + 1) % 4]))
    built = _build_both(refs, records)
    make = _selectors(built, 15)
    want = make["jax"]().find_unique_kmers()
    finder = make["port"]()
    flat = finder.find_unique_kmers()
    _assert_flat_equal(flat, want)
    assert finder.n_failed_variants == 0
    got_nodes = set(np.asarray(flat._nodes).tolist())
    v2n = built["port"][1]
    for i in range(len(records)):
        assert int(v2n.ref_nodes[i]) in got_nodes
        assert int(v2n.var_nodes[i]) in got_nodes
    _assert_flat_equal(make["port"]().find_unique_kmers_batched(), want)


def test_batched_fallback_counter_and_warning_on_dense_bubbles():
    rng = np.random.default_rng(31)
    n_v = 120
    seq = list(rng.choice(list("ACGT"), size=40 + n_v * 6))
    records, pos = [], 20
    for _ in range(n_v):  # spacing 5-7 << k: nothing is isolated
        refb = seq[pos - 1]
        records.append(("1", pos, refb,
                        str(rng.choice([b for b in "ACGT" if b != refb]))))
        pos += int(rng.integers(5, 8))
    make = _selectors(_build_both({"1": "".join(seq)}, records), 15)
    want = make["jax"]().find_unique_kmers()
    finder = make["port"]()
    records_logged = []

    class Capture(logging.Handler):
        def emit(self, record):
            records_logged.append(record)

    handler = Capture()
    logging.getLogger().addHandler(handler)
    try:
        flat = finder.find_unique_kmers_batched()
    finally:
        logging.getLogger().removeHandler(handler)
    _assert_flat_equal(flat, want)
    routed = finder.n_batched_variants + finder.n_fallback_variants
    assert routed + finder.n_zero_node_variants == n_v
    assert finder.n_fallback_variants > routed // 2
    assert any(r.levelno == logging.WARNING and "degraded" in r.getMessage()
               for r in records_logged)


def test_scoring_route_of_the_selection_is_the_same_on_both_backends():
    """The batched selection scores through ``get_frequencies``; an index
    answering from its bucket ranges in torch (the route of an index on
    the card) selects the same signatures as one answering through the
    native library."""
    rng = np.random.default_rng(41)
    ref, records = _random_records(rng, n_bases=1500)
    built = _build_both({"1": ref}, records)
    graph, v2n, variants = built["port"]
    index = _index(tgki, tgki.SnpKmerFinder(graph, k=15).find_kmers())
    flats = []
    for backend in ("device", "native"):
        class Scoring:
            def get_frequencies(self, kmers, backend=backend):
                return index.get_frequencies(kmers, backend=backend)

        finder = tgki.UniqueVariantKmersFinder(
            graph, v2n, variants, k=15,
            kmer_index_with_frequencies=Scoring())
        flats.append(finder.find_unique_kmers_batched())
    _assert_flat_equal(flats[0], flats[1])
    assert len(flats[0]._hashes) >= len(records)


# -- structural variants ---------------------------------------------------------

class DummyGraph:
    def __init__(self, node_sequences):
        self.node_sequences = node_sequences

    def get_numeric_node_sequence(self, node):
        return letter_sequence_to_numeric(self.node_sequences[node])

    def get_node_size(self, node):
        return len(self.node_sequences[node])


class DummyKmerIndex:
    def get_frequencies(self, kmers):
        return np.ones(len(kmers), dtype=np.int64)


def test_sample_kmers_from_structural_variants():
    graph = DummyGraph({1: "AAAAAAAAAAA", 2: "ACTG",
                        3: "GGGGAAAACCCCAAAA", 4: "AGGGG"})
    flats = []
    for _, pkg in PACKAGES:
        v2n = pkg.VariantToNodes(np.array([1, 3]), np.array([2, 4]))
        flats.append(pkg.sample_kmers_from_structural_variants(
            graph, v2n, DummyKmerIndex(), k=5))
    for name in ("_hashes", "_nodes", "_ref_offsets"):
        a, b = getattr(flats[1], name), getattr(flats[0], name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    index = _index(tgki, flats[1])
    assert np.all(index.get_nodes(sequence_to_kmer_hash("AAAAA")) == [1])
    assert np.all(index.get_nodes(sequence_to_kmer_hash("GGGGA")) == [3])
    assert np.all(index.get_nodes(sequence_to_kmer_hash("AAACC")) == [3])


def test_structural_variants_scored_by_a_port_index():
    """Long allele nodes of a built graph, scored by a real index on each
    side (``get_frequencies`` of the port's KmerIndex)."""
    rng = np.random.default_rng(51)
    ref = "".join(rng.choice(list("ACGT"), size=600))
    ins = "".join(rng.choice(list("ACGT"), size=40))
    records = [("1", 100, ref[99], ref[99] + ins),
               ("1", 300, ref[299:340], ref[299]),
               ("1", 450, ref[449], "ACGT"[("ACGT".index(ref[449]) + 1) % 4])]
    built = _build_both({"1": ref}, records)
    flats = {}
    for name, pkg in PACKAGES:
        graph, v2n, _ = built[name]
        index = _index(pkg, pkg.SnpKmerFinder(graph, k=9).find_kmers())
        flats[name] = pkg.sample_kmers_from_structural_variants(
            graph, v2n, index, 9)
    assert len(flats["port"]._hashes) >= 4
    for name in ("_hashes", "_nodes", "_ref_offsets"):
        assert np.array_equal(getattr(flats["port"], name),
                              getattr(flats["jax"], name)), name


def test_bionumpy_hash_alias():
    seq = np.random.default_rng(61).integers(0, 4, 200)
    assert np.array_equal(tgki.bionumpy_hash(seq, 11),
                          jgki.bionumpy_hash(seq, 11))
