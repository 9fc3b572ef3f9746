"""The variant-signature path as a whole, JAX package against the port, on
a graph of a few thousand bases and a few dozen variants:

    reference + variants -> build_graph_from_vcf -> scoring index (pooled
    find, index with frequencies) -> SnpKmerFinder sweep -> batched
    signature selection -> signature index -> reverse / reference /
    variant-nodes indexes -> IndexBundle on disk -> IndexBundle.from_file
    -> reads hashed -> node counts

Both ends are compared after every stage: equal FlatKmers, equal bundle
files, equal node counts (all integers: exact). The port runs on the CPU:
each kernel's plain twin, the span expansion and ``get_frequencies`` in
torch."""
import json

import jax  # noqa: F401  (same process set-up as the other port tests)
import numpy as np
import pytest
import torch

import graph_kmer_index_tpu as jgki
import graph_kmer_index_tpu_torch as tgki
from graph_kmer_index_tpu.parallel.host_pool import (
    find_kmers_parallel as jax_find)
from graph_kmer_index_tpu_torch.parallel.host_pool import (
    find_kmers_parallel_device)
from graph_kmer_index_tpu_torch.utils import synthetic

torch.set_num_threads(2)

K = 15
COLUMNS = ("_hashes", "_nodes", "_ref_offsets", "_allele_frequencies")


def _case(seed, n_bases=4000, n_variants=40):
    """A reference and spaced-out SNPs and insertions, with a few variants
    crowded together so that the selection's fallback runs too."""
    rng = np.random.default_rng(seed)
    ref = "".join(rng.choice(list("ACGT"), size=n_bases))
    positions = np.sort(rng.choice(np.arange(60, n_bases - 60, 7),
                                   n_variants, replace=False))
    records = []
    for pos in positions.tolist():
        refb = ref[pos - 1]
        if rng.random() < 0.8:
            records.append(("1", pos, refb, str(rng.choice(
                [b for b in "ACGT" if b != refb]))))
        else:
            records.append(("1", pos, refb, refb + "".join(rng.choice(
                list("ACGT"), size=int(rng.integers(1, 4))))))
    reads = []
    for start in rng.integers(0, n_bases - 100, 60).tolist():
        read = list(ref[start:start + 100])
        for i in np.nonzero(rng.random(100) < 0.01)[0]:
            read[i] = "ACGT"[("ACGT".index(read[i]) + 1) % 4]
        reads.append("".join(read))
    return ref, records, reads


def _flat_numpy(flat):
    out = []
    for name in COLUMNS:
        col = getattr(flat, name)
        if isinstance(col, torch.Tensor):
            col = col.numpy()
        out.append(np.asarray(col))
    return out


def _assert_flat_equal(got, want, what):
    for name, a, b in zip(COLUMNS, _flat_numpy(got), _flat_numpy(want)):
        if a.dtype != b.dtype:  # a device finalize's int64 / int32 columns
            assert a.dtype.itemsize == b.dtype.itemsize, (what, name)
            a = a.view(b.dtype)
        assert np.array_equal(a, b), (what, name)


def _jax_path(ref, records, reads_path, tmp_path):
    variants = jgki.VcfVariants([jgki.VcfVariant(*r, vcf_line_number=i)
                                 for i, r in enumerate(records)])
    graph, v2n = jgki.build_graph_from_vcf({"1": ref}, variants)
    dense = jax_find(graph, K, 1,
                     critical_paths=jgki.CriticalGraphPaths.from_graph(
                         graph, K))
    scoring = jgki.KmerIndex.from_flat_kmers(dense, modulo=100_003)
    swept = jgki.SnpKmerFinder(graph, k=K, spacing=K).find_kmers()
    selector = jgki.UniqueVariantKmersFinder(
        graph, v2n, variants, k=K, kmer_index_with_frequencies=scoring)
    signatures = selector.find_unique_kmers_batched()
    index = jgki.KmerIndex.from_flat_kmers(signatures, modulo=10_007)
    bundle = jgki.IndexBundle({
        "KmerIndex": index, "VariantToNodes": v2n,
        "ReverseKmerIndex": jgki.ReverseKmerIndex.from_flat_kmers(signatures),
        "ReferenceKmerIndex": jgki.ReferenceKmerIndex.from_flat_kmers(swept),
        "VariantNodesIndex": jgki.VariantNodesIndex.from_graph(graph)})
    path = bundle.to_file(str(tmp_path / "jax_bundle"))
    served = jgki.IndexBundle.from_file(path)["KmerIndex"]
    kmers = jgki.ReadKmers.hash_fasta_file(
        reads_path, K, include_reverse_complements=True)
    counts = served.map_kmers(kmers, graph.n_nodes())
    return dict(graph=graph, dense=dense, swept=swept, selector=selector,
                signatures=signatures, path=path, kmers=kmers,
                counts=np.asarray(counts))


def _port_path(ref, records, reads_path, tmp_path):
    variants = tgki.VcfVariants([tgki.VcfVariant(*r, vcf_line_number=i)
                                 for i, r in enumerate(records)])
    graph, v2n = tgki.build_graph_from_vcf({"1": ref}, variants)
    dense = find_kmers_parallel_device(
        graph, K, n_workers=1,
        critical_paths=tgki.CriticalGraphPaths.from_graph(graph, K),
        device="cpu", stream_rows_target=20_000)
    scoring = tgki.KmerIndex.from_flat_kmers(dense, modulo=100_003,
                                             device="cpu")
    swept = tgki.SnpKmerFinder(graph, k=K, spacing=K, use_device=True,
                               device="cpu").find_kmers()

    class OnDevice:
        """The scoring route of an index on the card: the bucket ranges in
        torch."""
        def get_frequencies(self, kmers):
            return scoring.get_frequencies(kmers, backend="device")

    selector = tgki.UniqueVariantKmersFinder(
        graph, v2n, variants, k=K, kmer_index_with_frequencies=OnDevice())
    signatures = selector.find_unique_kmers_batched()
    index = tgki.KmerIndex.from_flat_kmers(signatures, modulo=10_007,
                                           device="cpu")
    bundle = tgki.IndexBundle({
        "KmerIndex": index, "VariantToNodes": v2n,
        "ReverseKmerIndex": tgki.ReverseKmerIndex.from_flat_kmers(signatures),
        "ReferenceKmerIndex": tgki.ReferenceKmerIndex.from_flat_kmers(swept),
        "VariantNodesIndex": tgki.VariantNodesIndex.from_graph(graph)})
    path = bundle.to_file(str(tmp_path / "port_bundle"))
    served = tgki.IndexBundle.from_file(path, device="cpu")["KmerIndex"]
    kmers = tgki.hash_fasta_file(reads_path, K, device="cpu",
                                 include_reverse_complements=True)
    counts = served.map_kmers(kmers, graph.n_nodes())
    return dict(graph=graph, dense=dense, swept=swept, selector=selector,
                signatures=signatures, path=path, kmers=kmers.to_numpy(),
                counts=counts, scoring=scoring, v2n=v2n, variants=variants)


def _raw(path):
    with np.load(path) as data:
        arrays = {key: data[key] for key in data.files
                  if key != "__manifest__"}
        manifest = json.loads(bytes(data["__manifest__"]).decode())
    return arrays, manifest


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_signature_pipeline_matches_jax(tmp_path, seed):
    ref, records, reads = _case(seed)
    reads_path = str(tmp_path / "reads.fa")
    with open(reads_path, "w") as f:
        for i, read in enumerate(reads):
            f.write(f">read{i}\n{read}\n")
    jax_out = _jax_path(ref, records, reads_path, tmp_path)
    port = _port_path(ref, records, reads_path, tmp_path)

    for name in ("sequence", "node_sizes", "edge_targets", "edge_index",
                 "linear_ref_mask", "node_to_ref_offset"):
        assert np.array_equal(getattr(port["graph"], name),
                              getattr(jax_out["graph"], name)), name
    _assert_flat_equal(port["dense"], jax_out["dense"], "scoring rows")
    _assert_flat_equal(port["swept"], jax_out["swept"], "sweep")
    _assert_flat_equal(port["signatures"], jax_out["signatures"],
                       "signatures")
    for counter in ("n_batched_variants", "n_fallback_variants",
                    "n_zero_node_variants", "n_failed_variants"):
        assert getattr(port["selector"], counter) == \
            getattr(jax_out["selector"], counter), counter
    assert port["selector"].n_batched_variants > 10
    assert port["selector"].n_fallback_variants > 0

    (jarrays, jmanifest), (tarrays, tmanifest) = \
        _raw(jax_out["path"]), _raw(port["path"])
    assert tmanifest == jmanifest and sorted(tarrays) == sorted(jarrays)
    assert len(tarrays) >= 17
    for key, want in jarrays.items():
        got = tarrays[key]
        assert got.dtype == want.dtype and np.array_equal(got, want), key

    assert np.array_equal(port["kmers"], jax_out["kmers"])
    assert port["counts"].shape == jax_out["counts"].shape
    assert np.array_equal(port["counts"], jax_out["counts"])
    assert port["counts"].sum() > 0
    # and the port reading the JAX package's bundle serves the same counts
    served = tgki.IndexBundle.from_file(jax_out["path"],
                                        device="cpu")["KmerIndex"]
    assert np.array_equal(
        served.map_kmers(port["kmers"], port["graph"].n_nodes()),
        port["counts"])


def test_batched_equals_per_variant_search_on_the_pipelines_graph(tmp_path):
    ref, records, _ = _case(3)
    reads_path = str(tmp_path / "reads.fa")
    with open(reads_path, "w") as f:
        f.write(">r\n" + ref[:120] + "\n")
    port = _port_path(ref, records, reads_path, tmp_path)
    exact = tgki.UniqueVariantKmersFinder(
        port["graph"], port["v2n"], port["variants"], k=K,
        kmer_index_with_frequencies=port["scoring"]).find_unique_kmers()
    _assert_flat_equal(port["signatures"], exact, "per-variant search")


def test_reference_and_variants_rebuild_the_synthetic_graph():
    """The smoke's set-up: a random_snp_graph written out as a reference
    and VCF records gives the same graph again through
    build_graph_from_vcf, node for node, and the records are 1-based SNPs and anchored insertions."""
    graph, v2n = synthetic.random_snp_graph(6000, 40, seed=5,
                                            indel_fraction=0.3)
    reference, variants = synthetic.reference_and_variants(graph, v2n)
    assert len(reference) == graph.linear_ref_length()
    assert len(variants) == len(v2n)
    types = {v.type for v in variants}
    assert types == {"SNP", "INSERTION"}
    for v in variants:
        assert reference[v.position - 1] == v.ref_sequence
    rebuilt, rebuilt_v2n = tgki.build_graph_from_vcf({"1": reference},
                                                     variants)
    for name in ("sequence", "node_sizes", "seq_start", "edge_targets",
                 "edge_index", "linear_ref_mask", "node_to_ref_offset",
                 "allele_frequencies"):
        assert np.array_equal(getattr(rebuilt, name), getattr(graph, name)), \
            name
    assert np.array_equal(rebuilt_v2n.ref_nodes, v2n.ref_nodes)
    assert np.array_equal(rebuilt_v2n.var_nodes, v2n.var_nodes)
