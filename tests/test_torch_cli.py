"""The port's command line against the JAX package's: the same subcommands
over the same input files, each output file compared array by array (npz)
or value by value (pickles, read by the package that wrote them). Mirrors
tests/test_cli.py on the port; every port command runs with ``--device
cpu`` where it takes a device."""
import pickle

import jax  # noqa: F401  (same process set-up as the other port tests)
import numpy as np
import pytest
import torch

import graph_kmer_index_tpu as jgki
import graph_kmer_index_tpu_torch as tgki
from graph_kmer_index_tpu import cli as jax_cli
from graph_kmer_index_tpu_torch import cli as torch_cli
from graph_kmer_index_tpu_torch.hashing import sequence_to_kmer_hash

torch.set_num_threads(2)

GRAPH = ({1: "AAAAAACTG", 2: "A", 3: "G", 4: "GC", 5: "T", 6: "C",
          7: "TGAGCCCCC", 8: "", 9: "TC", 10: "AAAAA"},
         {1: [2, 3], 2: [4], 3: [4], 4: [5, 6], 5: [7], 6: [7],
          7: [8, 9], 9: [10], 8: [10]},
         [1, 2, 4, 5, 7, 10])
CPU = ["--device", "cpu"]
# shard checkpoints that map_reads -T serves in the pipeline, and every
# checkpoint it writes
SERVED = ["shards_packed", "ooc_one", "ooc_packed"]
CHECKPOINTS = SERVED + ["shards_csr", "ooc_index"]


def _pipeline(pkg, cli, tmp, device):
    """Every subcommand over the ported modules, in an order in which each
    finds its inputs. Returns {output name: path}."""
    run = cli.run_argument_parser
    p = lambda name: str(tmp / name)  # noqa: E731
    pkg.Graph.from_dicts(*GRAPH).to_file(p("graph.npz"))
    pkg.VariantToNodes(np.array([2, 5, 8]),
                       np.array([3, 6, 9])).to_file(p("v2n.npz"))
    with open(p("variants.vcf"), "w") as f:
        f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\n"
                "1\t10\t.\tA\tG\n1\t13\t.\tT\tC\n1\t22\t.\tC\tCTC\n")
    with open(p("ref.fa"), "w") as f:
        f.write(">chr1\nACGTACGTACGTACGTACGTTTGACCA\n")
    with open(p("reads.fa"), "w") as f:
        f.write(">r1\nAAAACTGAGCTTGAGCC\n>r2\nGGGGGGGG\n>r3\nCCCCTCAAAAA\n")
    g, v2n, flat, kindex = (p("graph.npz"), p("v2n.npz"), p("flat.npz"),
                            p("kindex.npz"))
    run(["index", "-g", g, "-k", "5", "-o", flat])
    run(["make_from_flat", "-f", flat, "-o", kindex, "-m", "4099"] + device)
    run(["make_from_flat", "-f", flat, "-o", p("kindex_rc.npz"), "-m", "211",
         "-r", "true", "-k", "5", "-S", "true"] + device)
    run(["make_from_flat", "-f", flat, "-o", p("kindex_single.npz"), "-m",
         "211", "-s", "true"] + device)
    run(["make_from_flat", "-f", flat, "-o", p("minimal.npz"), "-m", "211",
         "-M", "true"] + device)
    run(["make_reverse", "-f", flat, "-o", p("rev.npz")])
    run(["find_critical_paths", "-g", g, "-k", "5", "-o", p("crit.pkl")])
    run(["index", "-g", g, "-k", "5", "-c", p("crit.pkl"), "-r", "true",
         "-o", p("flat_crit_rc.npz")] + device)
    run(["index", "-g", g, "-k", "5", "-w", kindex, "-o", p("flat_wl.npz")]
        + device)
    run(["make_unique_variant_kmers", "-g", g, "-V", v2n, "-k", "5", "-i",
         kindex, "-v", p("variants.vcf"), "-D", "true", "-o", p("sig.npz")]
        + device)
    run(["make_unique_variant_kmers", "-g", g, "-V", v2n, "-k", "5", "-i",
         kindex, "-v", p("variants.vcf"), "-c", "2", "-o",
         p("sig_snp.npz")] + device)
    run(["make_unique_variant_kmers_kivs", "-g", g, "-V", v2n, "-k", "5",
         "-i", kindex, "-v", p("variants.vcf"), "-O", "-o",
         p("sig_batched.npz")] + device)
    run(["count_kmers", "-f", flat, "-o", p("counter.pkl")])
    run(["make_unique_variant_kmers", "-g", g, "-V", v2n, "-k", "5", "-I",
         p("counter.pkl"), "-v", p("variants.vcf"), "-o",
         p("sig_counter.npz")] + device)
    run(["sample_kmers_from_structural_variants", "-g", g, "-V", v2n, "-k",
         "3", "-I", p("counter.pkl"), "-o", p("sv.npz")])
    run(["merge_flat_kmers", "-f", f"{flat},{p('sig.npz')}", "-o",
         p("merged.npz")])
    run(["add_reverse_complements", "-f", flat, "-k", "5", "-o",
         p("flatrc.npz")])
    run(["create_counter_index", "-i", kindex, "-o", p("cidx.pkl"), "-m",
         "4099"] + device)
    run(["prune_flat_kmers", "-f", flat, "-o", p("pruned.npz")])
    run(["make", "-g", g, "-k", "5", "-s", "1", "-o", p("make_flat.npz")]
        + device)
    run(["make", "-g", g, "-k", "5", "-s", "1", "-r", "true", "-w", flat,
         "-S", p("sig.npz"), "-o", p("make_flat_filtered.npz")] + device)
    run(["make", "-g", g, "-k", "5", "-s", "1", "-t", "2", "-G", "40", "-o",
         p("make_flat_threads.npz")] + device)
    run(["make", "-R", p("ref.fa"), "-n", "chr1", "-k", "5", "-s", "1", "-o",
         p("linear_flat.npz")] + device)
    run(["make_reference_kmer_index", "-f", flat, "-o", p("refidx.npz")])
    run(["make_reference_kmer_index", "-r", p("ref.fa"), "-n", "chr1", "-k",
         "5", "-o", p("refidx_fasta.npz")])
    run(["make_unique_index", "-f", flat, "-g", g, "-r", p("rev.npz"), "-o",
         p("uniq.pkl")])
    run(["make_from_flat", "-f", flat, "-o", p("kindex_freq.npz"), "-m",
         "4099"] + device)
    run(["set_frequencies_using_other_index", "-i", p("kindex_freq.npz"),
         "-f", kindex, "-m", "3"] + device)
    run(["make_kmer_frequency_index", "-r", p("refidx.npz"), "-o",
         p("freq.npz")])
    np.save(p("af.npy"), np.zeros(8, np.float32))
    run(["make_from_flat", "-f", flat, "-o", p("kindex_af.npz"), "-m",
         "4099"] + device)
    run(["set_allele_frequencies", "-i", p("kindex_af.npz"), "-f",
         p("af.npy")] + device)
    run(["make_graph", "-R", p("ref.fa"), "-v", p("variants.vcf"), "-o",
         p("made_graph.npz"), "-V", p("made_v2n.npz")])
    for backend in ("device", "native"):
        run(["map_reads", "-i", kindex, "-r", p("reads.fa"), "-k", "5", "-R",
             "true", "-b", backend, "-o", p(f"counts_{backend}.npy")]
            + device)
    # shard checkpoints, and the reads served from them (one rank here;
    # the JAX package's mesh has 8 CPU devices)
    run(["shard_index", "-i", kindex, "-n", "1", "-o", p("shards_packed")])
    run(["shard_index", "-i", kindex, "-n", "2", "-l", "csr", "-o",
         p("shards_csr")])
    run(["make_index_out_of_core", "-g", g, "-k", "5", "-d", p("ooc"), "-m",
         "4099", "-n", "4", "-t", "2", "-O", "true", "-o", p("ooc_index")])
    run(["reshard_checkpoint", "-i", p("ooc_index"), "-o", p("ooc_one"),
         "-n", "1"])
    run(["convert_shards_to_packed", "-i", p("ooc_index"), "-d", p("pk"),
         "-o", p("ooc_packed"), "-n", "1", "-t", "2"])
    for prefix in SERVED:
        run(["map_reads", "-T", p(prefix), "-r", p("reads.fa"), "-k", "5",
             "-R", "true", "-o", p(f"counts_{prefix}.npy")] + device)
    return tmp


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    jdir = _pipeline(jgki, jax_cli, tmp_path_factory.mktemp("jax"), [])
    tdir = _pipeline(tgki, torch_cli, tmp_path_factory.mktemp("port"), CPU)
    return jdir, tdir


NPZ_OUTPUTS = [
    "flat", "kindex", "kindex_rc", "kindex_single", "minimal", "rev",
    "flat_crit_rc", "flat_wl", "sig", "sig_snp", "sig_batched",
    "sig_counter", "sv", "merged", "flatrc", "pruned", "make_flat",
    "make_flat_filtered", "make_flat_threads", "linear_flat", "refidx",
    "refidx_fasta", "kindex_freq", "freq", "kindex_af", "made_graph",
    "made_v2n"]


@pytest.mark.parametrize("name", NPZ_OUTPUTS)
def test_npz_output_equals_jax(outputs, name):
    jdir, tdir = outputs
    with np.load(jdir / f"{name}.npz", allow_pickle=True) as want, \
            np.load(tdir / f"{name}.npz", allow_pickle=True) as got:
        assert sorted(got.files) == sorted(want.files)
        assert want.files
        for key in want.files:
            a, b = got[key], want[key]
            assert a.dtype == b.dtype, (key, a.dtype, b.dtype)
            assert np.array_equal(a, b), key


@pytest.mark.parametrize("backend", ["device", "native"])
def test_map_reads_counts_equal_jax(outputs, backend):
    jdir, tdir = outputs
    got = np.load(tdir / f"counts_{backend}.npy")
    assert got.sum() > 0
    assert np.array_equal(got, np.load(jdir / f"counts_{backend}.npy"))
    assert np.array_equal(got, np.load(tdir / "counts_device.npy"))


def test_pickled_outputs_hold_the_same_values(outputs):
    """Object pickles are read by the package that wrote them (a pickle
    names its class's module); their contents are equal."""
    jdir, tdir = outputs
    loaded = {}
    for name, directory in (("jax", jdir), ("port", tdir)):
        with open(directory / "counter.pkl", "rb") as f:
            counter = pickle.load(f)
        with open(directory / "cidx.pkl", "rb") as f:
            cidx = pickle.load(f)
        with open(directory / "crit.pkl", "rb") as f:
            crit = pickle.load(f)
        with open(directory / "uniq.pkl", "rb") as f:
            uniq = pickle.load(f)
        loaded[name] = (counter, cidx, crit, uniq)
    (jc, jci, jcrit, juniq), (tc, tci, tcrit, tuniq) = \
        loaded["jax"], loaded["port"]
    assert type(tc).__module__.startswith("graph_kmer_index_tpu_torch")
    q = np.load(tdir / "flat.npz")["hashes"]
    assert np.array_equal(tc.get_frequencies(q), jc.get_frequencies(q))
    assert np.array_equal(tci.kmers, jci.kmers)
    assert np.array_equal(tci.nodes, jci.nodes)
    assert list(tcrit) == list(jcrit)
    # a plain dict: an interchange format
    assert dict(tuniq) == dict(juniq)


def test_semantic_spot_checks(outputs):
    _, tdir = outputs
    sig = tgki.FlatKmers.from_file(str(tdir / "sig.npz"))
    assert sequence_to_kmer_hash("CTGAG") not in set(
        np.asarray(sig._hashes).tolist())
    idx = tgki.KmerIndex.from_file(str(tdir / "kindex.npz"), device="cpu")
    assert idx.get_frequency(sequence_to_kmer_hash("CTGAG"), k=5) == 2
    flat = tgki.FlatKmers.from_file(str(tdir / "flat.npz"))
    rc = tgki.FlatKmers.from_file(str(tdir / "flatrc.npz"))
    assert len(rc._hashes) == 2 * len(flat._hashes)
    linear = tgki.FlatKmers.from_file(str(tdir / "linear_flat.npz"))
    assert linear._hashes[0] == sequence_to_kmer_hash("ACGTA")
    wl = tgki.FlatKmers.from_file(str(tdir / "flat_wl.npz"))
    assert len(wl._hashes) > 0
    assert idx.has_kmers(np.asarray(wl._hashes, np.uint64),
                         backend="native").all()
    # set_allele_frequencies is the reference's no-op
    with np.load(tdir / "kindex.npz") as a, np.load(tdir / "kindex_af.npz") \
            as b:
        assert np.array_equal(a["allele_frequencies"],
                              b["allele_frequencies"])


def test_cli_no_args_exits():
    with pytest.raises(SystemExit):
        torch_cli.run_argument_parser([])
    with pytest.raises(SystemExit):
        torch_cli.run_argument_parser(["--help"])


def test_every_jax_subcommand_is_registered():
    def names(parser):
        actions = [a for a in parser._actions if hasattr(a, "choices")
                   and isinstance(a.choices, dict)]
        return set(actions[0].choices)

    assert names(torch_cli.build_argument_parser()) == \
        names(jax_cli.build_argument_parser())


@pytest.mark.parametrize("prefix", CHECKPOINTS)
def test_checkpoint_files_equal_jax(outputs, prefix):
    """Every file of a shard checkpoint (shards, manifest; the sidecar
    metadata of the out-of-core build) equals the JAX CLI's."""
    jdir, tdir = outputs
    names = sorted(f.name for f in tdir.iterdir()
                   if f.name.startswith(prefix + "."))
    assert names and names == sorted(
        f.name for f in jdir.iterdir() if f.name.startswith(prefix + "."))
    for name in names:
        if name.endswith(".json"):
            assert (tdir / name).read_text() == (jdir / name).read_text()
            continue
        with np.load(tdir / name) as got, np.load(jdir / name) as want:
            assert sorted(got.files) == sorted(want.files), name
            for key in want.files:
                assert got[key].dtype == want[key].dtype, (name, key)
                assert np.array_equal(got[key], want[key]), (name, key)


@pytest.mark.parametrize("prefix", SERVED)
def test_map_reads_sharded_counts_equal_jax(outputs, prefix):
    """``map_reads -T`` on a one-rank gloo group: the node counts of the
    JAX CLI on its 8-device mesh, and of the whole index."""
    jdir, tdir = outputs
    got = np.load(tdir / f"counts_{prefix}.npy")
    assert got.sum() > 0
    assert np.array_equal(got, np.load(jdir / f"counts_{prefix}.npy"))
    assert np.array_equal(got, np.load(tdir / "counts_device.npy"))


def test_map_reads_sharded_refuses_an_uneven_world(outputs):
    """Two table shards cannot be served by one rank: the JAX message."""
    _, tdir = outputs
    with pytest.raises(SystemExit, match="cannot host 2 table shards"):
        torch_cli.run_argument_parser(
            ["map_reads", "-T", str(tdir / "shards_csr"), "-r",
             str(tdir / "reads.fa"), "-k", "5", "-o",
             str(tdir / "never.npy")] + CPU)
    assert not (tdir / "never.npy").exists()


def test_process_group_arguments(monkeypatch):
    """--dist-* first, then a launcher's environment, then one rank."""
    parser = torch_cli.build_argument_parser()
    base = ["map_reads", "-T", "x", "-r", "y", "-o", "z"]
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                 "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert torch_cli._process_group_args(parser.parse_args(base)) == \
        {"device": "cuda"}
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert torch_cli._process_group_args(parser.parse_args(base)) == {
        "device": "cuda", "init_method": "tcp://localhost:29500",
        "world_size": 4, "rank": 3, "local_rank": 1}
    explicit = parser.parse_args(base + [
        "--dist-init-method", "tcp://127.0.0.1:1234", "--dist-world-size",
        "2", "--dist-rank", "1", "--device", "cpu"])
    assert torch_cli._process_group_args(explicit) == {
        "device": "cpu", "init_method": "tcp://127.0.0.1:1234",
        "world_size": 2, "rank": 1}


def test_out_of_core_flags_are_strict_booleans():
    """``--keep-spills False`` is False here (the JAX CLI's ``type=bool``
    reads it as True); any other word is refused."""
    parser = torch_cli.build_argument_parser()
    ooc = ["make_index_out_of_core", "-g", "x", "-d", "y"]
    parsed = parser.parse_args(ooc + ["--keep-spills", "False",
                                      "--skip-frequencies", "true", "-O",
                                      "0"])
    assert parsed.keep_spills is False and parsed.skip_frequencies is True
    assert parsed.only_save_one_node_per_kmer is False
    for argv in (ooc + ["--keep-spills", "no"],
                 ["convert_shards_to_packed", "-i", "x", "-d", "y",
                  "--keep-spills", "maybe"]):
        with pytest.raises(SystemExit):
            parser.parse_args(argv)


@pytest.mark.parametrize("argv", [
    ["make", "-o", "x", "-p", "maybe"],
    ["make_from_flat", "-o", "x", "-f", "y", "-S", "yes"],
    ["index", "-g", "x", "-o", "y", "-r", "2"]])
def test_flags_are_strict_booleans(argv):
    """``-p False`` is False here; any other word is refused."""
    with pytest.raises(SystemExit):
        torch_cli.build_argument_parser().parse_args(argv)
    parsed = torch_cli.build_argument_parser().parse_args(
        ["make", "-o", "x", "-p", "False", "-V", "TRUE"])
    assert parsed.pruning is False and parsed.only_add_variant_kmers is True


def test_device_defaults_to_cuda():
    parser = torch_cli.build_argument_parser()
    for argv in (["make", "-o", "x"], ["make_from_flat", "-o", "x", "-f",
                                       "y"],
                 ["map_reads", "-r", "x", "-o", "y"],
                 ["index", "-g", "x", "-o", "y"]):
        assert parser.parse_args(argv).device == "cuda"
