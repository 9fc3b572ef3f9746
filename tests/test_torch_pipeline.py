"""The ported read-mapping slice as a whole: the JAX package builds an index
from a variant graph and saves it; reads are written as FASTA; the JAX
CLI's map_reads and the port's map_reads run on the same two files, and
their saved count arrays must be equal."""
import jax  # noqa: F401  (JAX on the CPU backend, set up by conftest)
import numpy as np
import pytest
import torch

from graph_kmer_index_tpu import CollisionFreeKmerIndex, DenseKmerFinder
from graph_kmer_index_tpu import cli as jax_cli
from graph_kmer_index_tpu.utils.synthetic import random_snp_graph
from graph_kmer_index_tpu_torch import cli as torch_cli

torch.set_num_threads(2)


def _fixture(tmp_path, k):
    graph, _ = random_snp_graph(3000, 40, seed=4)
    finder = DenseKmerFinder(graph, k=k)
    finder.find()
    index = CollisionFreeKmerIndex.from_flat_kmers(
        finder.get_flat_kmers(v="0"), modulo=2003)
    index_path = str(tmp_path / "index")
    index.to_file(index_path)

    rng = np.random.default_rng(1)
    ref = np.concatenate([graph.get_numeric_node_sequence(v)
                          for v in graph.linear_ref_nodes()]).astype(np.int64)
    starts = rng.integers(0, len(ref) - 100, 150)
    reads = np.stack([ref[s:s + 100] for s in starts])
    errors = rng.random(reads.shape) < 0.01
    reads[errors] = (reads[errors] + rng.integers(1, 4, errors.sum())) % 4
    reads_path = tmp_path / "reads.fa"
    with open(reads_path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">read{i}\n{''.join('ACGT'[b] for b in r)}\n")
    return index_path + ".npz", str(reads_path)


@pytest.mark.parametrize("rc", [False, True])
def test_map_reads_cli_matches_jax(tmp_path, rc):
    k = 15
    index_path, reads_path = _fixture(tmp_path, k)
    jax_out = str(tmp_path / "jax.npy")
    torch_out = str(tmp_path / "torch.npy")
    jax_cli.run_argument_parser(
        ["map_reads", "-i", index_path, "-r", reads_path, "-k", str(k),
         "-R", "True" if rc else "", "-o", jax_out])
    torch_cli.run_argument_parser(
        ["map_reads", "-i", index_path, "-r", reads_path, "-k", str(k),
         "-R", "true" if rc else "false", "-o", torch_out,
         "--device", "cpu"])
    expected, port = np.load(jax_out), np.load(torch_out)
    assert port.dtype == np.int64
    assert np.array_equal(port, expected.astype(np.int64))
    assert port.sum() > 0


def test_map_reads_cli_rejects_unported_options(tmp_path):
    index_path, reads_path = _fixture(tmp_path, 15)
    base = ["map_reads", "-r", reads_path, "-o", str(tmp_path / "o.npy"),
            "--device", "cpu"]
    # -T is ported: a prefix that is no shard checkpoint is refused before
    # a process group starts, and so is a call with neither -i nor -T
    with pytest.raises(FileNotFoundError, match="manifest"):
        torch_cli.run_argument_parser(base + ["-T", str(tmp_path / "no")])
    assert not torch.distributed.is_initialized()
    with pytest.raises(SystemExit, match="--kmer-index or --table-shards"):
        torch_cli.run_argument_parser(base)
    # the native backend is ported: it gives the device backend's counts
    mapped = base + ["-i", index_path, "-k", "15"]
    torch_cli.run_argument_parser(mapped + ["-b", "native"])
    native_counts = np.load(tmp_path / "o.npy")
    torch_cli.run_argument_parser(mapped + ["-b", "device"])
    assert native_counts.sum() > 0
    assert np.array_equal(native_counts, np.load(tmp_path / "o.npy"))


@pytest.mark.parametrize("text,value", [("true", True), ("False", False),
                                        ("1", True), ("0", False)])
def test_strict_bool(text, value):
    assert torch_cli.strict_bool(text) is value


def test_strict_bool_rejects_other_words():
    with pytest.raises(SystemExit):
        torch_cli.build_argument_parser().parse_args(
            ["map_reads", "-r", "x", "-o", "y", "-R", "yes"])
