"""The dense cell's plain reference (``portbench/lib/dense_reference.py``)
held to the port's build and to the JAX package's dense finder, on
seeded genomes of the benchmark's generator at the configuration's
density (one variant in 35 bases, one reference base at least between
two, 4.08% indels, the planted repeats), at CPU sizes; the graph that
``portbench/indexes/dense.py`` hands the port against the port's own
``build_graph_from_vcf``; and the build's spans and counters."""
import ast
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import jax  # noqa: F401  (same process set-up as the other port tests)
import numpy as np
import pytest
import torch

from graph_kmer_index_tpu import DenseKmerFinder as JaxFinder
from graph_kmer_index_tpu import Graph as JaxGraph

from graph_kmer_index_tpu_torch import (CriticalGraphPaths, Graph,
                                        KmerIndex, PositionId)
from graph_kmer_index_tpu_torch.graph_builder import build_graph_from_vcf
from graph_kmer_index_tpu_torch.parallel.host_pool import (
    find_kmers_parallel_device)
from graph_kmer_index_tpu_torch.utils import profiling
from graph_kmer_index_tpu_torch.variants import VcfVariant, VcfVariants

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.indexes import dense  # noqa: E402
from portbench.lib import checks, dense_reference, harness  # noqa: E402
from portbench.lib import genome as gen  # noqa: E402
from portbench.lib import reference  # noqa: E402

torch.set_num_threads(2)

MODULO = 1009
CELL = "map_hashes.chr13_dense"


def config(n_bases: int, **extra) -> dict:
    """The cell's configuration at ``n_bases``, its density kept, two
    find workers."""
    return dict(harness.load_json("configs", "chr13_dense"),
                ref_bases=n_bases, n_variants=int(n_bases * 88.3 / 3100),
                modulo=MODULO, find_workers=2, **extra)


def traffic() -> dict:
    return dict(harness.load_json("traffic", "map_hashes"),
                reads_per_request=300, pool_requests=2)


def first_segment_of_k(genome: gen.Genome) -> gen.Genome:
    """The genome with its first variant moved to base K: a first segment
    of exactly k bases, where the finder also starts a search at the
    graph's first node."""
    pos = genome.pos.clone()
    pos[0] = gen.K
    return replace(genome, pos=pos)


def port_rows(genome: gen.Genome, max_variant_nodes=5, **find):
    """The port's rows for the genome: the graph of the index module,
    critical paths, the pooled find with the device finalize on the CPU,
    and the index built from its rows."""
    graph = Graph(**dense.graph_arrays(genome))
    flat = find_kmers_parallel_device(
        graph, gen.K, 2, critical_paths=CriticalGraphPaths.from_graph(
            graph, gen.K), position_id=PositionId.from_graph(graph),
        device="cpu", require_native=True,
        max_variant_nodes=max_variant_nodes,
        only_save_one_node_per_kmer=True, **find)
    return flat, KmerIndex.from_flat_kmers(flat, MODULO, device="cpu")


def sorted_rows(kmers, nodes, offsets):
    cols = [np.asarray(c).astype(np.int64) for c in (kmers, nodes, offsets)]
    order = np.lexsort(cols[::-1])
    return [c[order] for c in cols]


@pytest.mark.parametrize("seed,n_bases,first_k", [
    (1, 300_000, False), (2, 120_000, False), (2 ** 31 + 5, 120_000, False),
    (3, 60_000, True)])
def test_reference_equals_the_ports_build(seed, n_bases, first_k):
    g = gen.make_genome(config(n_bases), seed, "cpu")
    if first_k:
        g = first_segment_of_k(g)
    flat, index = port_rows(g, stream_rows_target=50_000)
    rows = dense_reference.dense_rows(g)
    found = dict((name, v) for name, v, _ in
                 checks.index_checks(index, rows, MODULO, "cpu"))
    assert found == {"index_rows": 0, "index_frequencies": 0,
                     "index_layout": 0}
    assert len(flat) == rows[0].shape[0] > 2 * n_bases
    queries = torch.cat([rows[0][::3], rows[0][:500] ^ 1])
    want = reference.node_counts(rows[0], rows[1], queries, g.n_nodes)
    got = index.map_kmers(queries.numpy().view(np.uint64), g.n_nodes)
    assert np.array_equal(got, want.numpy())


@pytest.mark.parametrize("seed,first_k", [(4, False), (5, True)])
def test_reference_equals_the_jax_dense_finder(seed, first_k):
    g = gen.make_genome(config(40_000), seed, "cpu")
    if first_k:
        g = first_segment_of_k(g)
    finder = JaxFinder(JaxGraph(**dense.graph_arrays(g)), gen.K,
                       max_variant_nodes=5, only_save_one_node_per_kmer=True)
    finder.find()
    flat = finder.get_flat_kmers(v="1")
    got = sorted_rows(flat._hashes.view(np.int64), flat._nodes,
                      flat._ref_offsets.view(np.int64))
    want = sorted_rows(*(c.numpy() for c in dense_reference.dense_rows(g)))
    for a, b in zip(got, want, strict=True):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("max_variant_nodes", [1, 2])
def test_reference_follows_max_variant_nodes(max_variant_nodes):
    g = gen.make_genome(config(60_000), 6, "cpu")
    flat, _ = port_rows(g, max_variant_nodes)
    got = sorted_rows(flat._hashes, flat._nodes, flat._ref_offsets)
    want = sorted_rows(*(c.numpy() for c in dense_reference.dense_rows(
        g, max_variant_nodes)))
    fewer = dense_reference.dense_rows(g, max_variant_nodes - 1)[0]
    for a, b in zip(got, want, strict=True):
        assert np.array_equal(a, b)
    assert fewer.shape[0] < want[0].shape[0]


def test_graph_equals_build_graph_from_vcf():
    """The index module's graph, made in arrays, is the one the port
    builds from the genome's reference and its variants as a VCF holds
    them (indels anchored on the base before them)."""
    g = gen.make_genome(config(20_000), 7, "cpu")
    ref = g.ref.numpy()
    letters = "ACGT"
    sequence = "".join(letters[b] for b in ref)
    variants = []
    for i, (p, rl, al) in enumerate(zip(g.pos.tolist(), g.ref_len.tolist(),
                                        g.alt_len.tolist())):
        alt = "".join(letters[b] for b in g.alt_bases[i, :al].tolist())
        if rl == al == 1:
            variants.append(VcfVariant("1", p + 1, sequence[p], alt,
                                       vcf_line_number=i))
        else:
            anchor = sequence[p - 1]
            variants.append(VcfVariant("1", p, anchor + sequence[p:p + rl],
                                       anchor + alt, vcf_line_number=i))
    want, _ = build_graph_from_vcf({"1": sequence}, VcfVariants(variants))
    got = dense.graph_arrays(g)
    assert want.n_nodes() == g.n_nodes
    for name, value in got.items():
        expected = np.asarray(getattr(want, name))
        assert value.dtype == expected.dtype, name
        assert np.array_equal(value, expected), name


def test_reference_imports_torch_numpy_and_the_standard_library_only():
    imported = set()
    for name in ("dense_reference", "genome"):
        tree = ast.parse((ROOT / "portbench" / "lib" / f"{name}.py")
                         .read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                imported |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and not node.level:
                imported.add(node.module.split(".")[0])
            elif isinstance(node, ast.ImportFrom):
                assert node.module == "genome", node.module
    assert imported - set(sys.stdlib_module_names) <= {"torch", "numpy"}
    # loaded, beyond what torch and numpy load themselves: the
    # benchmark's own package alone
    probe = ("import sys\n"
             "for m in ('jax', 'graph_kmer_index_tpu', "
             "'graph_kmer_index_tpu_torch'):\n"
             "    sys.modules[m] = None\n"
             "import numpy, torch\n"
             "def top():\n"
             "    return {m.split('.')[0] for m, v in sys.modules.items()\n"
             "            if v}\n"
             "before = top()\n"
             "from portbench.lib import dense_reference\n"
             "print(sorted(top() - before - set(sys.stdlib_module_names)))\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["['portbench']"], out.stdout


class _Run:
    """What the index module reads of a run."""

    def __init__(self, trace: bool, seed: int = 8):
        self.config = config(60_000)
        self.seed = seed
        self.trace = trace
        self.device = torch.device("cpu")


def test_traced_build_has_its_spans_and_counters_and_the_same_rows():
    plain = dense.make(_Run(trace=False))
    traced_run = _Run(trace=True)
    traced = dense.make(traced_run)
    build = traced_run.dense_build
    for name in ("build.critical_paths", "build.find", "build.flush",
                 "kmer_index.build", "lookup.pack"):
        assert build["spans"].get(name, 0) > 0, (name, build["spans"])
    counts = build["counters"]
    assert counts["find.chunks"] >= 2
    assert 0 < counts["find.walk_us"]
    assert 0 < counts["find.first_result_us"] < build["spans"][
        "build.find"] * 1e6
    assert build["workers"] == 2
    for col in ("kmers", "nodes", "ref_offsets", "frequencies",
                "hashes_to_index", "n_kmers"):
        assert torch.equal(getattr(plain.index, col),
                           getattr(traced.index, col)), col
    # the window's counters start from nothing
    assert set(profiling.counters().values()) == {0}


def test_untraced_build_moves_no_counter():
    profiling.reset_counters()
    dense.make(_Run(trace=False))
    assert set(profiling.counters().values()) == {0}


@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_run_of_the_cell_is_correct(trace):
    man = harness.manifest()
    cell = harness.find_cell(man, CELL)
    res, found = harness.run_cell(
        cell, 2 ** 31 + 9, 0.3, trace, "cpu", 0.0, config=config(60_000),
        traffic=traffic(), per_layer=man["per_layer"],
        end_to_end=man["end_to_end"])
    assert res["correct"], found
    assert {name for name, _, _ in found} == {
        "index_rows", "index_frequencies", "index_layout", "node_counts"}
    metrics = set(res["metrics"])
    if trace:
        # the window's device metric needs a card; the build's are read
        assert metrics == {"dense.critical_paths_ms", "dense.find_ms",
                           "dense.index_build_ms", "dense.pack_ms",
                           "dense.find_walk_share"}
        assert 0 < res["metrics"]["dense.find_walk_share"]["value"] <= 100
    else:
        assert metrics == {"map_kmers_per_s", "setup_s"}
