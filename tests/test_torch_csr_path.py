"""The CSR path as ``map_kmers`` takes it where the packed table exceeds
its budget: on a seeded dense genome of the benchmark's generator, built
through the port, the CSR scan's counts and membership equal the packed
path's and the plain reference's; its span and counters; and the bucket
layout and frequencies that ``from_rows`` and ``from_flat_kmers`` build,
held to the JAX package's on seeded rows with deep buckets. On the CPU;
every comparison is exact."""
import sys
from pathlib import Path

import jax  # noqa: F401  (same process set-up as the other port tests)
import numpy as np
import pytest
import torch

from graph_kmer_index_tpu.flat_kmers import FlatKmers as JaxFlatKmers
from graph_kmer_index_tpu.models.kmer_index import CollisionFreeKmerIndex
from graph_kmer_index_tpu_torch import FlatKmers, KmerIndex
from graph_kmer_index_tpu_torch.ops import lookup
from graph_kmer_index_tpu_torch.ops.lookup import DeviceKmerIndex
from graph_kmer_index_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.indexes import dense  # noqa: E402
from portbench.lib import dense_reference, harness, reference  # noqa: E402
from portbench.lib import genome as gen  # noqa: E402

torch.set_num_threads(2)

COLUMNS = ("kmers", "nodes", "ref_offsets", "allele_frequencies",
           "hashes_to_index", "n_kmers", "frequencies")


# -- the CSR path on a dense genome -------------------------------------------

class _Run:
    """What the index module reads of a run."""

    def __init__(self, n_bases: int, seed: int):
        self.config = dict(harness.load_json("configs", "chr1_dense"),
                           ref_bases=n_bases,
                           n_variants=int(n_bases * 88.3 / 3100),
                           modulo=100_003, find_workers=2)
        self.seed = seed
        self.trace = False
        self.device = torch.device("cpu")


def _traffic():
    return dict(harness.load_json("traffic", "map_csr"),
                reads_per_request=1500)


@pytest.fixture(scope="module")
def dense_genome():
    """(index built by the port, its CSR view, queries, reference rows,
    n_nodes) of a 200 kb genome with its poly-A run."""
    run = _Run(200_000, 2 ** 31 + 101)
    idx = dense.make(run)
    genome = idx.genome
    hap, poly_a = gen.sample_haplotype(genome, _traffic(), run.seed)
    reads = gen.sample_reads(hap, poly_a, _traffic(), 1500,
                             gen.generator(run.seed, "reads/0", "cpu"),
                             int(run.config["poly_a_length"]))
    queries = reference.batch_hashes(reads)
    rows = dense_reference.dense_rows(
        gen.make_genome(run.config, run.seed, "cpu"),
        int(run.config["max_variant_nodes"]), int(run.config["k"]))
    csr = DeviceKmerIndex(idx.index)
    csr.PACKED_BYTE_BUDGET = 0
    return idx.index, csr, queries, rows, idx.n_nodes


def test_the_dense_genome_has_a_deep_poly_a_bucket(dense_genome):
    index, csr, queries, _, _ = dense_genome
    assert csr.packed() is None
    assert index.device_index.packed() is not None
    # the poly-A run's windows share k-mer 0, in one bucket of hundreds
    assert int(index.n_kmers[0]) > 300
    assert int((queries == 0).sum()) > 1000


def test_csr_counts_equal_the_packed_path_and_the_reference(dense_genome):
    index, csr, queries, rows, n_nodes = dense_genome
    got = csr.map_kmers(queries, n_nodes)
    assert torch.equal(got, index.device_index.map_kmers(queries, n_nodes))
    assert torch.equal(got, reference.node_counts(rows[0], rows[1], queries,
                                                  n_nodes))
    assert int(got.sum()) > queries.shape[0] // 2


def test_csr_membership_equals_the_packed_path_and_the_reference(
        dense_genome):
    index, csr, queries, rows, _ = dense_genome
    got = csr.has_kmers(queries)
    assert torch.equal(got, index.device_index.has_kmers(queries))
    assert torch.equal(got, torch.isin(queries, rows[0]))


def test_map_kmers_takes_the_csr_path_under_a_budget_of_zero(
        dense_genome, monkeypatch):
    index, csr, queries, _, n_nodes = dense_genome
    monkeypatch.setattr(DeviceKmerIndex, "PACKED_BYTE_BUDGET", 0)
    fresh = KmerIndex(index.kmers, index.nodes, index.modulo,
                      ref_offsets=index.ref_offsets,
                      frequencies=index.frequencies,
                      allele_frequencies=index.allele_frequencies,
                      hashes_to_index=index.hashes_to_index,
                      n_kmers=index.n_kmers)
    host = queries.numpy().view(np.uint64)
    assert np.array_equal(fresh.map_kmers(host, n_nodes),
                          csr.map_kmers(queries, n_nodes).numpy())
    assert np.array_equal(fresh.has_kmers(host),
                          csr.has_kmers(queries).numpy())
    assert fresh.device_index.packed() is None


@pytest.mark.parametrize("depth", [0, 1, 3, 10_000])
def test_csr_scan_at_any_depth_of_passes(dense_genome, monkeypatch, depth):
    """The queries left past CSR_DEPTH_PASSES rows, compared once per
    distinct k-mer, give the counts and membership of a scan by depth
    alone (10,000: no query left; 0: every query compared that way)."""
    index, csr, queries, rows, n_nodes = dense_genome
    monkeypatch.setattr(lookup, "CSR_DEPTH_PASSES", depth)
    assert torch.equal(csr.map_kmers(queries, n_nodes),
                       reference.node_counts(rows[0], rows[1], queries,
                                             n_nodes))
    assert torch.equal(csr.has_kmers(queries), torch.isin(queries, rows[0]))


@pytest.mark.parametrize("chunk", [1, 7, 1 << 24])
def test_range_matches_in_chunks_are_one_expansion(monkeypatch, chunk):
    """Ranges expanded in chunks of any size (one range longer than a
    chunk included) give every matched (query, row) pair, in order."""
    table = torch.tensor([5, 5, 9, 5, 2, 9, 9, 9, 9, 5], dtype=torch.int64)
    q = torch.tensor([5, 9, 2, 5, 7], dtype=torch.int64)
    start = torch.tensor([0, 2, 4, 3, 0])
    size = torch.tensor([2, 7, 1, 0, 10])
    monkeypatch.setattr(lookup, "_ULTRA_ROWS_PER_CHUNK", chunk)
    owner, rows, compared = lookup._range_matches(table, q, start, size)
    assert owner.tolist() == [0, 0, 1, 1, 1, 1, 1, 2]
    assert rows.tolist() == [0, 1, 2, 5, 6, 7, 8, 4]
    assert compared == 20


# -- the span and the counters -------------------------------------------------

MODULO = 7
# buckets under 7: 0 holds k-mers 0, 7, 14; 1 holds 1, 8; 3 holds 3
TABLE = np.array([0, 7, 14, 1, 8, 3], dtype=np.uint64)
TABLE_NODES = np.array([1, 2, 3, 4, 5, 6], dtype=np.uint32)
# 0, 14, 21 scan bucket 0 (3 rows), 8 bucket 1 (2 rows), 3 bucket 3 (1
# row); 2 and 5 find their buckets empty
QUERIES = torch.tensor([0, 14, 8, 3, 2, 21, 5], dtype=torch.int64)
HAND = {"csr.queries": 5, "csr.passes": 3, "csr.scan_rows": 5 + 4 + 3,
        "csr.hits": 4}


def _csr_view():
    n = len(TABLE)
    index = KmerIndex.from_rows(TABLE, TABLE_NODES, np.arange(n),
                                np.ones(n, np.float32), MODULO, device="cpu")
    view = DeviceKmerIndex(index)
    view.PACKED_BYTE_BUDGET = 0
    return view


def _csr_counters():
    c = profiling.counters(torch.device("cpu"))
    return {name: c[name] for name in profiling.CSR_COUNTERS}


@pytest.mark.parametrize("call", ["map_kmers", "has_kmers"])
def test_csr_counters_equal_the_hand_count(call):
    from torch.profiler import ProfilerActivity, profile

    view = _csr_view()
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if call == "map_kmers":
            out = view.map_kmers(QUERIES, 7)
            assert out.tolist() == [0, 1, 0, 1, 0, 1, 1]
        else:
            out = view.has_kmers(QUERIES)
            assert out.tolist() == [True, True, True, True, False, False,
                                    False]
    assert _csr_counters() == HAND
    assert "lookup.csr" in {e.name for e in prof.events()}
    profiling.reset_counters()


# 14 three times and 0 twice: past one pass, 0, 14, 21 and 8 are left,
# and their rest is compared once per distinct k-mer (2 + 2 + 2 + 1 rows)
DUP_QUERIES = torch.tensor([0, 14, 14, 8, 3, 2, 21, 5, 14, 0],
                           dtype=torch.int64)
DUP_HAND = {"csr.queries": 8, "csr.passes": 2, "csr.scan_rows": 8 + 7,
            "csr.hits": 3 + 2}


@pytest.mark.parametrize("call", ["map_kmers", "has_kmers"])
def test_csr_counters_of_distinct_kmers_past_the_depth(call, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(lookup, "CSR_DEPTH_PASSES", 1)
    view = _csr_view()
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        if call == "map_kmers":
            out = view.map_kmers(DUP_QUERIES, 7)
            assert out.tolist() == [0, 2, 0, 3, 0, 1, 1]
        else:
            out = view.has_kmers(DUP_QUERIES)
            assert out.tolist() == [True, True, True, True, True, False,
                                    False, False, True, True]
    assert _csr_counters() == DUP_HAND
    profiling.reset_counters()


def test_csr_counters_untouched_with_no_session():
    view = _csr_view()
    profiling.reset_counters()
    view.map_kmers(QUERIES, 7)
    view.has_kmers(QUERIES)
    assert set(_csr_counters().values()) == {0}


def test_the_packed_paths_deep_scan_counts_no_csr_counter():
    """K2's plain twin scans deep buckets with the same scan by depth; it
    counts K2's counters, not the CSR path's."""
    from torch.profiler import ProfilerActivity, profile

    n = len(TABLE)
    index = KmerIndex.from_rows(np.concatenate([TABLE, TABLE * 0]),
                                np.concatenate([TABLE_NODES] * 2),
                                np.arange(2 * n), np.ones(2 * n, np.float32),
                                MODULO, device="cpu")
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        index.device_index.map_kmers(QUERIES, 7)
    c = profiling.counters(torch.device("cpu"))
    assert c["k2.scan_rows"] > 0
    assert set(_csr_counters().values()) == {0}
    profiling.reset_counters()


# -- the bucket layout --------------------------------------------------------------

def _rows(seed):
    """Random rows with a deep bucket (one k-mer 400 times, with
    repeating offsets), dup2 pairs and k-mers that share buckets."""
    rng = np.random.default_rng(seed)
    kmers = np.concatenate([
        rng.integers(1, 1 << 50, 3000).astype(np.uint64),
        np.repeat(rng.integers(1, 1 << 50, 20).astype(np.uint64), 2),
        np.zeros(400, np.uint64),
        rng.integers(1, 1 << 20, 500).astype(np.uint64) * np.uint64(1009)])
    rng.shuffle(kmers)
    n = len(kmers)
    nodes = rng.integers(0, 5000, n).astype(np.int32)
    offsets = rng.integers(0, 2000, n).astype(np.int64)
    afs = rng.random(n).astype(np.float32)
    return kmers, nodes, offsets, afs


def _want(rows, modulo):
    kmers, nodes, offsets, afs = rows
    return CollisionFreeKmerIndex.from_flat_kmers(
        JaxFlatKmers(kmers, nodes.astype(np.uint32),
                     offsets.astype(np.uint64), afs), modulo=modulo)


def _same_layout(port, want):
    assert np.array_equal(port.kmers.numpy().view(np.uint64), want._kmers)
    for name in COLUMNS[1:]:
        got = getattr(port, name).numpy()
        assert np.array_equal(got, np.asarray(getattr(want, "_" + name))), \
            name


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("modulo", [1009, 100_003])
def test_from_rows_layout_is_the_jax_packages(seed, modulo):
    rows = _rows(seed)
    port = KmerIndex.from_rows(*rows, modulo, device="cpu")
    assert int(port.n_kmers.max()) >= 400
    _same_layout(port, _want(rows, modulo))


@pytest.mark.parametrize("seed", [4, 5])
def test_from_flat_kmers_of_tensors_is_the_jax_packages_layout(seed):
    """A FlatKmers of tensors (a device finalize's) is built where it
    lies, into the JAX package's layout, and is left as it was."""
    rows = _rows(seed)
    kmers, nodes, offsets, afs = rows
    flat = FlatKmers(torch.from_numpy(kmers.view(np.int64).copy()),
                     torch.from_numpy(nodes.copy()),
                     torch.from_numpy(offsets.copy()),
                     torch.from_numpy(afs.copy()))
    port = KmerIndex.from_flat_kmers(flat, 1009, device="cpu")
    _same_layout(port, _want(rows, 1009))
    assert np.array_equal(flat._hashes.numpy().view(np.uint64), kmers)
    assert np.array_equal(flat._nodes.numpy(), nodes)
