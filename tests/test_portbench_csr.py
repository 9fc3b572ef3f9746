"""The CSR cell ``map_csr.chr1_dense`` at a test's size on the CPU: a run
with the CSR path forced (a packed budget of 0) is correct and its check
judges the index by blocks of buckets; each planted fault (a row, a
frequency, a bucket start, one count) comes out not correct; the blocked
check agrees with the whole one; the four ``csr.*`` readers and the
yardstick's ``csr_bytes`` against hand counts."""
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import graph_kmer_index_tpu_torch.models.kmer_index as kmer_index
import graph_kmer_index_tpu_torch.ops.lookup as lookup
from graph_kmer_index_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.lib import (bucket_checks, checks, csr_roofline,  # noqa: E402
                           dense_reference, harness)
from portbench.lib import genome as gen  # noqa: E402

torch.set_num_threads(2)

CELL = "map_csr.chr1_dense"
READERS = ("csr.lookup_ms", "csr.scan_rows_per_kquery",
           "csr.passes_per_request", "csr.lookup_roofline")


def config(n_bases: int = 60_000) -> dict:
    return dict(harness.load_json("configs", "chr1_dense"),
                ref_bases=n_bases, n_variants=int(n_bases * 88.3 / 3100),
                modulo=1009, find_workers=2)


def traffic() -> dict:
    return dict(harness.load_json("traffic", "map_csr"),
                reads_per_request=300, pool_requests=2)


@pytest.fixture
def csr(monkeypatch):
    """The CSR path forced (no packed table is ever built) and the check
    cut into blocks of a few thousand rows."""
    def no_pack(*args, **kwargs):
        raise AssertionError("the CSR cell built a packed table")

    monkeypatch.setattr(lookup.DeviceKmerIndex, "PACKED_BYTE_BUDGET", 0)
    monkeypatch.setattr(lookup, "build_packed", no_pack)
    monkeypatch.setattr(bucket_checks, "BLOCK_ROWS", 1 << 12)


def run(seed: int = 2 ** 31 + 19):
    man = harness.manifest()
    return harness.run_cell(harness.find_cell(man, CELL), seed, 0.2, False,
                            "cpu", 0.0, config=config(), traffic=traffic(),
                            per_layer=man["per_layer"],
                            end_to_end=man["end_to_end"])


def wrong(result, *names):
    res, found = result
    assert res["correct"] is False
    bad = {n for n, v, limit in found if v > limit}
    assert bad & set(names), found


def test_a_sound_run_is_correct(csr):
    res, found = run()
    assert res["correct"], found
    assert {name for name, _, _ in found} == {
        "index_rows", "index_frequencies", "index_layout", "node_counts"}
    assert set(res["metrics"]) == {"map_kmers_per_s", "setup_s"}
    assert res["attempted"] >= 1


def test_a_traced_run_is_correct_and_has_its_yardstick(csr, monkeypatch):
    yards = []
    close = harness.Run.close

    def keep(run):
        yards.append(dict(run.yard))
        close(run)

    monkeypatch.setattr(harness.Run, "close", keep)
    man = harness.manifest()
    res, found = harness.run_cell(
        harness.find_cell(man, CELL), 2 ** 31 + 23, 0.2, True, "cpu", 0.0,
        config=config(), traffic=traffic(), per_layer=man["per_layer"],
        end_to_end=man["end_to_end"])
    assert res["correct"], found
    (yard,) = yards
    assert yard["requests"] == res["attempted"] >= 1
    assert 0 < yard["csr_queries"] < yard["csr_bytes"]


def _start_moved(monkeypatch):
    real = kmer_index.build_modulo_layout

    def moved(hashes, modulo, row_arrays):
        starts, sizes, rows, sorting = real(hashes, modulo, row_arrays)
        # the first bucket's rows read one row on: still inside the rows
        b = int(torch.nonzero(sizes > 0).flatten()[0])
        starts[b] += 1
        return starts, sizes, rows, sorting

    monkeypatch.setattr(kmer_index, "build_modulo_layout", moved)


def _row_altered(monkeypatch):
    real = kmer_index.build_modulo_layout

    def altered(hashes, modulo, row_arrays):
        starts, sizes, rows, sorting = real(hashes, modulo, row_arrays)
        rows[1][len(rows[1]) // 3] += 3  # one row's node
        return starts, sizes, rows, sorting

    monkeypatch.setattr(kmer_index, "build_modulo_layout", altered)


def _frequency_altered(monkeypatch):
    real = kmer_index.frequencies_by_distinct_ref_offsets

    def altered(kmers, ref_offsets):
        out = real(kmers, ref_offsets)
        out[len(out) // 2] += 1
        return out

    monkeypatch.setattr(kmer_index, "frequencies_by_distinct_ref_offsets",
                        altered)


def _count_altered(monkeypatch):
    real = lookup._node_counts

    def altered(*args):
        out = real(*args)
        out[out.shape[0] // 2] += 1
        return out

    monkeypatch.setattr(lookup, "_node_counts", altered)


@pytest.mark.parametrize("plant,names", [
    (_row_altered, ("index_rows",)),
    (_frequency_altered, ("index_frequencies",)),
    (_start_moved, ("index_layout",)),
    (_count_altered, ("node_counts",)),
], ids=["a_row", "a_frequency", "a_bucket_start", "one_count"])
def test_a_planted_fault_is_not_correct(csr, monkeypatch, plant, names):
    plant(monkeypatch)
    wrong(run(), *names)


# -- the blocked check against the whole one ------------------------------------

@pytest.fixture(scope="module")
def built():
    """(the port's index, the reference's rows) of a 40 kb genome."""
    cfg = config(40_000)
    g = gen.make_genome(cfg, 2 ** 31 + 29, "cpu")
    rows = dense_reference.dense_rows(g, 5)
    index = kmer_index.KmerIndex.from_rows(
        rows[0], rows[1].to(torch.int32), rows[2],
        torch.ones(rows[0].shape[0], dtype=torch.float32), 1009,
        device="cpu")
    return index, rows


def _clone(index):
    return SimpleNamespace(**{name: getattr(index, name).clone() for name in (
        "kmers", "nodes", "ref_offsets", "frequencies", "hashes_to_index",
        "n_kmers")})


def _node(ix):
    ix.nodes[17] += 1


def _offset(ix):
    ix.ref_offsets[5] += 1


def _frequency(ix):
    ix.frequencies[-3] += 1


def _size(ix):
    ix.n_kmers[int(torch.nonzero(ix.n_kmers).flatten()[0])] += 1


def _order(ix):
    lo, hi = 0, int(ix.kmers.shape[0]) - 1
    for name in ("kmers", "nodes", "ref_offsets", "frequencies"):
        col = getattr(ix, name)
        col[lo], col[hi] = col[hi].clone(), col[lo].clone()


def _row_dropped(ix):
    for name in ("kmers", "nodes", "ref_offsets", "frequencies"):
        setattr(ix, name, getattr(ix, name)[1:])


@pytest.mark.parametrize("fault", [None, _node, _offset, _frequency, _size,
                                   _order, _row_dropped],
                         ids=["sound", "node", "offset", "frequency", "size",
                              "order", "row_dropped"])
@pytest.mark.parametrize("block_rows", [1 << 10, 1 << 26])
def test_the_blocked_check_flags_what_the_whole_one_flags(
        built, monkeypatch, fault, block_rows):
    index, rows = built
    ix = _clone(index)
    if fault is not None:
        fault(ix)
    monkeypatch.setattr(bucket_checks, "BLOCK_ROWS", block_rows)
    dev = torch.device("cpu")
    got = {n: v for n, v, _ in bucket_checks.index_checks(ix, rows, 1009,
                                                          dev)}
    want = {n: v for n, v, _ in checks.index_checks(ix, rows, 1009, dev)}
    assert set(got) == set(want)
    assert {n for n, v in got.items() if v} == {
        n for n, v in want.items() if v}, (got, want)
    assert (fault is None) == (set(got.values()) == {0})


# -- the yardstick and the readers ------------------------------------------------

def test_csr_bytes_equal_the_hand_count():
    # buckets under 7: 0 holds k-mers 0, 7, 14; 1 holds 1, 8; 3 holds 3
    kmers = torch.tensor([0, 7, 14, 1, 8, 3])
    nodes = torch.tensor([1, 2, 3, 4, 5, 6])
    table = csr_roofline.CsrTable(kmers, nodes, 7)
    assert table.sizes.tolist() == [3, 2, 0, 1, 0, 0, 0]
    q = torch.tensor([0, 0, 14, 8, 3, 2, 21, 5])
    # distinct k-mers 0, 2, 3, 5, 8, 14, 21 scan 3 + 0 + 1 + 0 + 2 + 3 + 3
    # rows; rows of k-mers 0, 14, 8, 3 match; of their nodes 1, 3, 5, 6
    # those below 6 are counted
    assert csr_roofline.csr_bytes(table, q, 6) == (
        8 * (8 + 8) + (12 + 4) * 8 + 3 * 8)
    assert csr_roofline.nonempty_queries(table, q) == 6
    assert csr_roofline.csr_bytes(table, q[:0], 6) == 0


def _fake(trace=True, requests=4, spans=None, yard=None):
    summary = None if spans is None else {"spans": spans, "device_s": {},
                                          "idle_s": {}, "busy_s": 1.0,
                                          "window_s": 2.0}
    return SimpleNamespace(trace=trace, device=torch.device("cpu"),
                           requests=requests, trace_summary=summary,
                           yard=yard or {})


COUNTS = {"csr.queries": 2000, "csr.passes": 40, "csr.scan_rows": 9000,
          "csr.hits": 1500}


@pytest.mark.parametrize("name", READERS)
def test_a_reader_reads_none_on_an_untraced_run(name, monkeypatch):
    monkeypatch.setattr(profiling, "counters", lambda dev=None: dict(COUNTS))
    read = harness.load_module("metrics", name).read
    assert read(_fake(trace=False)) is None


@pytest.mark.parametrize("name", READERS)
def test_a_reader_reads_none_without_the_ports_span_or_counters(
        name, monkeypatch):
    """A port without the CSR counters or the span ``lookup.csr`` (the
    parent of this cell, or a run that took the packed path)."""
    monkeypatch.setattr(profiling, "counters",
                        lambda dev=None: {"k2.queries": 5})
    read = harness.load_module("metrics", name).read
    assert read(_fake(spans={"lookup.k2": 1.0},
                      yard={"csr_bytes": 10 ** 9})) is None


def test_the_readers_on_a_fake_traced_run(monkeypatch):
    monkeypatch.setattr(profiling, "counters", lambda dev=None: dict(COUNTS))
    run = _fake(spans={"lookup.csr": 2.0}, yard={"csr_bytes": 3.35e9})

    def read(name):
        return harness.load_module("metrics", name).read(run)

    assert read("csr.lookup_ms") == pytest.approx(500.0)
    assert read("csr.scan_rows_per_kquery") == pytest.approx(4500.0)
    assert read("csr.passes_per_request") == pytest.approx(10.0)
    # 3.35 GB at 3.35 TB/s is 1 ms, against the span's 2 s
    assert read("csr.lookup_roofline") == pytest.approx(0.05)


def test_the_counter_readers_read_none_where_nothing_was_scanned(
        monkeypatch):
    monkeypatch.setattr(profiling, "counters",
                        lambda dev=None: dict.fromkeys(COUNTS, 0))
    for name in ("csr.scan_rows_per_kquery", "csr.passes_per_request"):
        assert harness.load_module("metrics", name).read(_fake(
            spans={})) is None


def test_the_counter_readers_on_the_ports_own_counters(monkeypatch):
    """The counters as the CSR scan adds them while a session records."""
    monkeypatch.setattr(profiling, "active", lambda: True)
    profiling.reset_counters()
    n = 6
    index = kmer_index.KmerIndex.from_rows(
        np.array([0, 7, 14, 1, 8, 3], np.uint64), np.arange(1, 7),
        np.arange(n), np.ones(n, np.float32), 7, device="cpu")
    view = lookup.DeviceKmerIndex(index)
    view.PACKED_BYTE_BUDGET = 0
    view.map_kmers(torch.tensor([0, 14, 8, 3, 2, 21, 5]), 7)
    run = _fake(requests=1, spans={})
    assert harness.load_module("metrics", "csr.scan_rows_per_kquery").read(
        run) == pytest.approx(1000.0 * 12 / 5)
    assert harness.load_module("metrics", "csr.passes_per_request").read(
        run) == 3
    profiling.reset_counters()
