"""The port's spans and counters (graph_kmer_index_tpu_torch/utils/
profiling.py): off, a span is one flag read; under a profiler session the
read-mapping path's spans nest as the module lists them; K2's plain twin
counts the four K2 counters as the kernel does, against counts made here
from the rows' bucket sizes and by hand.

The tests marked ``card`` hold the kernel's counters against the twin's
and time K2 with and without them; they skip without a CUDA card. This
file imports no JAX, so they run on the card alone:
``python -m pytest --noconftest -p no:cacheprovider -s -m card
tests/test_torch_tracing.py``."""
import json
import sys
import time

import numpy as np
import pytest
import torch

from graph_kmer_index_tpu_torch.models.kmer_index import KmerIndex
from graph_kmer_index_tpu_torch.ops import lookup
from graph_kmer_index_tpu_torch.ops.packed_layout import (SCAN_CAP,
                                                         internal_modulo)
from graph_kmer_index_tpu_torch.parallel import sharded
from graph_kmer_index_tpu_torch.read_kmers import hash_fasta_file
from graph_kmer_index_tpu_torch.utils import profiling

MAP_SPANS = ("kmer_index.map_kmers", "kmer_index.upload",
             "kmer_index.counts_to_host")
FASTA_STAGES = ("read_kmers.read", "read_kmers.parse", "read_kmers.upload",
                "read_kmers.hash")


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: K2 runs only on the card")
    return torch.device("cuda:0")


def _random_index(n_rows=6000, seed=3, device="cpu"):
    """(KmerIndex, uint64 queries, n_nodes): distinct random k-mers, some
    copied to a second node, and queries half from the rows, half not."""
    rng = np.random.default_rng(seed)
    kmers = rng.choice(1 << 40, n_rows, replace=False).astype(np.uint64)
    kmers[-200:] = kmers[:200]
    nodes = rng.integers(0, 900, n_rows)
    queries = np.concatenate([rng.choice(kmers, 3000),
                              rng.integers(0, 1 << 40, 3000,
                                           dtype=np.uint64)])
    index = KmerIndex.from_rows(kmers, nodes, np.zeros(n_rows, np.uint64),
                                np.ones(n_rows, np.float32), 1009,
                                device=device)
    return index, queries, 900


def _fasta(path, n_reads=300, length=90, seed=4):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for r in range(n_reads):
            f.write(f">r{r}\n{''.join(rng.choice(list('ACGT'), length))}\n")
    return str(path)


def _spans(path):
    """(start, end, name) of the trace's host ranges."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
             e["name"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _inside(spans, inner, outer):
    """Every range named ``inner`` lies in one named ``outer``."""
    outers = [(s, e) for s, e, n in spans if n == outer]
    inners = [(s, e) for s, e, n in spans if n == inner]
    return inners and all(any(s0 <= s and e <= e0 for s0, e0 in outers)
                          for s, e in inners)


def _boom(*args, **kwargs):
    raise AssertionError("called while no profiler records")


# -- off ----------------------------------------------------------------------

def test_span_off_is_one_flag_read(monkeypatch):
    """Off, a span calls nothing but the flag's read and a shared no-op
    context: no record_function, no clock, no synchronise, no object
    made."""
    assert not profiling.active()
    assert profiling.span("a") is profiling.span("b")
    calls = []

    def watch(frame, event, arg):
        if event == "call":
            calls.append(frame.f_code.co_qualname)
        elif event == "c_call":
            calls.append(getattr(arg, "__qualname__", repr(arg)))

    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", _boom)
        m.setattr(time, "perf_counter", _boom)
        m.setattr(torch.cuda, "synchronize", _boom)
        sys.setprofile(watch)
        try:
            with profiling.span("kmer_index.upload"):
                pass
        finally:
            sys.setprofile(None)
    assert calls == ["span", "active", "nullcontext.__enter__",
                     "nullcontext.__exit__", "setprofile"]


def test_read_mapping_off_calls_no_record_function(monkeypatch, tmp_path):
    """map_kmers and hash_fasta_file with no profiler: no range opened,
    the counters as they were."""
    index, queries, n_nodes = _random_index()
    before = profiling.counters()
    monkeypatch.setattr(torch.profiler, "record_function", _boom)
    counts = index.map_kmers(queries, n_nodes)
    kmers = hash_fasta_file(_fasta(tmp_path / "r.fa"), 31, device="cpu",
                            include_reverse_complements=True)
    assert counts.sum() > 0 and len(kmers) > 0
    assert profiling.counters() == before


# -- on -----------------------------------------------------------------------

def test_map_kmers_spans_nest_and_counters_kept(tmp_path):
    """Under device_trace: the lookup's spans inside map_kmers' own, and
    the twin's counters kept in the Trace; the counts as untraced."""
    index, queries, n_nodes = _random_index()
    want = index.map_kmers(queries, n_nodes)
    with profiling.device_trace(str(tmp_path)) as trace:
        got = index.map_kmers(queries, n_nodes)
    assert np.array_equal(got, want)
    spans = _spans(trace.path)
    assert {n for *_, n in spans} >= set(MAP_SPANS)
    for inner in MAP_SPANS[1:]:
        assert _inside(spans, inner, "kmer_index.map_kmers"), inner
    assert trace.counters["k2.queries"] == len(queries)
    assert 0 < trace.counters["k2.pending"] < len(queries)


def test_native_backend_has_the_outer_span(tmp_path):
    index, queries, n_nodes = _random_index()
    with profiling.device_trace(str(tmp_path)) as trace:
        index.map_kmers(queries, n_nodes, backend="native")
    assert "kmer_index.map_kmers" in {n for *_, n in _spans(trace.path)}


@pytest.mark.parametrize("stage_seconds", [None, {}])
def test_hash_fasta_file_spans_nest(tmp_path, stage_seconds):
    """The four stages inside the call's span, with or without the
    synchronised stage timers, and the same k-mers."""
    path = _fasta(tmp_path / "r.fa")
    want = hash_fasta_file(path, 31, device="cpu", block_bytes=4096,
                           include_reverse_complements=True).to_numpy()
    with profiling.device_trace(str(tmp_path / "t")) as trace:
        got = hash_fasta_file(path, 31, device="cpu", block_bytes=4096,
                              include_reverse_complements=True,
                              stage_seconds=stage_seconds).to_numpy()
    assert np.array_equal(got, want)
    spans = _spans(trace.path)
    for stage in FASTA_STAGES:
        assert _inside(spans, stage, "read_kmers.hash_fasta_file"), stage
    assert sum(n == "read_kmers.parse" for *_, n in spans) > 1
    if stage_seconds is not None:
        assert set(stage_seconds) == {"read", "parse", "upload", "hash"}


def test_device_trace_resets_the_counters(tmp_path):
    index, queries, n_nodes = _random_index()
    for _ in range(2):
        with profiling.device_trace(str(tmp_path)) as trace:
            index.map_kmers(queries, n_nodes)
        assert trace.counters["k2.queries"] == len(queries)
    profiling.reset_counters()
    assert set(profiling.counters().values()) == {0}


# -- the twin's counters ------------------------------------------------------

def _twin_stats(tables, q, n_valid, n_nodes=None, bucket_base=0,
                m2_local=None):
    stats = torch.zeros((profiling.COUNTER_STRIPES,
                         len(profiling.K2_COUNTERS)), dtype=torch.int64)
    out = lookup.packed_lookup_plain(tables, q, n_valid, n_nodes,
                                     bucket_base, m2_local, stats=stats)
    return out, dict(zip(profiling.K2_COUNTERS, stats.sum(0).tolist()))


@pytest.mark.parametrize("counts_mode", [True, False])
def test_twin_queries_and_pending_from_bucket_sizes(counts_mode):
    """Distinct k-mers (no dup2 bucket): a valid query is pending in
    counts mode where its bucket holds more than 2 rows, in membership
    mode where it also is not the bucket's first row's k-mer (a deep
    record keeps only that one in its lanes)."""
    rng = np.random.default_rng(11)
    n = 5000
    kmers = rng.choice(1 << 40, n, replace=False).astype(np.int64)
    m2 = internal_modulo(n)
    tables = lookup.build_packed(torch.from_numpy(kmers),
                                 torch.arange(n), m2)
    q = np.concatenate([rng.choice(kmers, 4000),
                        rng.integers(0, 1 << 40, 4000)])
    n_valid = len(q) - 37
    bucket = kmers % m2
    sizes = np.bincount(bucket, minlength=m2)
    order = np.argsort(bucket, kind="stable")
    bs = bucket[order]
    head = np.r_[True, bs[1:] != bs[:-1]]
    first = np.full(m2, -1, np.int64)
    first[bs[head]] = kmers[order][head]
    qb = q % m2
    valid = np.arange(len(q)) < n_valid
    pending = valid & (sizes[qb] > 2)
    if not counts_mode:
        pending &= q != first[qb]
    out, got = _twin_stats(tables, torch.from_numpy(q), n_valid,
                           n if counts_mode else None)
    assert got["k2.queries"] == n_valid
    assert got["k2.pending"] == int(pending.sum()) > 0
    assert torch.equal(out, lookup.packed_lookup_plain(
        tables, torch.from_numpy(q), n_valid, n if counts_mode else None))


def _scan_table():
    """A table of 1,341 rows: filler in buckets of at most 2 rows; a
    poly-A bucket of 300 rows of k-mer 0 then one row of ``v`` (an ultra
    bucket, deeper than SCAN_CAP); a deep bucket of 40 k-mers ``deep[t]``;
    and a dup2 bucket, k-mer ``dup`` twice."""
    n = 1000 + 301 + 40 + 2
    m2 = internal_modulo(n)
    v = 7 * m2
    deep = [5 + m2 * t for t in range(1, 41)]
    dup = 9 + m2
    rng = np.random.default_rng(2)
    filler = rng.choice(1 << 40, 3000, replace=False)
    filler = filler[~np.isin(filler % m2, (0, 5, 9))][:1000]
    kmers = np.concatenate([np.zeros(300, np.int64), [v], deep, [dup, dup],
                            filler]).astype(np.int64)
    assert len(kmers) == n and 301 > SCAN_CAP
    sizes = np.bincount(kmers % m2, minlength=m2)
    shallow = filler[sizes[filler % m2] <= 2]
    tables = lookup.build_packed(torch.from_numpy(kmers), torch.arange(n),
                                 m2)
    return tables, m2, v, deep, dup, shallow, n


def test_twin_scan_rows_and_matches_by_hand():
    """Two tiles of 256 queries. Tile 0: poly-A x 100, deep[34], dup;
    tile 1: poly-A x 10, dup, deep[34], deep[2], an absent k-mer of the
    deep bucket, v; filler in shallow buckets elsewhere, 2 of padding."""
    tables, m2, v, deep, dup, shallow, n = _scan_table()
    q = np.resize(shallow, 512).astype(np.int64)
    q[0:100] = 0
    q[100], q[101] = deep[34], dup
    q[256:266] = 0
    q[266:271] = [dup, deep[34], deep[2], 5 + 100 * m2, v]
    q = torch.from_numpy(q)
    counts, got = _twin_stats(tables, q, 510, n)
    # counts mode: every k-mer of a bucket deeper than 2, and dup (a
    # matched dup2 bucket), goes to the scan; a tile scans a k-mer's
    # whole bucket once
    assert got == {"k2.queries": 510, "k2.pending": 102 + 15,
                   # tile 0: poly-A 301, deep 40, dup 2
                   "k2.scan_rows": 343 + 301 + 2 + 3 * 40 + 301,
                   "k2.scan_matches": 303 + 300 + 2 + 1 + 1 + 0 + 1}
    assert int(counts.sum()) == 110 * 300 + 2 * 2 + 3 + 1 + 510 - 117
    # membership mode: the poly-A k-mer is the record's own (no scan),
    # dup's bucket holds 2 rows; a scan stops after the 32-row pass of
    # its first match: deep[34] is row 34 (2 passes, all 40 rows),
    # deep[2] row 2 (one pass, 32 rows), v row 300 (all 301)
    hit, got = _twin_stats(tables, q, 510)
    assert got == {"k2.queries": 510, "k2.pending": 1 + 4,
                   "k2.scan_rows": 40 + 40 + 32 + 40 + 301,
                   "k2.scan_matches": 1 + 1 + 1 + 0 + 1}
    assert int(hit.sum()) == 510 - 1


def test_twin_counters_of_the_shards_sum_to_the_whole():
    """Each valid query belongs to one table shard, and a tile's distinct
    pending k-mers split among the shards by bucket: the four counters
    over the shards sum to the whole table's."""
    index, queries, n_nodes = _random_index(seed=8)
    q = torch.from_numpy(queries.view(np.int64))
    whole = index.device_index.packed()
    for n_nodes_ in (n_nodes, None):
        _, want = _twin_stats(whole, q, len(q) - 5, n_nodes_)
        shards = sharded.PackedTableShards.from_index(index, 4)
        total = dict.fromkeys(profiling.K2_COUNTERS, 0)
        for t in range(4):
            tables = sharded.shard_tables(
                shards, t, shards.records, shards.row_kmers,
                shards.row_nodes, torch.device("cpu"))
            _, got = _twin_stats(tables, q, len(q) - 5, n_nodes_,
                                 t * shards.m2_local, shards.m2_local)
            total = {k: total[k] + got[k] for k in total}
        assert total == want


# -- the card -----------------------------------------------------------------

def _card_index(n_rows, seed, poly_a):
    """Rows like the benchmark's: uniform k-mers (1.4% of uniform queries
    land in buckets of more than 2 rows), 2% of them copied to a second
    node (dup2 buckets), a poly-A bucket of ``poly_a`` rows; as a
    KmerIndex on the host and its row count's half as n_nodes."""
    g = torch.Generator().manual_seed(seed)
    kmers = torch.randint(1, 1 << 62, (n_rows,), generator=g)
    n_dup = n_rows // 50
    kmers[-n_dup:] = kmers[:n_dup]
    kmers[-n_dup - poly_a:-n_dup] = 0
    nodes = torch.randint(0, n_rows // 2, (n_rows,), generator=g)
    return KmerIndex.from_arrays(kmers, nodes, 1009, "cpu"), n_rows // 2


def _card_queries(ks, n, seed):
    """Half of them rows' k-mers, half uniform, 0.5% poly-A."""
    g = torch.Generator().manual_seed(seed)
    hits = ks[torch.randint(0, ks.shape[0], (n // 2,), generator=g)]
    q = torch.cat([hits, torch.randint(1, 1 << 62, (n - n // 2,),
                                       generator=g)])
    q[torch.randint(0, n, (n // 200,), generator=g)] = 0
    return q[torch.randperm(n, generator=g)]


def _on(tables, dev):
    return lookup.PackedTables(tables.records.to(dev), tables.ks.to(dev),
                               tables.ns.to(dev), tables.modulo2,
                               tables.max_sz, tables.deep_frac)


def _kernel_stats(monkeypatch, tables, q, n_valid, n_nodes, bucket_base=0,
                  m2_local=None):
    """K2's output and counters, counted as under a profiler session."""
    profiling.reset_counters()
    with monkeypatch.context() as m:
        m.setattr(profiling, "active", lambda: True)
        out = lookup.packed_lookup(tables, q, n_valid, n_nodes, bucket_base,
                                   m2_local)
    counted = profiling.counters(q.device)
    return out, {k: counted[k] for k in profiling.K2_COUNTERS}


@pytest.mark.card
@pytest.mark.parametrize("mode", ["counts", "membership", "shard"])
def test_kernel_counters_equal_the_twin(card, mode, monkeypatch):
    """K2's counters against the twin's over 2^20 queries (4,096 blocks),
    the last 1,000 padding; the outputs with the counters on equal those
    with them off, and the twin's, bit for bit. Shard mode: the four
    table shards of PackedTableShards, counts and membership (its poly-A
    bucket holds 200 rows: the table shards take none deeper than
    SCAN_CAP)."""
    index, n_nodes = _card_index(1 << 18, 21, 200 if mode == "shard" else 400)
    whole = index.device_index.packed()
    q = _card_queries(whole.ks, 1 << 20, 22)
    n_valid = q.shape[0] - 1000
    if mode == "shard":
        shards = sharded.PackedTableShards.from_index(index, 4)
        cases = [(sharded.shard_tables(
                      shards, t, shards.records, shards.row_kmers,
                      shards.row_nodes, torch.device("cpu")),
                  nn, t * shards.m2_local, shards.m2_local)
                 for t in range(4) for nn in (n_nodes, None)]
    else:
        cases = [(whole, n_nodes if mode == "counts" else None, 0, None)]
    qd = q.to(card)
    for tables, n_nodes_, base, m2l in cases:
        on_card = _on(tables, card)
        out, got = _kernel_stats(monkeypatch, on_card, qd, n_valid,
                                 n_nodes_, base, m2l)
        plain = lookup.packed_lookup(on_card, qd, n_valid, n_nodes_, base,
                                     m2l)
        assert torch.equal(out, plain)
        want_out, want = _twin_stats(tables, q, n_valid, n_nodes_, base,
                                     m2l)
        if n_nodes_ is None:
            assert torch.equal(out[:n_valid].cpu(), want_out[:n_valid])
        else:
            assert torch.equal(out.cpu(), want_out)
        assert got == want, (mode, n_nodes_, base, got, want)
        assert want["k2.pending"] > 0 and want["k2.scan_rows"] > 0


@pytest.mark.card
def test_kernel_time_with_and_without_counters(card, monkeypatch):
    """K2's device time in counts mode over 2^26 queries on a table of
    2^26 rows (a 4 GB record table, far above L2), with the counters and
    without, in turns (off, on, on, off), by CUDA events around 4
    launches; printed."""
    g = torch.Generator().manual_seed(31)
    n = 1 << 26
    kmers = torch.randint(1, 1 << 62, (n,), generator=g)
    tables = lookup.build_packed(kmers.to(card),
                                 torch.randint(0, n // 2, (n,),
                                               generator=g).to(card),
                                 internal_modulo(n))
    q = _card_queries(kmers, n, 32).to(card)
    del kmers

    def run(key):
        monkeypatch.setattr(profiling, "active", lambda: key == "on")
        lookup.packed_lookup(tables, q, n, n // 2)

    ms = {"off": [], "on": []}
    for _ in range(10):
        for key in ("off", "on", "on", "off"):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            # a launch ahead of the start event keeps the device busy
            # while the host enqueues the timed ones: their host time
            # stays out of the reading
            run(key)
            start.record()
            for _ in range(4):
                run(key)
            end.record()
            end.synchronize()
            ms[key].append(start.elapsed_time(end) / 4)
    off, on = np.median(ms["off"]), np.median(ms["on"])
    print(f"K2 counts mode, 2^26 queries, 2^26 rows, "
          f"{torch.cuda.get_device_name(card)}: off {off:.4f} ms, "
          f"on {on:.4f} ms (medians of 20 means of 4 launches), "
          f"on/off {on / off:.4f}")
    assert on > 0 and off > 0
