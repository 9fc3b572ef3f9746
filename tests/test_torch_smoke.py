"""chip_smoke.py's phases rehearsed on the CPU at a tiny size (the script's
entry point itself refuses a machine without CUDA), chip_compare.py's
argument parsing, plus the kernel build helpers and the synthetic data
generator."""
import importlib.util
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (same process set-up as the other port tests)
import numpy as np
import pytest
import torch

from graph_kmer_index_tpu_torch.ops import _kernels
from graph_kmer_index_tpu_torch.read_kmers import encode_block
from graph_kmer_index_tpu_torch.utils import synthetic

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_smoke_phases_on_cpu(tmp_path, capsys):
    cs = _smoke()
    dev = torch.device("cpu")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    assert cs.check_k1(dev, 3000, gen) == 0
    args = cs.parse_args(["--genome-bases", "120000", "--reads", "1500"])
    state = cs.main_path(dev, "CPU", args, tmp_path)
    cs.check_results(dev, state, cs.K, 50, np.random.default_rng(1))
    assert cs.check_at_main_shapes(state, cs.K) == (0, 0)
    assert cs.check_k2(dev, state, 4096, gen) == 0
    syncs = cs.profile_lookup(dev, "CPU", state, tmp_path / "profile.txt")
    # the CPU takes the plain twin, whose steps do wait for their sizes
    assert sorted(syncs) == ["has_kmers", "map_kmers"]
    assert all(isinstance(n, int) and n > 0 for n in syncs.values())
    tables = (tmp_path / "profile.txt").read_text()
    assert "== map_kmers" in tables and "== has_kmers" in tables
    out = capsys.readouterr().out
    assert "host syncs" in out and "aten::nonzero" in out
    assert "4096 queries (3096 valid)" in out
    assert "counts == join" in out and "membership == join" in out
    assert "on the main path's 120000 bases" in out
    # the planted poly-A run is an ultra-deep bucket
    assert state["tables"].max_sz > 256


def test_smoke_hashing_phase_on_cpu(capsys):
    cs = _smoke()
    dev = torch.device("cpu")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    assert cs.check_k3(dev, 3000, gen) == 0
    genome = torch.randint(0, 4, (5000,), dtype=torch.int8, generator=gen)
    # bench_primitives.py's small sizes: 2^10 x 128 rows, blocks of 128
    hashed = cs.hashing_path(dev, "CPU", genome, 1 << 10, 1 << 7, gen)
    assert hashed["sums"].shape == (8,)
    # 80 bytes (below one tile) and all but one 16-byte word of the table
    assert [n for n, _ in hashed["ragged"]] == [5, (1 << 15) - 1]
    assert ((1 << 15) - 1) * 16 % cs.primitives.COPY_TILE_BYTES
    errs = cs.check_hashing({"genome": genome}, hashed)
    for name in ("sliding_pack_p16", "sliding_pack_p8", "stream_copy"):
        assert errs[name] == {"max_abs_err": 0}
    assert errs["stream_sum"]["max_rel_err"] <= cs.SUM_RTOL
    # a ragged copy that lost its tail is caught
    hashed["ragged"][1][1][-1, -1] += 1.0
    with pytest.raises(AssertionError, match="K4 on 32767 words"):
        cs.check_hashing({"genome": genome}, hashed)
    out = capsys.readouterr().out
    assert "and on [80, 524272] bytes (tile 32768)" in out
    assert "on the main path's 5000 bases" in out
    assert "the P16 and the P8 route's k=31 rows == K1's" in out


def test_smoke_lookup_phase_on_cpu(tmp_path, capsys, monkeypatch):
    cs = _smoke()
    dev = torch.device("cpu")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    args = cs.parse_args(["--genome-bases", "120000", "--reads", "1500"])
    state = cs.main_path(dev, "CPU", args, tmp_path)
    # bench_primitives.py's small sizes
    probes = cs.probe_inputs(dev, gen, 1 << 12, 1 << 10, 2048, 32, n_cold=3)
    assert len(probes["cold"]) == 3 and probes["cold"][0] is probes["idx"]
    assert not torch.equal(probes["cold"][1], probes["cold"][2])
    lk = cs.lookup_path(dev, "CPU", state, probes, 100_003, 4096, gen)
    assert lk["default_route"] == "tables"  # 1.2 MB of tables: cheap
    assert lk["csr"].device_index.packed() is None
    assert lk["get_searched"].shape[1] > 1000
    errs = cs.check_lookup(dev, state, lk, 500, gen)
    assert errs == {name: {"max_abs_err": 0} for name in cs.LOOKUP_KERNELS}
    cs.profile_lookup(dev, "CPU", state, tmp_path / "profile.txt",
                      lk["csr"])
    assert "== CSR map_kmers" in (tmp_path / "profile.txt").read_text()

    def host_pair(dev, kernel, plain, reps, what, compare=cs.assert_equal):
        return 1.0, 2.0, (1.0, 1.0, 2.0, 2.0), compare(kernel(), plain(),
                                                        what)

    device_calls = []

    def host_device_time(dev, calls, rounds):
        device_calls.append((len(calls), rounds))
        for fn in calls:
            fn()
        return 0.5 * len(calls), {"a_kernel": 0.5 * len(calls)}

    # the CUDA-event timers and the profiler's device clock need a card:
    # make the timed calls only
    monkeypatch.setattr(cs, "time_pair", host_pair)
    monkeypatch.setattr(cs, "time_one", lambda dev, fn, reps: fn() is None
                        or 3.0)
    monkeypatch.setattr(cs, "device_time", host_device_time)
    monkeypatch.setattr(cs, "host_call_time", lambda dev, fn, reps:
                        fn() is None or 0.25)
    timed = cs.time_lookup(dev, "CPU", state, lk)
    assert sorted(timed) == sorted(cs.LOOKUP_KERNELS)
    base = ["bound_by", "bound_ms", "library_ms", "ms", "plain_ms"]
    for name, fields in timed.items():
        extra = (["device_ms", "host_call_ms"] if name == "bcast_cmp" else
                 ["events_ms", "host_call_ms", "warm_ms"])
        assert sorted(fields) == sorted(base + extra)
        assert fields["bound_ms"] > 0 and fields["host_call_ms"] == 0.25
    # K6 and K7: cold over the three buffers (100 // 3 rounds), warm on one
    # buffer as many launches; K8 once
    assert device_calls == [(3, 33), (1, 99), (3, 33), (1, 99), (1, 10)]
    for name in ("gather_loop", "rmw_loop"):
        assert timed[name]["ms"] == 1.5 and timed[name]["warm_ms"] == 0.5
        assert timed[name]["events_ms"] == 3.0
    assert timed["bcast_cmp"]["ms"] == 1.0
    assert timed["rmw_loop"]["library_ms"] == 3.0
    assert timed["gather_loop"]["library_ms"] is None
    assert timed["bcast_cmp"]["library_ms"] is None
    # 2048 queries x 32 entries x 4 operations against 32 KB: operations
    assert timed["bcast_cmp"]["bound_by"] == "operations"
    assert timed["rmw_loop"]["bound_by"] == "bytes"
    out = capsys.readouterr().out
    assert "one PyTorch call (bincount) 3.000000 ms" in out
    assert "cold indices (3 buffers of 4096 in turn) 1.500000 ms" in out
    assert "host cost of a call 0.250000 ms" in out
    # the inputs that the probes' designs make risky went through K6 and K7
    assert ("K6 and K7 == plain (exact) on (indices, block) {'outside': "
            "(4096, 1024), 'ragged': (124625, 125), 'skewed': (4096, 1024), "
            "'narrow': (8000, 125), 'tall': (8000, 125)}; K7 called again "
            "== its first table"
            ) in out
    assert "CSR counts and membership == the packed path's" in out
    assert "== the join on 500 sampled queries" in out
    assert "timing get_batched on 4096 queries" in out
    # a broken route is caught
    lk["get_tables"] = lk["get_tables"][:, 1:]
    with pytest.raises(AssertionError, match="searchsorted route"):
        cs.check_lookup(dev, state, lk, 500, gen)


def test_smoke_build_phase_on_cpu(capsys, monkeypatch):
    """The build phase at a tiny size: the small graph's device rows
    against the host's and the index against the numpy build, then graph
    -> critical paths -> streamed find -> index -> packed table -> read
    counts, and its checks."""
    cs = _smoke()
    dev = torch.device("cpu")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    args = cs.parse_args(["--build-bases", "120000", "--build-variants",
                          "480", "--build-reads", "300", "--check-bases",
                          "40000"])
    assert cs.parse_args([]).build_bases == 150_000_000
    assert cs.parse_args([]).build_variants == 600_000
    cs.require_native()
    cs.check_build_small(dev, "CPU", args, n_workers=2, mp_context=None,
                         modulo=10_007)
    monkeypatch.setattr(cs, "STREAM_TARGET", 50_000)
    _kernels.reset_launch_counts()
    built = cs.build_path(dev, "CPU", args, n_workers=2, mp_context=None,
                          modulo=100_003)
    stats = built["stats"]
    assert stats["groups"] >= 3 and built["n_rows"] == stats["span_rows"]
    assert built["counts"].shape == (built["n_nodes"],)
    assert built["index"].modulo == 100_003
    # a CPU tensor takes the twins: nothing was launched, and the check
    # says so
    with pytest.raises(AssertionError, match="sliding_hash was not launched "
                       "by the build path"):
        cs.check_build(dev, built, dict(_kernels.launch_counts), gen)
    launches = dict.fromkeys(_kernels.launch_counts, 0)
    launches.update(sliding_hash=stats["groups"] + 1, packed_lookup=1)
    assert cs.check_build(dev, built, launches, gen) == 0
    launches["sliding_hash"] = stats["groups"]
    with pytest.raises(AssertionError, match="once a span group"):
        cs.check_build(dev, built, launches, gen)
    launches["sliding_hash"] += 1
    built["counts"][5] += 1
    with pytest.raises(AssertionError, match="differ from the join"):
        cs.check_build(dev, built, launches, gen)
    built["counts"][5] -= 1
    built["n_rows"] += 1
    with pytest.raises(AssertionError, match="but the spans hold"):
        cs.check_build(dev, built, launches, gen)
    out = capsys.readouterr().out
    assert "the device's four columns == the host's (bit for bit)" in out
    assert "== a numpy build" in out
    for stage in ("graph build (host)", "critical paths (host)",
                  "streamed find (host walk + device finalize)",
                  "index build (from_flat_kmers: layout + frequencies)",
                  "packed table build", "read mapping (hash + map_kmers)"):
        assert f"stage {stage}: " in out
    assert "groups flushed" in out and "device idle share not measured" in out
    assert "node counts == join" in out


def test_smoke_signature_phase_on_cpu(tmp_path, capsys, monkeypatch):
    """The signature phase at a tiny size over a tiny build phase's graph
    and index: reference + variants -> graph -> sweep -> batched selection
    -> signature index -> bundle -> read counts, and its checks."""
    cs = _smoke()
    dev = torch.device("cpu")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    args = cs.parse_args(["--build-bases", "60000", "--build-variants",
                          "240", "--build-reads", "300"])
    cs.require_native()
    built = cs.build_path(dev, "CPU", args, n_workers=2, mp_context=None,
                          modulo=100_003)
    # the sweep hashes on the device whatever the tape's length
    monkeypatch.setattr(cs.SnpKmerFinder, "DEVICE_TAPE_THRESHOLD", 0)
    _kernels.reset_launch_counts()
    sig = cs.signature_path(dev, "CPU", args, built, tmp_path, modulo=10_007)
    selector = sig["selector"]
    assert selector.n_batched_variants == len(sig["variants"]) == 239
    assert selector.n_fallback_variants == selector.n_failed_variants == 0
    assert len(sig["signatures"]) == 478
    assert sig["loaded"]["KmerIndex"].modulo == 10_007
    assert sig["counts"].shape == (sig["n_nodes"],) and sig["counts"].sum() > 0
    rng = np.random.default_rng(4)
    # a CPU tensor takes the twins: nothing was launched, and the check
    # says so
    with pytest.raises(AssertionError, match="sliding_hash was not launched "
                       "by the signature path"):
        cs.check_signature(dev, "CPU", built, sig,
                           dict(_kernels.launch_counts), 200, 1000, 60, rng)
    launches = dict.fromkeys(_kernels.launch_counts, 0)
    launches.update(sliding_hash=2, packed_lookup=2)
    with pytest.raises(AssertionError, match="inside SnpKmerFinder"):
        cs.check_signature(dev, "CPU", built, sig, launches, 200, 1000, 60,
                           rng)
    sig["sweep_launches"] = sig["map_launches"] = 1
    assert cs.check_signature(dev, "CPU", built, sig, launches, 200, 1000,
                              60, rng) == 0
    sig["counts"][int(sig["counts"].argmax())] += 1
    with pytest.raises(AssertionError, match="differ from the join"):
        cs.check_signature(dev, "CPU", built, sig, launches, 200, 1000, 60,
                           rng)
    sig["counts"][int(sig["counts"].argmax())] -= 1
    sig["loaded"]["KmerIndex"].nodes[3] += 1
    with pytest.raises(AssertionError, match="read back from the bundle"):
        cs.check_signature(dev, "CPU", built, sig, launches, 200, 1000, 60,
                           rng)
    sig["loaded"]["KmerIndex"].nodes[3] -= 1
    sig["swept"]._hashes[:] += np.uint64(1)
    with pytest.raises(AssertionError, match="lacks the hash"):
        cs.check_signature(dev, "CPU", built, sig, launches, 200, 1000, 60,
                           rng)
    out = capsys.readouterr().out
    for stage in ("reference and variants (host, set-up)",
                  "graph from variants (build_graph_from_vcf, host)",
                  "sweep (SnpKmerFinder.find_kmers)",
                  "batched signature selection",
                  "signature index build (from_flat_kmers)",
                  "reverse, reference and variant-nodes indexes (host)",
                  "bundle write (IndexBundle.to_file)",
                  "bundle read (IndexBundle.from_file)",
                  "reads -> counts (hash_fasta_file + map_kmers on the "
                  "bundle's index)"):
        assert f"stage {stage}: " in out, stage
    assert "n_batched_variants 239" in out
    assert "graph from variants == the build path's graph" in out
    assert "batched == per-variant selection on 60 variants" in out


def test_smoke_numpy_index_build_is_the_jax_packages():
    """The independent numpy build that the smoke holds the port's index
    against agrees with the JAX package's host build."""
    from graph_kmer_index_tpu import CollisionFreeKmerIndex, FlatKmers
    cs = _smoke()
    rng = np.random.default_rng(3)
    kmers = rng.integers(0, 900, 4000).astype(np.uint64)
    offsets = rng.integers(0, 50, 4000).astype(np.uint64)
    ref = CollisionFreeKmerIndex.from_flat_kmers(
        FlatKmers(kmers, np.ones(4000, np.uint32), offsets,
                  np.ones(4000, np.single)), modulo=499, use_device=False)
    starts, sizes, freqs = cs.numpy_index_build(kmers, offsets, 499)
    assert np.array_equal(starts, ref._hashes_to_index)
    assert np.array_equal(sizes, ref._n_kmers)
    assert np.array_equal(freqs, ref._frequencies) and freqs.max() > 3


def test_smoke_kernel_entries_add_the_build_paths_launches():
    cs = _smoke()
    launches = dict.fromkeys(_kernels.launch_counts, 2)
    errs = {name: {"max_abs_err": 0} for name in launches}
    timed = {name: {"ms": 1.0, "plain_ms": 2.0, "library_ms": None,
                    **cs.bound(nbytes=1e6)} for name in launches}
    build = dict.fromkeys(_kernels.launch_counts, 0)
    build.update(sliding_hash=12, packed_lookup=1)
    signature = dict.fromkeys(_kernels.launch_counts, 0)
    signature.update(sliding_hash=3, packed_lookup=2)
    by_name = {e["name"]: e for e in cs.kernel_entries(
        launches, launches, launches, errs, timed,
        {"build": build, "signature": signature})}
    assert by_name["sliding_hash"]["launches"] == 17
    assert by_name["sliding_hash"]["launches_by_path"] == {
        "read_mapping": 2, "build": 12, "signature": 3}
    assert by_name["packed_lookup"]["launches"] == 5
    assert by_name["stream_copy"]["launches"] == 2
    assert "launches_by_path" not in by_name["stream_copy"]
    assert set(cs.BUILD_KERNELS) <= set(_kernels.launch_counts)


def test_smoke_probe_edge_cases_and_timers_on_cpu(capsys):
    """The index sets that the designs of K6 and K7 make risky, and the two
    timers as far as a machine without a card can run them."""
    cs = _smoke()
    dev = torch.device("cpu")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    probes = cs.probe_inputs(dev, gen, 1 << 13, 1 << 11, 256, 16, n_cold=1)
    cases = cs.probe_edge_cases(probes, gen)
    assert sorted(cases) == ["narrow", "outside", "ragged", "skewed",
                             "tall"]
    rows = probes["table"].shape[0]
    idx, block_q, table = cases["outside"]
    assert int(idx.min()) < 0 and int(idx.max()) >= rows
    idx, block_q, table = cases["ragged"]
    assert block_q % 4 and idx.shape[0] % block_q == 0
    assert idx.is_contiguous() and idx.data_ptr() % 16 == 4
    idx, block_q, table = cases["skewed"]
    assert int((idx == rows // 3).sum()) >= idx.shape[0] // 2
    idx, block_q, table = cases["narrow"]
    assert tuple(table.shape) == (300, 3) and table.is_contiguous()
    assert block_q % 4 and int(idx.min()) < 0 and int(idx.max()) >= 300
    idx, block_q, table = cases["tall"]
    assert tuple(table.shape) == (cs.primitives.SHARED_BYTES // 4, 1)
    assert int(idx.max()) >= table.shape[0] - 2000
    assert cs.check_probe_edges(probes, gen) == 0
    assert "K7 called again == its first table" in capsys.readouterr().out
    # the device's clock needs a device: no card, no number
    with pytest.raises(AssertionError, match="no device activity"):
        cs.device_time(dev, [lambda: torch.zeros(8)], 2)
    calls = []
    ms = cs.host_call_time(dev, lambda: calls.append(1), 5)
    assert len(calls) == 6 and ms >= 0  # one warm-up, five timed


_COMPARE = """
import sys
sys.modules["jax"] = None
sys.modules["graph_kmer_index_tpu"] = None
import chip_compare
args = chip_compare.parse_args(["--parent-csrc", "p/csrc", "--design-csrc",
                                "a", "--design-csrc", "b", "--reps", "50"])
assert str(args.parent_csrc) == "p/csrc" and args.reps == 50
assert [str(d) for d in args.design_csrc] == ["a", "b"] and args.seed == 0
assert chip_compare.parse_args(["--parent-csrc", "p"]).design_csrc == []
try:
    chip_compare.parse_args([])
except SystemExit as e:
    assert e.code == 2
else:
    raise AssertionError("--parent-csrc is required")
import torch
if not torch.cuda.is_available():
    try:
        chip_compare.main(["--parent-csrc", "p"])
    except SystemExit as e:
        assert "no CUDA device" in str(e)
    else:
        raise AssertionError("ran without a card")
assert "jax" not in {m.split(".")[0] for m, v in sys.modules.items() if v}
print("ok")
"""


def test_compare_imports_and_parses_without_jax():
    proc = subprocess.run([sys.executable, "-c", _COMPARE], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_compare_takes_turns_forwards_and_backwards():
    spec = importlib.util.spec_from_file_location("chip_compare",
                                                  ROOT / "chip_compare.py")
    cc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cc)
    order = []

    def measure(call):
        order.append(call)
        return float(len(order))

    times = cc.in_turns(measure, {"new": "n", "parent": "p", "design": "d"})
    assert order == ["n", "p", "d", "d", "p", "n"]
    assert times == {"new": (3.5, 1.0, 6.0), "parent": (3.5, 2.0, 5.0),
                     "design": (3.5, 3.0, 4.0)}


def test_smoke_join_applies_the_caps(tmp_path):
    cs = _smoke()
    dev = torch.device("cpu")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    args = cs.parse_args(["--genome-bases", "60000", "--reads", "400"])
    state = cs.main_path(dev, "CPU", args, tmp_path)
    probes = cs.probe_inputs(dev, gen, 1 << 12, 1 << 10, 2048, 32)
    lk = cs.lookup_path(dev, "CPU", state, probes, 1009, 2048, gen)
    sample = torch.arange(2048)
    for hit_cap, freq_cap in ((10000, 20), (50, 3), (cs.CAPS_OFF,
                                                     cs.CAPS_OFF)):
        want = lk["tabled"].get_batched(lk["q"], hit_cap=hit_cap,
                                        frequency_cap=freq_cap)
        assert torch.equal(cs.join_rows(state, lk, sample, hit_cap,
                                        freq_cap), want)


def test_smoke_requires_each_paths_kernels():
    cs = _smoke()
    assert (sorted(cs.READ_MAPPING_KERNELS + cs.HASHING_KERNELS
                   + cs.LOOKUP_KERNELS) == sorted(_kernels.launch_counts))
    launches = dict.fromkeys(_kernels.launch_counts, 1)
    cs.require_launches(launches, cs.HASHING_KERNELS, "hashing path")
    launches["stream_sum"] = 0
    cs.require_launches(launches, cs.READ_MAPPING_KERNELS, "read-mapping")
    with pytest.raises(AssertionError, match="stream_sum was not launched "
                       "by the hashing path"):
        cs.require_launches(launches, cs.HASHING_KERNELS, "hashing path")


def test_smoke_bounds_and_kernel_entries():
    cs = _smoke()
    assert cs.bound(nbytes=3.35e9) == {"bound_ms": 1.0, "bound_by": "bytes"}
    assert cs.bound(nbytes=3.35e6, ops=16.75e9) == {
        "bound_ms": 1.0, "bound_by": "operations"}
    launches = dict.fromkeys(_kernels.launch_counts, 2)
    errs = {name: {"max_abs_err": 0} for name in launches}
    timed = {name: {"ms": 1.0, "plain_ms": 2.0, "library_ms": None,
                    **cs.bound(nbytes=1e6)} for name in launches}
    for name in ("gather_loop", "rmw_loop"):
        timed[name].update(warm_ms=0.5, host_call_ms=0.25, events_ms=0.3)
    entries = cs.kernel_entries(launches, launches, launches, errs, timed)
    assert [e["name"] for e in entries] == list(_kernels.launch_counts)
    by_name = {e["name"]: e for e in entries}
    for name in ("gather_loop", "rmw_loop"):
        assert by_name[name]["warm_ms"] == 0.5
        assert by_name[name]["host_call_ms"] == 0.25
    assert "warm_ms" not in by_name["stream_copy"]
    for entry in entries:
        assert set(cs.KERNEL_KEYS) <= set(entry)
        assert (ROOT / entry["source"]).exists()
    del timed["stream_copy"]["bound_ms"]
    with pytest.raises(AssertionError, match="stream_copy lacks"):
        cs.kernel_entries(launches, launches, launches, errs, timed)


def test_smoke_k2_bytes_counts_the_scanned_rows(tmp_path):
    cs = _smoke()
    args = cs.parse_args(["--genome-bases", "60000", "--reads", "400"])
    state = cs.main_path(torch.device("cpu"), "CPU", args, tmp_path)
    t, n_nodes = state["tables"], state["n_nodes"]
    seg = state["read_kmers"].segments[0]
    cls = cs.query_classes(t, seg).tolist()
    assert sum(cls) == seg.shape[0] and min(cls) > 0
    moved = cs.k2_bytes(t, seg, n_nodes)
    # more than the records and the counts: the poly-A bucket is scanned
    assert moved > seg.shape[0] * 40 + n_nodes * 8 + 8 * cs.lookup.SCAN_CAP
    final_only = seg[:8]
    if cs.query_classes(t, final_only)[0] == 8:
        assert cs.k2_bytes(t, final_only, n_nodes) == 8 * 40 + n_nodes * 8


def test_smoke_sum_tolerance():
    cs = _smoke()
    want = torch.tensor([1000.0, 2000.0])
    assert cs.assert_close_sums(want + 0.05, want, "sums") <= cs.SUM_RTOL
    with pytest.raises(AssertionError, match="relative error"):
        cs.assert_close_sums(want + 1.0, want, "sums")


def test_smoke_refuses_a_machine_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cs = _smoke()
    with pytest.raises(SystemExit, match="no CUDA device"):
        cs.main([])


def test_kernel_library_name_tracks_sources():
    path = _kernels.library_path()
    assert path.parent == _kernels.BUILD_DIR
    assert path.name.startswith("libgki_torch_") and path.suffix == ".so"
    assert path == _kernels.library_path()
    for name in _kernels.SOURCES:
        assert (_kernels.CSRC_DIR / name).exists()


def test_wrappers_refuse_what_the_kernels_do_not_take():
    t = torch.zeros(8, dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.check_cuda_tensor(t, "seq", torch.int8, 1)
    with pytest.raises(RuntimeError, match="CUDA error 2"):
        _kernels.check_launch("sliding_hash", 2)


def test_synthetic_genome_and_reads(tmp_path):
    rng = np.random.default_rng(3)
    genome, poly_a = synthetic.random_genome(50_000, rng)
    assert genome.dtype == np.int8 and len(genome) == 50_000
    start, length = poly_a
    assert length == synthetic.POLY_A_LEN
    assert not genome[start:start + length].any()
    reads = synthetic.sample_reads(genome, 2000, 150, rng, poly_a)
    assert reads.shape == (2000, 150) and reads.max() <= 3
    # 1% of the reads overlap the poly-A run
    assert (reads[:20] == 0).sum(axis=1).min() > 0
    path = tmp_path / "r.fa"
    synthetic.write_fasta(path, reads)
    flat, starts, lens = encode_block(path.read_bytes())
    assert np.array_equal(flat.reshape(2000, 150), reads)
    assert np.array_equal(lens, np.full(2000, 150))
    assert np.array_equal(starts, np.arange(2000) * 150)


@pytest.mark.parametrize("attr,function", [
    ("K1_REPLACES", "def _hash_kernel("),
    ("K2_REPLACES", "def _decode_group_rows("),
    ("K3_REPLACES", "def _pack_kernel("),
    ("K4_REPLACES", "def k_pallas_stream_copy("),
    ("K5_REPLACES", "def k_pallas_stream_sum("),
    ("K6_REPLACES", "def k_pallas_gather_loop("),
    ("K7_REPLACES", "def k_pallas_rmw_loop("),
    ("K8_REPLACES", "def k_pallas_bcast_cmp(")])
def test_smoke_names_the_replaced_code(attr, function):
    """The file:line each kernel reports as replaced is that function."""
    path, line = getattr(_smoke(), attr).rsplit(":", 1)
    source = (ROOT / path).read_text().splitlines()
    assert source[int(line) - 1].startswith(function)


def test_smoke_sharded_phase_on_cpu(tmp_path, capsys):
    """The sharded phase at a tiny size over a tiny build phase: the
    out-of-core build -> the index back -> packed shards served by K2's
    shard mode -> reshard -> map_reads -T on a spawned gloo rank, and its
    checks."""
    cs = _smoke()
    dev = torch.device("cpu")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    args = cs.parse_args(["--build-bases", "60000", "--build-variants",
                          "240", "--build-reads", "300"])
    cs.require_native()
    built = cs.build_path(dev, "CPU", args, n_workers=2, mp_context=None,
                          modulo=100_003)
    _kernels.reset_launch_counts()
    sh = cs.sharded_path(dev, "CPU", args, built, tmp_path, gen, n_workers=2,
                         mp_context=None, modulo=100_003)
    assert sh["ooc"]["total_rows"] == built["n_rows"]
    assert sh["k2_err"] == 0 and sh["served"].sum() > 0
    assert sh["rank_launches"]["sliding_hash"] == 0  # a CPU rank: twins
    # a CPU tensor takes the twins: nothing was launched, and the check
    # says so
    with pytest.raises(AssertionError, match="sliding_hash was not launched "
                       "by the sharded path"):
        cs.check_sharded(dev, built, sh, dict(_kernels.launch_counts))
    launches = dict.fromkeys(_kernels.launch_counts, 0)
    launches.update(sliding_hash=1, packed_lookup=4)
    with pytest.raises(AssertionError, match="K1 was not launched by "
                       "map_reads -T"):
        cs.check_sharded(dev, built, sh, launches)
    sh["rank_launches"]["sliding_hash"] = 2
    cs.check_sharded(dev, built, sh, launches)
    sh["counts"][5] += 1
    with pytest.raises(AssertionError, match="do not sum"):
        cs.check_sharded(dev, built, sh, launches)
    sh["counts"][5] -= 1
    sh["served"][3] += 1
    with pytest.raises(AssertionError, match="map_reads -T counts"):
        cs.check_sharded(dev, built, sh, launches)
    sh["served"][3] -= 1
    sh["index"].n_kmers[7] += 1
    with pytest.raises(AssertionError, match="n_kmers differ"):
        cs.check_sharded(dev, built, sh, launches)
    out = capsys.readouterr().out
    for stage in ("out-of-core build (find_and_build_out_of_core)",
                  "index_from_shard_checkpoint onto the card",
                  "convert_shards_to_packed", "reshard_checkpoint to 1 "
                  "shard(s)", "map_reads -T (1 rank(s), spawned)"):
        assert f"stage {stage}: " in out
    assert "sharded path: the out-of-core index == the build path's" in out
