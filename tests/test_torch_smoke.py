"""chip_smoke.py's phases rehearsed on the CPU at a tiny size (the script's
entry point itself refuses a machine without CUDA), plus the kernel
build helpers and the synthetic data generator."""
import importlib.util
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
    probes = cs.probe_inputs(dev, gen, 1 << 12, 1 << 10, 2048, 32)
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

    # the CUDA-event timers need a card: compare the timed calls only
    monkeypatch.setattr(cs, "time_pair", host_pair)
    monkeypatch.setattr(cs, "time_one", lambda dev, fn, reps: fn() is None
                        or 3.0)
    timed = cs.time_lookup(dev, "CPU", state, lk)
    assert sorted(timed) == sorted(cs.LOOKUP_KERNELS)
    for name, fields in timed.items():
        assert sorted(fields) == ["bound_by", "bound_ms", "library_ms", "ms",
                                  "plain_ms"]
        assert fields["bound_ms"] > 0
    assert timed["rmw_loop"]["library_ms"] == 3.0
    assert timed["gather_loop"]["library_ms"] is None
    assert timed["bcast_cmp"]["library_ms"] is None
    # 2048 queries x 32 entries x 4 operations against 32 KB: operations
    assert timed["bcast_cmp"]["bound_by"] == "operations"
    assert timed["rmw_loop"]["bound_by"] == "bytes"
    out = capsys.readouterr().out
    assert "one PyTorch call (bincount) 3.000000 ms" in out
    assert "CSR counts and membership == the packed path's" in out
    assert "== the join on 500 sampled queries" in out
    assert "timing get_batched on 4096 queries" in out
    # a broken route is caught
    lk["get_tables"] = lk["get_tables"][:, 1:]
    with pytest.raises(AssertionError, match="searchsorted route"):
        cs.check_lookup(dev, state, lk, 500, gen)


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
    entries = cs.kernel_entries(launches, launches, launches, errs, timed)
    assert [e["name"] for e in entries] == list(_kernels.launch_counts)
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
