"""Port parity: the out-of-core build (graph_kmer_index_tpu_torch/
parallel/oocbuild.py, a copy of the JAX package's): the cases of
tests/test_oocbuild.py against the port (every decomposition of the build
reproduces the monolithic index), and the shard files of both packages
equal, file for file, for one graph and set of flags."""
import json
import os
import shutil

import jax  # noqa: F401  (same process set-up as the other port tests)
import numpy as np
import pytest
import torch

from graph_kmer_index_tpu.parallel import oocbuild as joocbuild
from graph_kmer_index_tpu.parallel.host_pool import \
    find_kmers_parallel as jax_find
from graph_kmer_index_tpu.utils.synthetic import \
    random_snp_graph as jax_random_snp_graph
from graph_kmer_index_tpu_torch import KmerIndex
from graph_kmer_index_tpu_torch.parallel import checkpoint as ckpt
from graph_kmer_index_tpu_torch.parallel import mesh
from graph_kmer_index_tpu_torch.parallel.host_pool import find_kmers_parallel
from graph_kmer_index_tpu_torch.parallel.oocbuild import (
    _COL_DTYPES, SpillWriter, _delete_range_spills, build_shards_from_spills,
    convert_checkpoint_to_packed, find_and_build_out_of_core,
    index_from_shard_checkpoint, reshard_checkpoint)
from graph_kmer_index_tpu_torch.parallel.sharded import (
    KMER_PAD, PackedTableShards, TableShards, make_count_step,
    make_count_step_packed)
from graph_kmer_index_tpu_torch.utils.synthetic import random_snp_graph

torch.set_num_threads(2)
MODULO = 1009
K = 7
INDEX_COLUMNS = ("kmers", "nodes", "ref_offsets", "allele_frequencies",
                 "n_kmers", "frequencies")


def _fixture(seed=13):
    graph, _ = random_snp_graph(4000, 50, seed=seed, indel_fraction=0.3)
    flat = find_kmers_parallel(graph, K, n_workers=1)
    mono = KmerIndex.from_flat_kmers(flat, modulo=MODULO, device="cpu")
    return graph, flat, mono


def _assert_index_equal(a, b):
    for name in INDEX_COLUMNS:
        x, y = a._file_column(name), b._file_column(name)
        assert np.array_equal(np.asarray(x).astype(np.float64),
                              np.asarray(y).astype(np.float64)), name
    sizes = np.asarray(a._file_column("n_kmers"))
    nz = sizes > 0
    assert np.array_equal(np.asarray(a._file_column("hashes_to_index"))[nz],
                          np.asarray(b._file_column("hashes_to_index"))[nz])


def _spill_flat(spill_dir, flat, n_chunks, n_ranges, modulo=MODULO):
    w = SpillWriter(spill_dir, modulo, n_ranges)
    h = np.asarray(flat._hashes, dtype=np.uint64)
    bounds = np.linspace(0, len(h), n_chunks + 1).astype(int)
    for c in range(n_chunks):
        s = slice(bounds[c], bounds[c + 1])
        w.add_chunk(c, h[s], np.asarray(flat._nodes)[s],
                    np.asarray(flat._ref_offsets)[s],
                    np.asarray(flat._allele_frequencies)[s])
    return w


def _queries(flat, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.choice(np.asarray(flat._hashes, dtype=np.uint64), 64),
        rng.integers(0, 1 << 40, 64).astype(np.uint64)])


@pytest.fixture
def one_rank():
    """A (1, 1) mesh on a one-rank gloo group."""
    mesh.start_process_group("cpu")
    try:
        yield mesh.build_mesh(1, 1)
    finally:
        mesh.stop_process_group()


def _serve(m, prefix, n_nodes, qs):
    """Counts of pre-hashed queries served from a one-shard checkpoint."""
    shards = ckpt.load_shards(prefix, mesh=m)
    q = torch.from_numpy(np.concatenate(
        [qs.view(np.int64), np.full(5, KMER_PAD, np.int64)]))
    if isinstance(shards, PackedTableShards):
        step = make_count_step_packed(m, shards, n_nodes, K,
                                      from_kmers=True)
        cols = (shards.records,)
    else:
        step = make_count_step(m, shards, n_nodes, K, from_kmers=True)
        cols = (shards.starts, shards.sizes)
    return step(q, *cols, shards.row_kmers, shards.row_nodes).numpy()


@pytest.mark.parametrize("n_ranges", [1, 3, 8])
def test_spill_build_matches_monolithic(tmp_path, n_ranges):
    graph, flat, mono = _fixture()
    _spill_flat(str(tmp_path / "spill"), flat, n_chunks=5,
                n_ranges=n_ranges)
    res = build_shards_from_spills(str(tmp_path / "spill"),
                                   str(tmp_path / "index"))
    assert res["total_rows"] == len(flat)
    ooc = index_from_shard_checkpoint(str(tmp_path / "index"), "cpu")
    _assert_index_equal(ooc, mono)


def test_ooc_shards_match_from_index(tmp_path):
    graph, flat, mono = _fixture()
    n_ranges = 4
    _spill_flat(str(tmp_path / "spill"), flat, 3, n_ranges)
    build_shards_from_spills(str(tmp_path / "spill"),
                             str(tmp_path / "index"))
    got = ckpt.load_shards(str(tmp_path / "index"))
    want = TableShards.from_index(mono, n_ranges)
    assert got.modulo == want.modulo and got.m_local == want.m_local
    assert got.max_scan == want.max_scan
    assert np.array_equal(got.sizes, want.sizes)
    assert np.array_equal(got.row_kmers, want.row_kmers)
    assert np.array_equal(got.row_nodes, want.row_nodes)
    nz = want.sizes > 0
    assert np.array_equal(got.starts[nz], want.starts[nz])


def test_ooc_checkpoint_serves_on_mesh(tmp_path, one_rank):
    graph, flat, mono = _fixture()
    _spill_flat(str(tmp_path / "spill"), flat, 4, 1)
    build_shards_from_spills(str(tmp_path / "spill"),
                             str(tmp_path / "index"))
    qs = _queries(flat, 5)
    assert np.array_equal(
        _serve(one_rank, str(tmp_path / "index"), graph.n_nodes(), qs),
        mono.map_kmers(qs, graph.n_nodes()))


def test_spill_crash_truncation_and_order(tmp_path):
    graph, flat, mono = _fixture(seed=21)
    d = str(tmp_path / "spill")
    w = _spill_flat(d, flat, n_chunks=6, n_ranges=3)
    # only 4 of 6 chunks "completed" before the crash: rebuild journal
    with open(os.path.join(d, "journal.jsonl")) as f:
        lines = f.readlines()
    with open(os.path.join(d, "journal.jsonl"), "w") as f:
        f.writelines(lines[:4])
    # simulate a torn post-crash append beyond the journal
    with open(os.path.join(d, "range-00001.kmers.bin"), "ab") as f:
        f.write(b"\xff" * 24)

    w2 = SpillWriter(d, MODULO, 3)
    assert w2.done == {0, 1, 2, 3}
    with pytest.raises(ValueError):
        w2.add_chunk(5, *[np.zeros(0)] * 4)  # out of order
    h = np.asarray(flat._hashes, dtype=np.uint64)
    bounds = np.linspace(0, len(h), 7).astype(int)
    for c in (3, 4, 5):  # 3 is journaled: must be a no-op replay
        s = slice(bounds[c], bounds[c + 1])
        w2.add_chunk(c, h[s], np.asarray(flat._nodes)[s],
                     np.asarray(flat._ref_offsets)[s],
                     np.asarray(flat._allele_frequencies)[s])
    assert np.array_equal(w2.range_rows, w.range_rows)
    build_shards_from_spills(d, str(tmp_path / "index"))
    _assert_index_equal(
        index_from_shard_checkpoint(str(tmp_path / "index"), "cpu"), mono)


def test_build_stage_resumes_per_shard(tmp_path):
    graph, flat, mono = _fixture(seed=33)
    d = str(tmp_path / "spill")
    _spill_flat(d, flat, n_chunks=4, n_ranges=4)
    prefix = str(tmp_path / "index")
    build_shards_from_spills(d, prefix)
    os.remove(ckpt.manifest_path(prefix))
    os.remove(ckpt.shard_path(prefix, 2, 4))
    kept = {t: os.path.getmtime(ckpt.shard_path(prefix, t, 4))
            for t in (0, 1, 3)}
    build_shards_from_spills(d, prefix)
    for t, mt in kept.items():
        assert os.path.getmtime(ckpt.shard_path(prefix, t, 4)) == mt, \
            f"shard {t} was rebuilt needlessly"
    _assert_index_equal(index_from_shard_checkpoint(prefix, "cpu"), mono)


def test_find_and_build_out_of_core_end_to_end(tmp_path):
    graph, flat, mono = _fixture(seed=44)
    wd = str(tmp_path / "wd")
    res = find_and_build_out_of_core(
        graph, K, n_workers=1, workdir=wd, modulo=MODULO, n_ranges=4,
        checkpoint_dir=os.path.join(wd, "findck"), delete_spills=True)
    assert res["spilled_rows"] == len(flat)
    _assert_index_equal(
        index_from_shard_checkpoint(os.path.join(wd, "index"), "cpu"), mono)
    assert not any(f.endswith(".bin")
                   for f in os.listdir(os.path.join(wd, "spill")))
    # resume: wipe spill + index, keep find checkpoints
    shutil.rmtree(os.path.join(wd, "spill"))
    for f in list(os.listdir(wd)):
        if f.startswith("index"):
            os.remove(os.path.join(wd, f))
    res2 = find_and_build_out_of_core(
        graph, K, n_workers=1, workdir=wd, modulo=MODULO, n_ranges=4,
        checkpoint_dir=os.path.join(wd, "findck"), delete_spills=False)
    assert res2["spilled_rows"] == len(flat)
    _assert_index_equal(
        index_from_shard_checkpoint(os.path.join(wd, "index"), "cpu"), mono)


def test_spill_refuses_mismatched_inputs(tmp_path):
    d = str(tmp_path / "spill")
    SpillWriter(d, MODULO, 4)
    with pytest.raises(ValueError):
        SpillWriter(d, MODULO, 8)
    with pytest.raises(ValueError):
        SpillWriter(d, 2003, 4)


def test_empty_and_tiny_inputs(tmp_path):
    w = SpillWriter(str(tmp_path / "s0"), 17, 8)
    w.add_chunk(0, *[np.zeros(0, d) for d in
                     (np.uint64, np.int32, np.uint64, np.float32)])
    res = build_shards_from_spills(str(tmp_path / "s0"),
                                   str(tmp_path / "i0"))
    assert res["total_rows"] == 0
    idx = index_from_shard_checkpoint(str(tmp_path / "i0"), "cpu")
    assert idx.kmers.shape[0] == 0
    assert not idx.has_kmers(np.array([3], dtype=np.uint64)).any()


@pytest.mark.parametrize("workers", [1, 3])
def test_packed_conversion_matches_from_index(tmp_path, workers, one_rank):
    graph, flat, mono = _fixture(seed=55)
    _spill_flat(str(tmp_path / "spill"), flat, 4, 4)
    build_shards_from_spills(str(tmp_path / "spill"),
                             str(tmp_path / "index"))
    for n_table in (4, 1):
        res = convert_checkpoint_to_packed(
            str(tmp_path / "index"), str(tmp_path / f"p{n_table}"),
            n_table=n_table, n_workers=workers)
        got = ckpt.load_shards(res["prefix"])
        want = PackedTableShards.from_index(mono, n_table)
        for attr in ("modulo2", "m2_local", "max_scan", "has_dup"):
            assert getattr(got, attr) == getattr(want, attr), attr
        assert np.array_equal(got.records, want.records)
        assert np.array_equal(got.row_kmers, want.row_kmers)
        assert np.array_equal(got.row_nodes, want.row_nodes)
    qs = _queries(flat, 9)
    assert np.array_equal(_serve(one_rank, res["prefix"], graph.n_nodes(),
                                 qs), mono.map_kmers(qs, graph.n_nodes()))


def test_out_of_order_stash_path(tmp_path):
    graph, flat, mono = _fixture(seed=66)
    wd = str(tmp_path / "wd")
    res = find_and_build_out_of_core(
        graph, K, n_workers=3, workdir=wd, modulo=MODULO, n_ranges=4,
        stash_ram_chunks=0, delete_spills=False,
        checkpoint_dir=os.path.join(wd, "findck"))
    assert res["spilled_rows"] == len(flat)
    _assert_index_equal(
        index_from_shard_checkpoint(os.path.join(wd, "index"), "cpu"), mono)
    stash = os.path.join(wd, "stash")
    assert not os.path.isdir(stash) or not os.listdir(stash)


def test_worker_spill_mode_matches_monolithic(tmp_path):
    graph, flat, mono = _fixture(seed=88)
    wd = str(tmp_path / "wd")
    res = find_and_build_out_of_core(
        graph, K, n_workers=3, workdir=wd, modulo=MODULO, n_ranges=4,
        delete_spills=False)
    assert res["spilled_rows"] == len(flat)
    _assert_index_equal(
        index_from_shard_checkpoint(os.path.join(wd, "index"), "cpu"), mono)
    spill = os.path.join(wd, "spill")
    assert any(f.startswith("chunk-") for f in os.listdir(spill))
    jp = os.path.join(spill, "journal.jsonl")
    with open(jp) as f:
        lines = f.readlines()
    with open(jp, "w") as f:
        f.writelines(lines[:-2])
    torn = os.path.join(spill, "chunk-99999990-99999999.range-00001"
                               ".kmers.bin")
    with open(torn, "wb") as f:
        f.write(b"\xff" * 16)
    for fn in list(os.listdir(wd)):
        if fn.startswith("index"):
            os.remove(os.path.join(wd, fn))
    res2 = find_and_build_out_of_core(
        graph, K, n_workers=3, workdir=wd, modulo=MODULO, n_ranges=4,
        delete_spills=False)
    assert res2["spilled_rows"] == len(flat)
    _assert_index_equal(
        index_from_shard_checkpoint(os.path.join(wd, "index"), "cpu"), mono)
    assert not os.path.exists(torn)


def test_rerun_after_completion_with_deleted_spills(tmp_path):
    graph, flat, mono = _fixture(seed=77)
    d = str(tmp_path / "spill")
    _spill_flat(d, flat, n_chunks=3, n_ranges=4)
    prefix = str(tmp_path / "index")
    build_shards_from_spills(d, prefix, delete_spills=True)
    assert not any(f.endswith(".bin") for f in os.listdir(d))
    res = build_shards_from_spills(d, prefix, delete_spills=True)
    assert res["total_rows"] == len(flat)
    _assert_index_equal(index_from_shard_checkpoint(prefix, "cpu"), mono)

    wd = str(tmp_path / "pk")
    convert_checkpoint_to_packed(prefix, wd, n_table=4)
    res2 = convert_checkpoint_to_packed(prefix, wd, n_table=4)
    assert res2["total_rows"] == len(flat)
    wd2 = str(tmp_path / "pk2")
    convert_checkpoint_to_packed(prefix, wd2, n_table=4,
                                 delete_spills=False)
    os.remove(ckpt.shard_path(os.path.join(wd2, "packed"), 1, 4))
    convert_checkpoint_to_packed(prefix, wd2, n_table=4,
                                 delete_spills=False)
    a = ckpt.load_shards(os.path.join(wd, "packed"))
    b = ckpt.load_shards(os.path.join(wd2, "packed"))
    assert np.array_equal(a.records, b.records)


def test_resume_with_different_workers_refused(tmp_path):
    graph, flat, mono = _fixture(seed=99)
    wd = str(tmp_path / "wd")
    find_and_build_out_of_core(graph, K, n_workers=1, workdir=wd,
                               modulo=MODULO, n_ranges=4,
                               delete_spills=False)
    for f in list(os.listdir(wd)):
        if f.startswith("index"):
            os.remove(os.path.join(wd, f))
    with pytest.raises(ValueError, match="different inputs"):
        find_and_build_out_of_core(graph, K, n_workers=3, workdir=wd,
                                   modulo=MODULO, n_ranges=4,
                                   delete_spills=False)
    res = find_and_build_out_of_core(graph, K, n_workers=1, workdir=wd,
                                     modulo=MODULO, n_ranges=4,
                                     delete_spills=False)
    assert res["spilled_rows"] == len(flat)
    _assert_index_equal(
        index_from_shard_checkpoint(os.path.join(wd, "index"), "cpu"), mono)


def test_reshard_checkpoint_serves_identically(tmp_path, one_rank):
    graph, flat, mono = _fixture(seed=111)
    _spill_flat(str(tmp_path / "spill"), flat, 3, 8)
    build_shards_from_spills(str(tmp_path / "spill"), str(tmp_path / "i8"))
    res = reshard_checkpoint(str(tmp_path / "i8"), str(tmp_path / "i4"), 4)
    assert res["n_table"] == 4 and res["total_rows"] == len(flat)
    _spill_flat(str(tmp_path / "spill4"), flat, 3, 4)
    build_shards_from_spills(str(tmp_path / "spill4"), str(tmp_path / "d4"))
    a = ckpt.load_shards(str(tmp_path / "i4"))
    b = ckpt.load_shards(str(tmp_path / "d4"))
    ar = np.concatenate([a.row_kmers[t][:int(a.sizes[t].sum())]
                         for t in range(4)])
    br = np.concatenate([b.row_kmers[t][:int(b.sizes[t].sum())]
                         for t in range(4)])
    assert np.array_equal(ar, br)
    _assert_index_equal(
        index_from_shard_checkpoint(str(tmp_path / "i4"), "cpu"), mono)
    reshard_checkpoint(str(tmp_path / "i8"), str(tmp_path / "i1"), 1)
    qs = _queries(flat, 12)
    assert np.array_equal(_serve(one_rank, str(tmp_path / "i1"),
                                 graph.n_nodes(), qs),
                          mono.map_kmers(qs, graph.n_nodes()))


def test_kn_only_spill_serves_counts(tmp_path, one_rank):
    graph, flat, mono = _fixture(seed=123)
    wd = str(tmp_path / "wd")
    res = find_and_build_out_of_core(
        graph, K, n_workers=2, workdir=wd, modulo=MODULO, n_ranges=1,
        spill_cols="kn", delete_spills=True)
    assert res["spilled_rows"] == len(flat)
    prefix = os.path.join(wd, "index")
    with pytest.raises(ValueError, match="spill_cols='kn'"):
        index_from_shard_checkpoint(prefix, "cpu")
    qs = _queries(flat, 7)
    assert np.array_equal(_serve(one_rank, prefix, graph.n_nodes(), qs),
                          mono.map_kmers(qs, graph.n_nodes()))


def test_kn_checkpoint_reshard_and_packed_convert(tmp_path):
    graph, flat, mono = _fixture(seed=131)
    wd = str(tmp_path / "wd")
    find_and_build_out_of_core(graph, K, n_workers=1, workdir=wd,
                               modulo=MODULO, n_ranges=8, spill_cols="kn")
    prefix = os.path.join(wd, "index")
    res = reshard_checkpoint(prefix, str(tmp_path / "r4"), 4)
    assert res["total_rows"] == len(flat)
    got = ckpt.load_shards(str(tmp_path / "r4"))
    rows = np.concatenate([got.row_kmers[t][:int(got.sizes[t].sum())]
                           for t in range(4)])
    assert np.array_equal(rows, mono.kmers.numpy())
    pres = convert_checkpoint_to_packed(prefix, str(tmp_path / "pk"),
                                        n_table=4)
    pgot = ckpt.load_shards(pres["prefix"])
    assert np.array_equal(pgot.records,
                          PackedTableShards.from_index(mono, 4).records)


def test_reentry_after_delete_spills(tmp_path):
    graph, flat, mono = _fixture(seed=141)
    wd = str(tmp_path / "wd")
    find_and_build_out_of_core(graph, K, n_workers=1, workdir=wd,
                               modulo=MODULO, n_ranges=4,
                               delete_spills=True)
    res = find_and_build_out_of_core(graph, K, n_workers=1, workdir=wd,
                                     modulo=MODULO, n_ranges=4,
                                     delete_spills=True)
    assert res["total_rows"] == len(flat)
    wd2 = str(tmp_path / "wd2")
    find_and_build_out_of_core(graph, K, n_workers=1, workdir=wd2,
                               modulo=MODULO, n_ranges=4,
                               delete_spills=False)
    prefix2 = os.path.join(wd2, "index")
    os.remove(ckpt.manifest_path(prefix2))
    os.remove(ckpt.shard_path(prefix2, 2, 4))
    with open(os.path.join(wd2, "spill", "meta.json")) as f:
        sm = json.load(f)
    w = SpillWriter(os.path.join(wd2, "spill"), sm["modulo"],
                    sm["n_ranges"], pins=sm.get("pins") or {},
                    cols=tuple((c, _COL_DTYPES[c]) for c in sm["cols"]),
                    m_range=sm.get("m_range"),
                    layout=sm.get("layout", "range"))
    for t in (0, 1, 3):
        _delete_range_spills(w, t)
    res2 = find_and_build_out_of_core(graph, K, n_workers=1, workdir=wd2,
                                      modulo=MODULO, n_ranges=4,
                                      delete_spills=True)
    assert res2["total_rows"] == len(flat)
    _assert_index_equal(index_from_shard_checkpoint(prefix2, "cpu"), mono)
    os.remove(ckpt.shard_path(prefix2, 2, 4))
    _delete_range_spills(w, 2)
    with pytest.raises(ValueError, match="missing"):
        find_and_build_out_of_core(graph, K, n_workers=1, workdir=wd2,
                                   modulo=MODULO, n_ranges=4,
                                   delete_spills=True)


def test_resume_flip_skip_frequencies_rebuilds(tmp_path):
    graph, flat, mono = _fixture(seed=151)
    d = str(tmp_path / "spill")
    _spill_flat(d, flat, n_chunks=3, n_ranges=4)
    prefix = str(tmp_path / "index")
    build_shards_from_spills(d, prefix, skip_frequencies=True)
    build_shards_from_spills(d, prefix, skip_frequencies=False)
    ooc = index_from_shard_checkpoint(prefix, "cpu")
    _assert_index_equal(ooc, mono)
    assert np.asarray(ooc.frequencies).sum() > 0


def test_flag_flip_names_the_flag_when_spills_are_gone(tmp_path):
    """Shards built under other flags whose spills were deleted: the
    error names the column set that changed (the JAX copy says only that
    a spill file is missing)."""
    graph, flat, mono = _fixture(seed=151)
    d = str(tmp_path / "spill")
    _spill_flat(d, flat, n_chunks=3, n_ranges=4)
    prefix = str(tmp_path / "index")
    build_shards_from_spills(d, prefix, skip_frequencies=True,
                             delete_spills=True)
    with pytest.raises(ValueError, match="skip_frequencies"):
        build_shards_from_spills(d, prefix, skip_frequencies=False)


@pytest.mark.parametrize("passes", [2, 3])
def test_pass_partitioned_spill_matches_single_pass(tmp_path, passes):
    graph, flat, mono = _fixture(seed=161)
    wd = str(tmp_path / f"p{passes}")
    res = find_and_build_out_of_core(
        graph, K, n_workers=2, workdir=wd, modulo=MODULO, n_ranges=6,
        n_spill_passes=passes, delete_spills=True)
    assert res["total_rows"] == len(flat)
    _assert_index_equal(
        index_from_shard_checkpoint(os.path.join(wd, "index"), "cpu"), mono)
    res2 = find_and_build_out_of_core(
        graph, K, n_workers=2, workdir=wd, modulo=MODULO, n_ranges=6,
        n_spill_passes=passes, delete_spills=True)
    assert res2["total_rows"] == len(flat)


def test_flag_flip_with_deleted_spills_refinds(tmp_path):
    graph, flat, mono = _fixture(seed=171)
    wd = str(tmp_path / "wd")
    find_and_build_out_of_core(graph, K, n_workers=1, workdir=wd,
                               modulo=MODULO, n_ranges=4,
                               skip_frequencies=False, delete_spills=True)
    shutil.rmtree(os.path.join(wd, "spill"))
    res = find_and_build_out_of_core(graph, K, n_workers=1, workdir=wd,
                                     modulo=MODULO, n_ranges=4,
                                     skip_frequencies=True,
                                     delete_spills=True)
    assert res["total_rows"] == len(flat)
    with np.load(ckpt.manifest_path(os.path.join(wd, "index"))) as z:
        extras = [str(x) for x in z["extras"]]
    assert "row_frequencies" not in extras, extras
    shutil.rmtree(os.path.join(wd, "spill"))
    find_and_build_out_of_core(graph, K, n_workers=1, workdir=wd,
                               modulo=MODULO, n_ranges=4,
                               skip_frequencies=False, delete_spills=True)
    _assert_index_equal(
        index_from_shard_checkpoint(os.path.join(wd, "index"), "cpu"), mono)


def _files(directory):
    return sorted(f for f in os.listdir(directory) if f.startswith("index")
                  or f.startswith("packed"))


@pytest.mark.parametrize("flags", [
    dict(n_workers=3, n_ranges=4),
    dict(n_workers=2, n_ranges=3, spill_cols="kn", skip_frequencies=True),
    dict(n_workers=1, n_ranges=4, n_spill_passes=2)])
def test_shard_files_equal_jax(tmp_path, flags):
    """The same graph and flags through both packages' out-of-core build,
    then the packed conversion: every npz file (shards and manifest)
    holds the same arrays, and the sidecar metadata is the same."""
    graph, _ = random_snp_graph(4000, 50, seed=181, indel_fraction=0.3)
    jgraph, _ = jax_random_snp_graph(4000, 50, seed=181, indel_fraction=0.3)
    jflat = jax_find(jgraph, K, n_workers=1)
    assert len(jflat) == len(find_kmers_parallel(graph, K, n_workers=1))
    port, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    find_and_build_out_of_core(graph, K, workdir=port, modulo=MODULO,
                               **flags)
    joocbuild.find_and_build_out_of_core(jgraph, K, workdir=jax_dir,
                                         modulo=MODULO, **flags)
    convert_checkpoint_to_packed(os.path.join(port, "index"), port,
                                 n_table=2)
    joocbuild.convert_checkpoint_to_packed(os.path.join(jax_dir, "index"),
                                           jax_dir, n_table=2)
    names = _files(port)
    assert names == _files(jax_dir) and len(names) > 6
    for name in names:
        a, b = os.path.join(port, name), os.path.join(jax_dir, name)
        if name.endswith(".json"):
            with open(a) as fa, open(b) as fb:
                assert json.load(fa) == json.load(fb), name
            continue
        with np.load(a) as za, np.load(b) as zb:
            assert sorted(za.files) == sorted(zb.files), name
            for key in zb.files:
                assert za[key].dtype == zb[key].dtype, (name, key)
                assert np.array_equal(za[key], zb[key]), (name, key)
