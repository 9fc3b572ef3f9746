"""Port parity: shard checkpoints (graph_kmer_index_tpu_torch/parallel/
checkpoint.py), every case of tests/test_checkpoint.py against the port,
and the files of each package read by the other. Loads onto a mesh run
on a one-rank gloo group here; tests/test_torch_sharded.py loads every
rank's shard on meshes of 2 and 4 ranks."""
import jax  # noqa: F401  (same process set-up as the other port tests)
import numpy as np
import pytest
import torch

import graph_kmer_index_tpu as jgki
import graph_kmer_index_tpu_torch as tgki
from graph_kmer_index_tpu.parallel import checkpoint as jckpt
from graph_kmer_index_tpu.parallel import sharded as jsh
from graph_kmer_index_tpu_torch.parallel import checkpoint as ckpt
from graph_kmer_index_tpu_torch.parallel import mesh
from graph_kmer_index_tpu_torch.parallel.sharded import (
    KMER_PAD, PackedTableShards, TableShards, make_count_step,
    make_count_step_packed)

torch.set_num_threads(2)
K = 5


def _toy_index():
    """The same toy graph's k-mers as a port index and a JAX index."""
    graph = tgki.Graph.from_dicts(
        {1: "ACTGACTGTCTAGGACTGAC", 2: "A", 3: "G", 4: "CCCTACTGTTTAGTCA"},
        {1: [2, 3], 2: [4], 3: [4]}, [1, 2, 4])
    finder = tgki.DenseKmerFinder(graph, k=K, device="cpu")
    finder.find()
    flat = finder.get_flat_kmers(v="0")
    index = tgki.KmerIndex.from_flat_kmers(flat, modulo=211, device="cpu")
    jindex = jgki.CollisionFreeKmerIndex.from_flat_kmers(
        jgki.FlatKmers(np.asarray(flat._hashes), np.asarray(flat._nodes),
                       np.asarray(flat._ref_offsets)), modulo=211)
    return graph, index, jindex


def _reads_and_expected(graph, index):
    from graph_kmer_index_tpu_torch.ops.encode import sliding_hashes
    rng = np.random.default_rng(2)
    ref_seq = np.concatenate([graph.get_numeric_node_sequence(v)
                              for v in [1, 2, 4]])
    reads = np.stack([np.resize(np.roll(ref_seq, -int(s)), 16)
                      for s in rng.integers(0, len(ref_seq), 8)]
                     ).astype(np.int32)
    hashes = sliding_hashes(torch.from_numpy(reads.reshape(-1)).to(
        torch.int8), K).numpy()
    valid = np.arange(reads.size) % reads.shape[1] <= reads.shape[1] - K
    return reads, index.map_kmers(hashes[valid], graph.n_nodes())


def _assert_same(got, want):
    assert type(got) is type(want)
    for attr in ("n_table", "max_scan", "m2_local", "modulo2", "has_dup",
                 "m_local", "modulo"):
        assert getattr(got, attr, None) == getattr(want, attr, None), attr
    cols = (("records", "row_kmers", "row_nodes")
            if isinstance(want, PackedTableShards)
            else ("starts", "sizes", "row_kmers", "row_nodes"))
    for name in cols:
        a, b = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name


@pytest.fixture
def one_rank():
    """A (1, 1) mesh on a one-rank gloo group."""
    mesh.start_process_group("cpu")
    try:
        yield mesh.build_mesh(1, 1)
    finally:
        mesh.stop_process_group()


@pytest.mark.parametrize("n_table", [1, 2, 8])
def test_packed_roundtrip_host(tmp_path, n_table):
    _, index, _ = _toy_index()
    want = PackedTableShards.from_index(index, n_table)
    prefix = str(tmp_path / f"packed{n_table}")
    paths = ckpt.save_shards(want, prefix)
    assert len(paths) == n_table + 1  # shards + manifest
    assert ckpt.manifest_path(prefix) in paths
    _assert_same(ckpt.load_shards(prefix), want)


def test_csr_roundtrip_host(tmp_path):
    _, index, _ = _toy_index()
    want = TableShards.from_index(index, 4)
    prefix = str(tmp_path / "csr")
    ckpt.save_shards(want, prefix)
    _assert_same(ckpt.load_shards(prefix), want)


def test_packed_mesh_load_serves_counts(tmp_path, one_rank):
    """Loading straight onto a mesh (the rank's own shard file onto its
    device) serves counts identical to the single index."""
    graph, index, _ = _toy_index()
    reads, expected = _reads_and_expected(graph, index)
    prefix = str(tmp_path / "serve")
    ckpt.save_shards(PackedTableShards.from_index(index, 1), prefix)
    shards = ckpt.load_shards(prefix, mesh=one_rank)
    assert isinstance(shards.records, torch.Tensor)
    assert shards.records.shape[0] == 1
    step = make_count_step_packed(one_rank, shards, graph.n_nodes(), K)
    got = step(reads, shards.records, shards.row_kmers, shards.row_nodes)
    assert np.array_equal(got.numpy(), expected)


def test_csr_mesh_load_serves_counts(tmp_path, one_rank):
    graph, index, _ = _toy_index()
    reads, expected = _reads_and_expected(graph, index)
    prefix = str(tmp_path / "csr_serve")
    ckpt.save_shards(TableShards.from_index(index, 1), prefix)
    shards = ckpt.load_shards(prefix, mesh=one_rank)
    step = make_count_step(one_rank, shards, graph.n_nodes(), K)
    got = step(reads, shards.starts, shards.sizes, shards.row_kmers,
               shards.row_nodes)
    assert np.array_equal(got.numpy(), expected)


def test_save_from_tensor_columns(tmp_path):
    """A container whose columns are tensors (as a device build leaves
    them) saves the same files as its numpy twin."""
    _, index, _ = _toy_index()
    want = PackedTableShards.from_index(index, 8)
    on_tensors = PackedTableShards(
        torch.from_numpy(want.records), torch.from_numpy(want.row_kmers),
        torch.from_numpy(want.row_nodes), want.m2_local, want.modulo2,
        want.max_scan, want.n_table, want.has_dup)
    prefix = str(tmp_path / "dev")
    ckpt.save_shards(on_tensors, prefix)
    _assert_same(ckpt.load_shards(prefix), want)


def test_load_rejects_mismatches(tmp_path, one_rank):
    _, index, _ = _toy_index()
    prefix = str(tmp_path / "bad")
    ckpt.save_shards(PackedTableShards.from_index(index, 2), prefix)

    # wrong mesh axis size
    with pytest.raises(ValueError, match="1 devices but"):
        ckpt.load_shards(prefix, mesh=one_rank)

    # torn/foreign shard file: wrong dtype for a column
    with np.load(ckpt.shard_path(prefix, 0, 2)) as z:
        cols = {k: z[k] for k in z.files}
    cols["row_kmers"] = cols["row_kmers"].astype(np.int32)
    with open(ckpt.shard_path(prefix, 0, 2), "wb") as f:
        np.savez(f, **cols)
    with pytest.raises(ValueError, match="row_kmers"):
        ckpt.load_shards(prefix)

    # future version refused
    with np.load(ckpt.manifest_path(prefix)) as z:
        meta = {k: z[k] for k in z.files}
    meta["version"] = np.int64(999)
    with open(ckpt.manifest_path(prefix), "wb") as f:
        np.savez(f, **meta)
    with pytest.raises(ValueError, match="version 999"):
        ckpt.load_shards(prefix)


def _short_slab_checkpoint(prefix, rows, shard_rows):
    """A CSR checkpoint whose row slabs are stored unpadded, as the
    out-of-core build writes them; ``shard_rows`` goes into the
    manifest unless None."""
    n_table, m_local, rmax = 2, 8, 6
    for t in range(n_table):
        ckpt._atomic_savez(
            ckpt.shard_path(prefix, t, n_table),
            starts=np.zeros(m_local, np.int64),
            sizes=np.zeros(m_local, np.int32),
            row_kmers=np.arange(rows[t], dtype=np.uint64) + 10 * t,
            row_nodes=np.arange(rows[t], dtype=np.int32))
    extra = {} if shard_rows is None else {
        "shard_rows": np.asarray(shard_rows, np.int64)}
    ckpt._atomic_savez(
        ckpt.manifest_path(prefix), kind="csr", version=1, n_table=n_table,
        m_local=m_local, modulo=16, max_scan=1,
        shape_starts=np.asarray([m_local]), shape_sizes=np.asarray([m_local]),
        shape_row_kmers=np.asarray([rmax]),
        shape_row_nodes=np.asarray([rmax]), **extra)


def test_unpadded_shard_columns_pad_at_load(tmp_path):
    """Short row slabs that hold their shard's rows pad to the manifest
    shape on read; a shard LARGER than the manifest is refused."""
    prefix = str(tmp_path / "p")
    _short_slab_checkpoint(prefix, [4, 6], [4, 6])
    got = ckpt.load_shards(prefix)
    assert got.row_kmers.shape == (2, 6)
    assert np.array_equal(got.row_kmers[0], [0, 1, 2, 3, 0, 0])
    assert np.array_equal(got.row_kmers[1], [10, 11, 12, 13, 14, 15])
    _short_slab_checkpoint(prefix, [8, 6], [8, 6])
    with pytest.raises(ValueError, match="manifest says"):
        ckpt.load_shards(prefix)


@pytest.mark.parametrize("shard_rows", [[5, 6], None])
def test_short_slab_below_its_rows_raises(tmp_path, shard_rows):
    """A slab shorter than the shard's stored row count (a stale or torn
    shard) raises, where the JAX loader would pad it with k-mer 0 rows;
    so does a short slab when the manifest does not say the row count."""
    prefix = str(tmp_path / "p")
    _short_slab_checkpoint(prefix, [4, 6], shard_rows)
    with pytest.raises(ValueError, match="short slab"):
        ckpt.load_shards(prefix)
    jax_read = jckpt.load_shards(prefix)  # pads without the check
    assert np.array_equal(jax_read.row_kmers[0], [0, 1, 2, 3, 0, 0])


@pytest.mark.parametrize("layout", ["packed", "csr"])
@pytest.mark.parametrize("n_table", [1, 4])
def test_each_package_reads_the_others_checkpoint(tmp_path, layout,
                                                  n_table):
    _, index, jindex = _toy_index()
    if layout == "packed":
        port, jax_ = (PackedTableShards.from_index(index, n_table),
                      jsh.PackedTableShards.from_index(jindex, n_table))
    else:
        port, jax_ = (TableShards.from_index(index, n_table),
                      jsh.TableShards.from_index(jindex, n_table))
    jckpt.save_shards(jax_, str(tmp_path / "by_jax"))
    _assert_same(ckpt.load_shards(str(tmp_path / "by_jax")), port)
    ckpt.save_shards(port, str(tmp_path / "by_port"))
    back = jckpt.load_shards(str(tmp_path / "by_port"))
    for name in vars(jax_):
        a, b = getattr(back, name), getattr(jax_, name)
        assert np.asarray(a).dtype == np.asarray(b).dtype, name
        assert np.array_equal(a, b), name
    assert ckpt.manifest_info(str(tmp_path / "by_port")) == \
        jckpt.manifest_info(str(tmp_path / "by_jax"))
    # the files themselves: same columns, dtypes and values
    for t in range(n_table):
        with np.load(ckpt.shard_path(str(tmp_path / "by_port"), t,
                                     n_table)) as a, \
                np.load(jckpt.shard_path(str(tmp_path / "by_jax"), t,
                                         n_table)) as b:
            assert sorted(a.files) == sorted(b.files)
            for key in b.files:
                assert a[key].dtype == b[key].dtype
                assert np.array_equal(a[key], b[key]), key


def test_jax_checkpoint_serves_on_a_port_mesh(tmp_path, one_rank):
    """A JAX-written packed checkpoint, loaded by a port rank, serves the
    counts of the single index (pre-hashed queries padded with
    KMER_PAD)."""
    graph, index, jindex = _toy_index()
    jckpt.save_shards(jsh.PackedTableShards.from_index(jindex, 1),
                      str(tmp_path / "j"))
    shards = ckpt.load_shards(str(tmp_path / "j"), mesh=one_rank)
    q = index.kmers.clone()
    want = index.map_kmers(q, graph.n_nodes())
    padded = torch.cat([q, torch.full((3,), KMER_PAD)])
    step = make_count_step_packed(one_rank, shards, graph.n_nodes(), K,
                                  from_kmers=True)
    got = step(padded, shards.records, shards.row_kmers, shards.row_nodes)
    assert np.array_equal(got.numpy(), want)
