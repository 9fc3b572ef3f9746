"""Port parity: the sharded serving of graph_kmer_index_tpu_torch
(parallel/sharded.py, K2's plain twin in shard mode) against the JAX
package's parallel/sharded.py on its 8-device CPU mesh.

The shard containers must equal the JAX package's array for array. The
steps run on gloo ranks spawned from here (tests/torch_dist_worker.py),
one spawn per world size, every mesh shape of that size in it; each rank
loads its own shard from a checkpoint. Their outputs must equal the JAX
steps at the same mesh shape and the single index's map_kmers /
has_kmers, exactly."""
import json
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import graph_kmer_index_tpu as jgki
import graph_kmer_index_tpu_torch as tgki
from graph_kmer_index_tpu.ops.encode import sliding_hashes
from graph_kmer_index_tpu.parallel import sharded as jsh
from graph_kmer_index_tpu_torch.ops import lookup as tlookup
from graph_kmer_index_tpu_torch.parallel import checkpoint as tckpt
from graph_kmer_index_tpu_torch.parallel import sharded as tsh

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_dist_worker.py"
K = 5
TOY = ({1: "ACTGACTGTCTAGGACTGAC", 2: "A", 3: "G", 4: "CCCTACTGTTTAGTCA"},
       {1: [2, 3], 2: [4], 3: [4]}, [1, 2, 4])
SHAPES = {2: [(2, 1), (1, 2)], 4: [(2, 2), (4, 1), (1, 4)]}
JAX_PAD = np.uint64(1 << 63)


def _indexes(flat_arrays, modulo):
    """The same rows as a JAX CollisionFreeKmerIndex and a port
    KmerIndex (CPU)."""
    kmers, nodes, refs = flat_arrays
    jindex = jgki.CollisionFreeKmerIndex.from_flat_kmers(
        jgki.FlatKmers(kmers, nodes, refs), modulo=modulo)
    tindex = tgki.KmerIndex.from_rows(kmers, nodes, refs,
                                      np.zeros(len(kmers), np.float32),
                                      modulo, device="cpu")
    return jindex, tindex


def _window_hashes(reads):
    """(all-position hashes, valid mask) of a (R, L) read matrix."""
    hashes = np.asarray(sliding_hashes(jnp.asarray(reads.reshape(-1)), K))
    valid = np.arange(reads.size) % reads.shape[1] <= reads.shape[1] - K
    return hashes.astype(np.uint64), valid


def _toy():
    graph = jgki.Graph.from_dicts(*TOY)
    finder = jgki.DenseKmerFinder(graph, k=K)
    finder.find()
    flat = finder.get_flat_kmers(v="0")
    rows = (np.asarray(flat._hashes, np.uint64),
            np.asarray(flat._nodes, np.uint32),
            np.asarray(flat._ref_offsets, np.uint64))
    rng = np.random.default_rng(4)
    ref_seq = np.concatenate([graph.get_numeric_node_sequence(v)
                              for v in [1, 2, 4]])
    reads = np.stack([np.resize(np.roll(ref_seq, -int(s)), 16)
                      for s in rng.integers(0, len(ref_seq), 8)]
                     ).astype(np.int32)
    reads[::2, 3:9] = rng.integers(0, 4, (4, 6))  # misses too
    hashes, valid = _window_hashes(reads)
    return rows, 211, graph.n_nodes(), reads, hashes[valid]


def _deep():
    """Buckets up to 5 rows deep and many dup2 buckets
    (tests/test_parallel.py:test_from_kmers_deep_and_dup2_buckets)."""
    rng = np.random.default_rng(11)
    uniq = np.unique(rng.integers(0, 1 << 40, 60).astype(np.uint64))
    kmers = np.repeat(uniq, (np.arange(len(uniq)) % 5) + 1)
    nodes = (np.arange(len(kmers), dtype=np.uint32) % 39) + 1
    queries = np.concatenate([uniq, rng.integers(0, 1 << 40, 37)
                              .astype(np.uint64)])
    rng.shuffle(queries)
    return (kmers, nodes, np.arange(len(kmers), dtype=np.uint64)), 389, 40, \
        None, queries


def _dup2():
    """A table whose deepest bucket is a dup2 bucket (one k-mer twice),
    as tests/test_parallel.py:test_packed_sharded_dup2_buckets finds it."""
    for seed in range(200):
        rng = np.random.default_rng(seed)
        reads = rng.integers(0, 4, (1, 16)).astype(np.int32)
        hashes, valid = _window_hashes(reads)
        kmers = np.repeat(np.unique(hashes[valid]), 2)
        nodes = (np.arange(len(kmers), dtype=np.uint32) % 29) + 1
        rows = (kmers, nodes, np.arange(len(kmers), dtype=np.uint64))
        shards = jsh.PackedTableShards.from_index(_indexes(rows, 101)[0], 2)
        if shards.max_scan == 2 and shards.has_dup:
            return rows, 101, 30, np.repeat(reads, 4, axis=0), \
                hashes[valid]
    raise AssertionError("no collision-free seed found")


CASES = {"toy": _toy, "deep": _deep, "dup2": _dup2}


def _assert_packed_equal(port, jax_shards):
    for attr in ("m2_local", "modulo2", "max_scan", "n_table", "has_dup"):
        assert getattr(port, attr) == getattr(jax_shards, attr), attr
    n_table = jax_shards.n_table
    assert port.records.dtype == np.int32 and port.records.shape == (
        n_table, port.m2_local, 8)
    assert np.array_equal(port.records.view(np.uint32).reshape(
        n_table, -1, 128), jax_shards.records)
    assert np.array_equal(port.row_kmers.view(np.uint64),
                          jax_shards.row_kmers)
    assert port.row_nodes.dtype == np.int32
    assert np.array_equal(port.row_nodes, jax_shards.row_nodes)


def _assert_csr_equal(port, jax_shards):
    for attr in ("m_local", "modulo", "max_scan", "n_table"):
        assert getattr(port, attr) == getattr(jax_shards, attr), attr
    assert np.array_equal(port.starts, jax_shards.starts)
    assert np.array_equal(port.sizes, jax_shards.sizes)
    assert np.array_equal(port.row_kmers.view(np.uint64),
                          jax_shards.row_kmers)
    assert np.array_equal(port.row_nodes, jax_shards.row_nodes)


@pytest.mark.parametrize("n_table", [1, 2, 4, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_from_index_equals_jax(case, n_table):
    rows, modulo, *_ = CASES[case]()
    jindex, tindex = _indexes(rows, modulo)
    jp = jsh.PackedTableShards.from_index(jindex, n_table)
    tp = tsh.PackedTableShards.from_index(tindex, n_table)
    _assert_packed_equal(tp, jp)
    _assert_packed_equal(tsh.PackedTableShards.from_jax_state(
        jp.records, jp.row_kmers, jp.row_nodes, jp.m2_local, jp.modulo2,
        jp.max_scan, jp.n_table, jp.has_dup), jp)
    jc = jsh.TableShards.from_index(jindex, n_table)
    tc = tsh.TableShards.from_index(tindex, n_table)
    _assert_csr_equal(tc, jc)
    _assert_csr_equal(tsh.TableShards.from_jax_state(
        jc.starts, jc.sizes, jc.row_kmers, jc.row_nodes, jc.m_local,
        jc.modulo, jc.max_scan, jc.n_table), jc)


@pytest.mark.parametrize("case", sorted(CASES))
def test_k2_twin_in_shard_mode(case):
    """K2's plain twin: (0, modulo2) is today's lookup, bit for bit; over
    the table shards of from_index, the counts sum to the whole table's
    and the membership ORs to it; a query outside a shard answers
    nothing."""
    rows, modulo, n_nodes, _, queries = CASES[case]()
    _, tindex = _indexes(rows, modulo)
    q = torch.from_numpy(np.concatenate(
        [queries, np.arange(1, 60, dtype=np.uint64)]).view(np.int64))
    whole = tindex.device_index.packed()
    n = q.shape[0] - 5  # the last five are padding
    for n_nodes_ in (n_nodes, None):
        want = tlookup.packed_lookup_plain(whole, q, n, n_nodes_)
        same = tlookup.packed_lookup(whole, q, n, n_nodes_, bucket_base=0,
                                     m2_local=whole.modulo2)
        assert torch.equal(same, want)
    for n_table in (2, 4, 8):
        shards = tsh.PackedTableShards.from_index(tindex, n_table)
        counts = torch.zeros(n_nodes, dtype=torch.int64)
        member = torch.zeros(q.shape[0], dtype=torch.bool)
        owners = (q % shards.modulo2) // shards.m2_local
        for t in range(n_table):
            tables = tsh.shard_tables(shards, t, shards.records,
                                      shards.row_kmers, shards.row_nodes,
                                      torch.device("cpu"))
            c = tlookup.packed_lookup(tables, q, n, n_nodes, t *
                                      shards.m2_local, shards.m2_local)
            h = tsh.shard_lookup(shards, t, tables, q[:n])
            assert not h[owners[:n] != t].any()
            alone = tlookup.packed_lookup(tables, q[owners == t],
                                          int((owners[:n] == t).sum()),
                                          n_nodes, t * shards.m2_local,
                                          shards.m2_local)
            assert torch.equal(c, alone)
            counts += c
            member[:n] |= h
        assert torch.equal(counts, tlookup.packed_lookup_plain(
            whole, q, n, n_nodes))
        assert torch.equal(member, tlookup.packed_lookup_plain(whole, q, n))


def _jax_mesh(n_data, n_table):
    return Mesh(np.asarray(jax.devices()[:n_data * n_table]).reshape(
        n_data, n_table), ("data", "table"))


def _jax_step(job, jindex, n_data, n_table, data):
    mesh = _jax_mesh(n_data, n_table)
    from_kmers = job["from_kmers"]
    qspec = P("data") if from_kmers else P("data", None)
    q = jax.device_put(jnp.asarray(data), NamedSharding(mesh, qspec))
    if job["step"] == "csr":
        shards = jsh.TableShards.from_index(jindex, n_table)
        step = jsh.make_count_step(mesh, shards, job["n_nodes"], K,
                                   from_kmers=from_kmers)
        cols = [(shards.starts, P("table", None)),
                (shards.sizes, P("table", None))]
    else:
        shards = jsh.PackedTableShards.from_index(jindex, n_table)
        cols = [(shards.records, P("table", None, None))]
        if job["step"] == "count":
            step = jsh.make_count_step_packed(mesh, shards, job["n_nodes"],
                                              K, from_kmers=from_kmers)
        else:
            step = jsh.make_member_step_packed(mesh, shards, K,
                                               from_kmers=from_kmers)
    cols += [(shards.row_kmers, P("table", None)),
             (shards.row_nodes, P("table", None))]
    args = [jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))
            for a, spec in cols]
    return np.asarray(step(q, *args))


@pytest.fixture(scope="module")
def plan(tmp_path_factory):
    """Checkpoints (port-written, one per case, layout and n_table), the
    global inputs (port form: int64, KMER_PAD) and the expected outputs:
    the JAX steps' at every mesh shape, which must also equal the single
    port index's map_kmers / has_kmers."""
    tmp = tmp_path_factory.mktemp("sharded")
    jobs, inputs, expected = [], {}, {}
    for case, make in CASES.items():
        rows, modulo, n_nodes, reads, queries = make()
        jindex, tindex = _indexes(rows, modulo)
        for n_table in (1, 2, 4):
            for layout, cls in (("packed", tsh.PackedTableShards),
                                ("csr", tsh.TableShards)):
                tckpt.save_shards(cls.from_index(tindex, n_table),
                                  str(tmp / f"{case}-{layout}-{n_table}"))
        q = np.full(-(-len(queries) // 4) * 4, JAX_PAD, np.uint64)
        q[:len(queries)] = queries
        inputs[f"{case}/kmers"] = np.where(q == JAX_PAD, tsh.KMER_PAD,
                                           q.view(np.int64))
        modes = [("kmers", True)]
        if reads is not None:
            inputs[f"{case}/reads"] = reads
            modes.append(("reads", False))
        for mode, from_kmers in modes:
            if from_kmers:
                valid = np.arange(len(q)) < len(queries)
                asked = queries
            else:
                hashes, valid = _window_hashes(reads)
                asked = hashes[valid]
            single_counts = tindex.map_kmers(asked, n_nodes)
            single_member = np.zeros(len(valid), bool)
            single_member[valid] = tindex.has_kmers(asked)
            for step in ("csr", "count", "member"):
                name = f"{case}-{step}-{mode}"
                layout = "csr" if step == "csr" else "packed"
                job = dict(name=name, step=step, from_kmers=from_kmers, k=K,
                           n_nodes=n_nodes, input=f"{case}/{mode}",
                           prefix=str(tmp / f"{case}-{layout}")
                           + "-{n_table}")
                jobs.append(job)
                data = q if from_kmers else reads
                for shape in SHAPES[2] + SHAPES[4]:
                    want = _jax_step(job, jindex, *shape, data)
                    single = (single_counts if step != "member"
                              else single_member.reshape(want.shape))
                    assert np.array_equal(want, single), name
                    expected[f"{name}@{shape[0]}x{shape[1]}"] = want
    np.savez(tmp / "inputs.npz", **inputs)
    return tmp, jobs, expected


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("world", sorted(SHAPES))
def test_steps_equal_jax_on_gloo_ranks(plan, world):
    tmp, jobs, expected = plan
    out = tmp / f"world{world}"
    out.mkdir()
    with open(out / "plan.json", "w") as f:
        json.dump({"shapes": SHAPES[world], "jobs": jobs}, f)
    init = f"tcp://127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(out / "plan.json"),
         str(tmp / "inputs.npz"), str(out), init, str(world), str(rank)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    got = [dict(np.load(out / f"rank-{r}.npz")) for r in range(world)]
    for n_data, n_table in SHAPES[world]:
        for job in jobs:
            key = f"{job['name']}@{n_data}x{n_table}"
            want = expected[key]
            if job["step"] != "member":
                for r in range(world):
                    assert np.array_equal(got[r][key], want), (key, r)
                continue
            # each data index's slice; every table rank agrees on it
            parts = []
            for d in range(n_data):
                ranks = range(d * n_table, (d + 1) * n_table)
                for r in ranks:
                    assert np.array_equal(got[r][key], got[ranks[0]][key])
                parts.append(got[ranks[0]][key])
            assert np.array_equal(np.concatenate(parts), want), key
