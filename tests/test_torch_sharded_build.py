"""Port parity: the sharded builds and the data-parallel functions of
graph_kmer_index_tpu_torch/parallel/sharded.py, and the multi-rank
save_shards, against the JAX package's parallel/sharded.py on its
8-device CPU mesh.

The port's functions run on gloo ranks spawned from here
(tests/torch_dist_worker.py), one spawn per world size, every mesh shape
of that size in it; each rank passes its own share of the rows. The JAX
functions run here on the same numpy inputs. Exact: a rank's shard equals
the JAX package's shard of its table index (records whole, rows up to the
row count), frequencies, sketches, merges and query answers equal the JAX
outputs, and the checkpoints the ranks write read back through both
packages' load_shards."""
import json
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from graph_kmer_index_tpu.parallel import checkpoint as jckpt
from graph_kmer_index_tpu.parallel import sharded as jsh
from graph_kmer_index_tpu_torch.parallel import checkpoint as tckpt
from test_torch_sharded import CASES, SHAPES, WORKER, _free_port, _indexes

torch.set_num_threads(2)

MODULOS = [97, 101, 103]
# fractions of the rows at which rank r's share ends: uneven slices
CUTS = {2: [0.3, 1.0], 4: [0.1, 0.15, 0.7, 1.0]}


def _rows(case):
    """The case's rows in a seeded emission order (not bucket-sorted):
    (kmers uint64, nodes uint32, ref offsets uint64), the modulo, n_nodes
    and the queries."""
    (kmers, nodes, refs), modulo, n_nodes, _, queries = CASES[case]()
    order = np.random.default_rng(3).permutation(len(kmers))
    return (kmers[order], nodes[order], refs[order]), modulo, n_nodes, \
        np.asarray(queries, np.uint64)


@pytest.fixture(scope="module")
def plan(tmp_path_factory):
    """The jobs, the global inputs (k-mers and offsets as int64 bits) and
    the JAX package's outputs for every (job, n_table)."""
    tmp = tmp_path_factory.mktemp("sharded_build")
    jobs, inputs, jax_out = [], {}, {}
    for case in CASES:
        (k, n, r), modulo, n_nodes, queries = _rows(case)
        inputs.update({f"{case}/k": k.view(np.int64), f"{case}/n": n,
                       f"{case}/r": r.view(np.int64),
                       f"{case}/queries": queries.view(np.int64)})
        for n_table in (1, 2, 4):
            jp, jpc = jsh.build_packed_shards_sharded(k, n, n_table)
            jc, jcc = jsh.build_table_shards_sharded(k, n, modulo, n_table)
            jax_out[(case, "packed", n_table)] = (jp, jpc)
            jax_out[(case, "csr", n_table)] = (jc, jcc)
        for layout in ("packed", "csr"):
            jobs.append(dict(kind="build", case=case, layout=layout,
                             modulo=modulo, name=f"{case}-{layout}",
                             save=str(tmp / f"{case}-{layout}-{{shape}}")))
        jobs.append(dict(kind="frequencies", case=case,
                         name=f"{case}-frequencies"))
        jax_out[(case, "frequencies")] = jsh.frequencies_sharded(k, r, 8)
        jindex, _ = _indexes((k, n, r), modulo)
        jax_out[(case, "has")] = jsh.has_kmers_sharded(jindex, queries)
        jax_out[(case, "map")] = np.asarray(
            jsh.map_kmers_sharded(jindex, queries, n_nodes))
        for csr in (False, True):
            route = "csr" if csr else "packed"
            jobs.append(dict(kind="query", case=case, modulo=modulo,
                             n_nodes=n_nodes, csr=csr,
                             name=f"{case}-query-{route}"))
    rng = np.random.default_rng(7)
    cols = {"h": rng.integers(0, 1 << 62, 48).astype(np.uint64),
            "n": rng.integers(1, 99, 48).astype(np.uint32),
            "r": rng.integers(0, 999, 48).astype(np.uint64),
            "a": rng.random(48).astype(np.float32)}
    inputs.update({f"merge/{c}": (a.view(np.int64) if a.dtype == np.uint64
                                  else a) for c, a in cols.items()})
    jobs.append(dict(kind="merge", name="merge"))
    cms = rng.integers(0, 1 << 40, 1001).astype(np.uint64)
    inputs["cms/k"] = cms.view(np.int64)
    jobs.append(dict(kind="cms", name="cms", modulos=MODULOS))
    inputs["run/x"] = np.arange(999, dtype=np.float64)
    jobs.append(dict(kind="run", name="run", n_shards=3))
    for world, cuts in CUTS.items():
        for case in CASES:
            jobs.append(dict(kind="build", case=case, layout="packed",
                             name=f"{case}-uneven{world}", cuts=cuts,
                             world=world))
    np.savez(tmp / "inputs.npz", **inputs)
    return tmp, jobs, jax_out, cols, cms


def _spawn(tmp, jobs, world):
    out = tmp / f"world{world}"
    out.mkdir()
    mine = [j for j in jobs if j.get("world", world) == world]
    with open(out / "plan.json", "w") as f:
        json.dump({"shapes": SHAPES[world], "jobs": mine}, f)
    init = f"tcp://127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(out / "plan.json"),
         str(tmp / "inputs.npz"), str(out), init, str(world), str(rank)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [dict(np.load(out / f"rank-{r}.npz")) for r in range(world)]


def _assert_shard(got, key, jax_shards, counts, t, layout):
    n = int(counts[t])
    assert int(got[f"{key}/count"]) == n, key
    if layout == "packed":
        assert np.array_equal(got[f"{key}/records"].view(np.uint32)
                              .reshape(-1, 128), jax_shards.records[t]), key
        meta = (jax_shards.m2_local, jax_shards.modulo2, jax_shards.max_scan,
                jax_shards.n_table, int(jax_shards.has_dup))
    else:
        sizes = jax_shards.sizes[t]
        assert np.array_equal(got[f"{key}/sizes"], sizes), key
        assert np.array_equal(got[f"{key}/starts"][sizes > 0],
                              jax_shards.starts[t][sizes > 0]), key
        meta = (jax_shards.m_local, jax_shards.modulo, jax_shards.max_scan,
                jax_shards.n_table)
    assert tuple(got[f"{key}/meta"]) == meta, key
    assert np.array_equal(got[f"{key}/row_kmers"][:n].view(np.uint64),
                          jax_shards.row_kmers[t, :n]), key
    assert np.array_equal(got[f"{key}/row_nodes"][:n],
                          jax_shards.row_nodes[t, :n]), key


def _assert_checkpoint(prefix, jax_shards, counts, layout):
    """The ranks' checkpoint read back by both packages' load_shards."""
    jl = jckpt.load_shards(prefix)
    tl = tckpt.load_shards(prefix)
    cols = (("records",) if layout == "packed" else ("starts", "sizes"))
    for t in range(jax_shards.n_table):
        n = int(counts[t])
        for name in cols:
            want = getattr(jax_shards, name)[t]
            if name == "starts":
                keep = jax_shards.sizes[t] > 0
                assert np.array_equal(jl.starts[t][keep], want[keep])
                assert np.array_equal(tl.starts[t][keep], want[keep])
                continue
            assert np.array_equal(getattr(jl, name)[t], want), name
        if layout == "packed":
            assert np.array_equal(tl.records[t].view(np.uint32).reshape(
                -1, 128), jax_shards.records[t])
        else:
            assert np.array_equal(tl.sizes[t], jax_shards.sizes[t])
        for loaded in (jl, tl):
            assert np.array_equal(np.asarray(loaded.row_kmers[t][:n])
                                  .view(np.uint64),
                                  jax_shards.row_kmers[t, :n])
            assert np.array_equal(loaded.row_nodes[t][:n],
                                  jax_shards.row_nodes[t, :n])
    assert tckpt.manifest_info(prefix)["max_node"] == int(
        max(jax_shards.row_nodes[t, :int(counts[t])].max(initial=0)
            for t in range(jax_shards.n_table)))


@pytest.mark.parametrize("world", sorted(SHAPES))
def test_sharded_builds_equal_jax_on_gloo_ranks(plan, world):
    tmp, jobs, jax_out, cols, cms = plan
    got = _spawn(tmp, jobs, world)
    for n_data, n_table in SHAPES[world]:
        shape = f"{n_data}x{n_table}"
        for rank in range(world):
            t = rank % n_table
            g = got[rank]
            for case in CASES:
                for layout in ("packed", "csr"):
                    key = f"{case}-{layout}@{shape}"
                    _assert_shard(g, key, *jax_out[(case, layout, n_table)],
                                  t, layout)
                # each rank's frequencies: its table share's rows
                k = np.array_split(np.arange(len(jax_out[(case,
                                                           "frequencies")])),
                                   n_table)[t]
                assert np.array_equal(g[f"{case}-frequencies@{shape}"],
                                      jax_out[(case, "frequencies")][k])
                for mode in ("packed", "csr"):
                    key = f"{case}-query-{mode}@{shape}"
                    for name in ("has", "parallel"):
                        assert np.array_equal(g[f"{key}/{name}"],
                                              jax_out[(case, "has")]), key
                    assert np.array_equal(g[f"{key}/map"],
                                          jax_out[(case, "map")]), key
                # uneven shares over the world == the single-table build
                # cut into world shards
                jp, jpc = jsh.build_packed_shards_sharded(
                    *_rows(case)[0][:2], world)
                _assert_shard(g, f"{case}-uneven{world}@{shape}", jp, jpc,
                              rank, "packed")
        # the merge, sketch and map of every rank equal the JAX outputs
        jmesh = Mesh(np.asarray(jax.devices()[:world]), ("data",))
        jmerged = jsh.merge_flat_kmers_all_gather(jmesh, [
            jax.device_put(a, NamedSharding(jmesh, P("data")))
            for a in cols.values()])
        jsketch = jsh.count_min_sketch_sharded(cms, MODULOS, n_shards=world)
        jrun = jsh.run_sharded_function(lambda a: a * 2 + 1, 3,
                                        [np.arange(999, dtype=np.float64)])
        for rank in range(world):
            g = got[rank]
            for c, want in zip("hnra", jmerged):
                a = g[f"merge@{shape}/{c}"]
                want = np.asarray(want)
                assert np.array_equal(a.view(np.uint64) if want.dtype ==
                                      np.uint64 else a, want), c
            assert np.array_equal(g[f"cms@{shape}"], jsketch)
            assert np.array_equal(g[f"run@{shape}"], jrun)
        for case in CASES:
            for layout in ("packed", "csr"):
                _assert_checkpoint(str(tmp / f"{case}-{layout}-{shape}"),
                                   *jax_out[(case, layout, n_table)], layout)
