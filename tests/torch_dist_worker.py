"""One gloo rank of the port's multi-rank tests (tests/test_torch_sharded.py,
tests/test_torch_sharded_build.py). Imports torch and the port only.

    torch_dist_worker.py PLAN_JSON INPUTS_NPZ OUT_DIR INIT_METHOD WORLD RANK

The plan lists mesh shapes (their product the world size) and jobs. A
serving job ("step") names a shard checkpoint (read with
checkpoint.load_shards onto this rank's mesh), a step (CSR count, packed
count, packed member), its mode (reads or pre-hashed k-mers) and the key
of its global input: every rank takes its data slice of the input and runs
the step. A job with a "kind" runs one function of parallel/sharded.py
(or the multi-rank save) on this rank's share of a case's rows
(:data:`KINDS`). Every rank writes its outputs to OUT_DIR/rank-R.npz under
"JOB@n_dataxn_table" (a build's columns under ".../COLUMN").
"""
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from graph_kmer_index_tpu_torch import KmerIndex  # noqa: E402
from graph_kmer_index_tpu_torch.parallel import checkpoint, mesh  # noqa: E402
from graph_kmer_index_tpu_torch.parallel import sharded  # noqa: E402


def _serve(job, m, n_data, inputs):
    d, _ = mesh.coordinates(m)
    prefix = job["prefix"].format(n_table=m.size(1))
    shards = checkpoint.load_shards(prefix, mesh=m)
    data = inputs[job["input"]]
    per = len(data) // n_data
    mine = torch.from_numpy(data[d * per:(d + 1) * per])
    kw = {"from_kmers": job["from_kmers"]}
    if job["step"] == "csr":
        step = sharded.make_count_step(m, shards, job["n_nodes"], job["k"],
                                       **kw)
        cols = (shards.starts, shards.sizes)
    elif job["step"] == "count":
        step = sharded.make_count_step_packed(m, shards, job["n_nodes"],
                                              job["k"], **kw)
        cols = (shards.records,)
    else:
        step = sharded.make_member_step_packed(m, shards, job["k"], **kw)
        cols = (shards.records,)
    got = step(mine, *cols, shards.row_kmers, shards.row_nodes)
    return {"": got.numpy()}


def _share(a, job, m):
    """This rank's contiguous share of a case's rows: the table group's
    (``job["cuts"]``: fractions of the rows at which the world's ranks'
    shares end, the table group being the world), or by default slice t of
    n_table."""
    if "cuts" in job:
        bounds = [0] + [round(f * len(a)) for f in job["cuts"]]
        r = dist.get_rank()
        return a[bounds[r]:bounds[r + 1]]
    _, t = mesh.coordinates(m)
    return np.array_split(a, m.size(1))[t]


def _rows(job, inputs, m):
    case = job["case"]
    return [_share(inputs[f"{case}/{c}"], job, m) for c in ("k", "n", "r")]


def _shard_columns(shard, count) -> dict:
    out = {name: getattr(shard, name)[0].numpy() for name in (
        "records", "starts", "sizes", "row_kmers", "row_nodes")
        if hasattr(shard, name)}
    meta = [getattr(shard, a) for a in ("m2_local", "modulo2", "m_local",
                                        "modulo", "max_scan", "n_table",
                                        "has_dup") if hasattr(shard, a)]
    return {**out, "count": np.asarray(count), "meta": np.asarray(meta)}


def _build(job, m, inputs):
    kmers, nodes, _ = _rows(job, inputs, m)
    table = None if "cuts" in job else m
    if job["layout"] == "packed":
        shard, count = sharded.build_packed_shards_sharded(kmers, nodes,
                                                           mesh=table)
    else:
        shard, count = sharded.build_table_shards_sharded(
            kmers, nodes, job["modulo"], mesh=table)
    if "save" in job:
        checkpoint.save_shards(shard, job["save"].format(
            shape=f"{m.size(0)}x{m.size(1)}"), mesh=m)
    return _shard_columns(shard, count)


def _frequencies(job, m, inputs):
    kmers, _, refs = _rows(job, inputs, m)
    return {"": sharded.frequencies_sharded(kmers, refs, mesh=m).numpy()}


def _world_share(a):
    return np.array_split(a, dist.get_world_size())[dist.get_rank()]


def _merge(job, m, inputs):
    cols = [_world_share(inputs[f"merge/{c}"]) for c in "hnra"]
    out = sharded.merge_flat_kmers_all_gather(None, cols)
    return {c: t.numpy() for c, t in zip("hnra", out)}


def _cms(job, m, inputs):
    return {"": sharded.count_min_sketch_sharded(
        _world_share(inputs["cms/k"]), job["modulos"]).numpy()}


def _run(job, m, inputs):
    return {"": sharded.run_sharded_function(
        lambda a: a * 2 + 1, job["n_shards"], [inputs["run/x"]]).numpy()}


def _query(job, m, inputs):
    case = job["case"]
    k, n, r = (inputs[f"{case}/{c}"] for c in ("k", "n", "r"))
    index = KmerIndex.from_rows(k, n, r, np.zeros(len(k), np.float32),
                                job["modulo"], device="cpu")
    if job["csr"]:
        index.device_index.PACKED_BYTE_BUDGET = 0
    q = inputs[f"{case}/queries"]
    return {"has": sharded.has_kmers_sharded(index, q),
            "parallel": index.has_kmers_parallel(q, dist.get_world_size()),
            "map": sharded.map_kmers_sharded(index, q, job["n_nodes"])}


KINDS = {"build": _build, "frequencies": _frequencies, "merge": _merge,
         "cms": _cms, "run": _run, "query": _query}


def main(plan_path, inputs_path, out_dir, init_method, world, rank):
    torch.set_num_threads(1)
    with open(plan_path) as f:
        plan = json.load(f)
    inputs = dict(np.load(inputs_path))
    mesh.start_process_group("cpu", init_method, world, rank)
    out = {}
    try:
        for n_data, n_table in plan["shapes"]:
            m = mesh.build_mesh(n_data, n_table)
            for job in plan["jobs"]:
                got = (KINDS[job["kind"]](job, m, inputs) if "kind" in job
                       else _serve(job, m, n_data, inputs))
                key = f"{job['name']}@{n_data}x{n_table}"
                for name, a in got.items():
                    out[f"{key}/{name}" if name else key] = a
    finally:
        mesh.stop_process_group()
    np.savez(Path(out_dir) / f"rank-{rank}.npz", **out)


if __name__ == "__main__":
    main(*sys.argv[1:5], int(sys.argv[5]), int(sys.argv[6]))
