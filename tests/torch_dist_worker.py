"""One gloo rank of the port's sharded-serving tests
(tests/test_torch_sharded.py). Imports torch and the port only.

    torch_dist_worker.py PLAN_JSON INPUTS_NPZ OUT_DIR INIT_METHOD WORLD RANK

The plan lists mesh shapes (their product the world size) and jobs: a
shard checkpoint (read with checkpoint.load_shards onto this rank's
mesh), a step (CSR count, packed count, packed member), its mode (reads
or pre-hashed k-mers) and the key of its global input. Every rank takes
its data slice of the input, runs the step, and writes its output to
OUT_DIR/rank-R.npz under "JOB@n_dataxn_table".
"""
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from graph_kmer_index_tpu_torch.parallel import checkpoint, mesh  # noqa: E402
from graph_kmer_index_tpu_torch.parallel import sharded  # noqa: E402


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
            d, _ = mesh.coordinates(m)
            for job in plan["jobs"]:
                prefix = job["prefix"].format(n_table=n_table)
                shards = checkpoint.load_shards(prefix, mesh=m)
                data = inputs[job["input"]]
                per = len(data) // n_data
                mine = torch.from_numpy(data[d * per:(d + 1) * per])
                kw = {"from_kmers": job["from_kmers"]}
                if job["step"] == "csr":
                    step = sharded.make_count_step(m, shards, job["n_nodes"],
                                                   job["k"], **kw)
                    cols = (shards.starts, shards.sizes)
                elif job["step"] == "count":
                    step = sharded.make_count_step_packed(
                        m, shards, job["n_nodes"], job["k"], **kw)
                    cols = (shards.records,)
                else:
                    step = sharded.make_member_step_packed(m, shards,
                                                           job["k"], **kw)
                    cols = (shards.records,)
                got = step(mine, *cols, shards.row_kmers, shards.row_nodes)
                out[f"{job['name']}@{n_data}x{n_table}"] = got.numpy()
    finally:
        mesh.stop_process_group()
    np.savez(Path(out_dir) / f"rank-{rank}.npz", **out)


if __name__ == "__main__":
    main(*sys.argv[1:5], int(sys.argv[5]), int(sys.argv[6]))
