"""The control: the plain reference put in the port's place with one
guarantee of the configuration broken, judged by the same comparison as
the port. The configuration states no precision; what it states is
exactness, so the control is an inexact shortcut that a later change
could be tempted by: node counts from a lookup that answers only from
the packed table's two record slots, never scanning a bucket of more
than two rows (``reference.kmer_table(control=True)``).

The control must read above the limit of 0 on every seed."""
from __future__ import annotations

import torch

from . import checks, genome as gen, harness, reference


def readings(cell: dict, config: dict, traffic: dict, seed: int,
             device) -> dict:
    """The control's numbers for one seed at the given sizes, under the
    name of the run's check: the node counts of every request of the
    pool, as a run draws them."""
    dev = torch.device(device)
    g = gen.make_genome(config, seed, dev)
    rows = reference.signature_rows(gen.signature_windows(g), g.pos)
    hap, poly_a = gen.sample_haplotype(g, traffic, seed)
    lanes = reference.kmer_table(*rows[:2], control=True)
    total = 0
    for item in range(int(traffic["pool_requests"])):
        reads = gen.sample_reads(hap, poly_a, traffic,
                                 int(traffic["reads_per_request"]),
                                 gen.generator(seed, f"reads/{item}", dev),
                                 int(config["poly_a_length"]))
        queries = reference.batch_hashes(reads)
        got = reference.node_counts(*lanes, queries, g.n_nodes)
        want = reference.node_counts(*rows[:2], queries, g.n_nodes)
        total += checks.mismatches(got, want)
    return {"node_counts": total}


def main(argv=None) -> int:
    import argparse
    import json

    p = argparse.ArgumentParser(description="the control's readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    args = p.parse_args(argv)
    man = harness.manifest()
    cell = harness.find_cell(man, args.workload)
    config = harness.load_json("configs", cell["config"])
    traffic = harness.load_json("traffic", cell["traffic"])
    dev = "cuda:0" if torch.cuda.is_available() else "cpu"
    for seed in args.seeds.split(","):
        out = readings(cell, config, traffic, int(seed), dev)
        print(json.dumps({"workload": cell["name"], "seed": int(seed),
                          "control": out}), flush=True)
    return 0
