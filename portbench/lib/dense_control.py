"""The control of the dense cell: the plain reference put in the port's
place with one guarantee of the configuration broken, judged by the same
comparison as the port. The configuration states no precision; what it
states is exactness, so the control is an inexact shortcut that a later
change could be tempted by: each variant treated alone, no window
through two alternative alleles (the reference at ``max_variant_nodes``
1, where the configuration says 5). Its rows are laid out and counted as
the index would be, by plain torch.

The control must read above the limit of 0 on every seed."""
from __future__ import annotations

import torch

from . import checks, dense_reference, genome as gen, harness, reference


def plain_index(kmers, nodes, ref_offsets, modulo: int) -> dict:
    """Rows in the bucket layout at ``modulo`` with their frequencies,
    under the names of the port's columns that ``checks`` judges."""
    bucket = kmers % modulo
    order = torch.sort(bucket, stable=True).indices
    sizes = torch.bincount(bucket, minlength=modulo)
    del bucket
    km, ro = kmers[order], ref_offsets[order]
    return {"kmers": km, "nodes": nodes[order], "ref_offsets": ro,
            "frequencies": reference.frequencies(km, ro),
            "hashes_to_index": torch.where(
                sizes > 0, torch.cumsum(sizes, 0) - sizes, 0),
            "n_kmers": sizes}


def readings(config: dict, traffic: dict, seed: int, device,
             max_variant_nodes: int = 1) -> dict:
    """The control's numbers for one seed at the given sizes, under the
    names of the run's checks: the index's three, and the node counts of
    every request of the pool, as a run draws them."""
    dev = torch.device(device)
    g = gen.make_genome(config, seed, dev)
    k = int(config["k"])
    rows = dense_reference.dense_rows(g, int(config["max_variant_nodes"]), k)
    shortcut = dense_reference.dense_rows(g, max_variant_nodes, k)
    index = plain_index(*shortcut, int(config["modulo"]))
    out = reference.compare_index(index, *rows, int(config["modulo"]))
    del index
    hap, poly_a = gen.sample_haplotype(g, traffic, seed)
    total = 0
    for item in range(int(traffic["pool_requests"])):
        reads = gen.sample_reads(hap, poly_a, traffic,
                                 int(traffic["reads_per_request"]),
                                 gen.generator(seed, f"reads/{item}", dev),
                                 int(config["poly_a_length"]))
        queries = reference.batch_hashes(reads)
        got = reference.node_counts(*shortcut[:2], queries, g.n_nodes)
        want = reference.node_counts(*rows[:2], queries, g.n_nodes)
        total += checks.mismatches(got, want)
    out["node_counts"] = total
    return out


def main(argv=None) -> int:
    import argparse
    import json

    p = argparse.ArgumentParser(description="the dense cell's control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    args = p.parse_args(argv)
    cell = harness.find_cell(harness.manifest(), args.workload)
    config = harness.load_json("configs", cell["config"])
    traffic = harness.load_json("traffic", cell["traffic"])
    dev = "cuda:0" if torch.cuda.is_available() else "cpu"
    for seed in args.seeds.split(","):
        out = readings(config, traffic, int(seed), dev)
        print(json.dumps({"workload": cell["name"], "seed": int(seed),
                          "control": out}), flush=True)
    return 0
