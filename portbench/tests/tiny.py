"""A tiny configuration and mixes of the cells, for the CPU tests: the
shapes of the real ones (the variant density, indel shares, repeats and
150-base reads) on a 60,000-base reference.

``CELLS`` holds the cells of ``BENCHMARK.json`` and the FASTA cell, which
is kept out of it while its rate spreads more than a bound can hold
(PERF.md) and is tested here all the same."""
from portbench.lib import harness

# the configuration's density: 88.3 M variants on 3.1 Gb
REF_BASES = 60_000
N_VARIANTS = 1_709
FASTA_CELL = "map_fasta.wg_signature"
CELLS = sorted({w["name"] for w in harness.manifest()["workloads"]}
               | {FASTA_CELL})


def cell(name: str) -> dict:
    """The cell of ``BENCHMARK.json`` of that name, or one made from the
    name (``<traffic>.<config>``, one card)."""
    for w in harness.manifest()["workloads"]:
        if w["name"] == name:
            return w
    traffic, config = name.split(".", 1)
    return {"name": name, "config": config, "traffic": traffic, "chips": 1}


def config(name: str) -> dict:
    return dict(harness.load_json("configs", name), modulo=1009,
                ref_bases=REF_BASES, n_variants=N_VARIANTS)


def traffic(name: str) -> dict:
    return dict(harness.load_json("traffic", name), reads_per_request=400,
                pool_requests=2)


def run(cell_name: str, seed: int = 2 ** 31 + 7, seconds: float = 0.3,
        trace: bool = False, device="cpu"):
    man = harness.manifest()
    w = cell(cell_name)
    return harness.run_cell(w, seed, seconds, trace, device, 0.0,
                            config=config(w["config"]),
                            traffic=traffic(w["traffic"]),
                            per_layer=man["per_layer"],
                            end_to_end=man["end_to_end"])
