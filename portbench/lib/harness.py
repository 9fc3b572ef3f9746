"""One run of one cell: find the cell's files by name, make the inputs,
warm up, measure for the window, judge the outputs against the plain
reference, and give the result's line.

A cell is ``<traffic>.<config>`` in ``BENCHMARK.json``. Its files:

- ``configs/<config>.json``: the deployment's sizes; its ``index`` key
  names the module under ``indexes/`` that builds the index through the
  port and lists the reference's inputs;
- ``traffic/<traffic>.json``: the mix's parameters; its ``driver`` key
  names the module under ``drivers/`` that runs one request;
- ``metrics/<metric>.py``: one per per-layer metric, and
  ``end_to_end/<metric>.py`` one per end-to-end metric, whose
  ``read(run)`` returns the number, or None where the run has nothing to
  read.

A new configuration, mix or metric is new files and new entries in
``BENCHMARK.json``; no existing file changes.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import random
import sys
import tempfile
import time
from pathlib import Path

import torch

from . import trace as tracing

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
# top-level module names that no run may load
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "graph_kmer_index_tpu")
# requests whose outputs a run keeps for the check, drawn from the seed,
# beside the last one
COUNT_SAMPLE = 3


def manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(man: dict, name: str) -> dict:
    for cell in man["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")


def load_json(kind: str, name: str) -> dict:
    with open(BENCH_DIR / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """The module ``<kind>/<name>.py`` under the benchmark's folder; a
    name may hold dots, so it is loaded by path."""
    path = BENCH_DIR / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_')}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN_MODULES, compared whole: the port's own name begins with
    the JAX package's, and is no match."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names}
                  & set(FORBIDDEN_MODULES))


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Run:
    """What one run knows: its cell, files, seed, device and window, the
    spans, and what the cell's driver module and the yardstick left for
    the metric readers."""

    def __init__(self, cell: dict, config: dict, traffic: dict, seed: int,
                 seconds: float, trace: bool, device):
        self.cell = cell
        self.config = config
        self.traffic = traffic
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = torch.device(device)
        self.spans = tracing.Spans(annotate=self.trace)
        # the port's own stage timers (hash_fasta_file's stage_seconds,
        # the pooled find's stats), one dict a request
        self.program_stages = []
        self.workdir = Path(tempfile.mkdtemp(prefix="portbench-"))
        self.trace_summary = None
        self.yard = {}
        self.window = {}
        self.requests = 0

    def close(self) -> None:
        for path in sorted(self.workdir.rglob("*"), reverse=True):
            if path.is_dir():
                path.rmdir()
            else:
                path.unlink()
        self.workdir.rmdir()


class Sample:
    """A reservoir of ``size`` request numbers drawn from the seed: the
    outputs a run keeps to judge, whatever the number of requests that
    the window completes."""

    def __init__(self, seed: int, size: int):
        self.rng = random.Random(seed)
        self.size = size
        self.kept = {}

    def offer(self, i: int, output) -> None:
        if len(self.kept) < self.size:
            self.kept[i] = output
            return
        j = self.rng.randrange(i + 1)
        if j < self.size:
            del self.kept[sorted(self.kept)[j]]
            self.kept[i] = output


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             t_process: float, config=None, traffic=None, per_layer=None,
             end_to_end=None) -> tuple[dict, list]:
    """One run; returns (the result's line as a dict, the compared
    numbers as (name, value, limit) triples)."""
    config = config or load_json("configs", cell["config"])
    traffic = traffic or load_json("traffic", cell["traffic"])
    run = Run(cell, config, traffic, seed, seconds, trace, device)
    dev = run.device
    driver = load_module("drivers", traffic["driver"])
    try:
        state = driver.setup(run)
        sync(dev)
        setup_s = time.perf_counter() - t_process
        cuda = dev.type == "cuda"
        setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        prof = tracing.start_profiler() if trace and cuda else None
        latencies, work, failed = [], 0, 0
        t0 = time.perf_counter()
        deadline = t0 + run.seconds
        with torch.profiler.record_function(tracing.WINDOW_SPAN) \
                if prof else contextlib.nullcontext():
            i = 0
            while time.perf_counter() < deadline:
                t_req = time.perf_counter()
                work += driver.step(run, state, i)
                latencies.append(time.perf_counter() - t_req)
                i += 1
            sync(dev)
            t_end = time.perf_counter()
        run.requests = i
        window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        if prof is not None:
            run.trace_summary = tracing.read_trace(prof)
        driver.finish(run, state)
        checks = driver.check(run, state)
        if trace:
            driver.yardstick(run, state)
        run.window = {"setup_s": setup_s, "work": work,
                      "seconds": t_end - t0, "latencies": latencies,
                      "peak_bytes": window_peak}
        metrics = {}
        kind = "metrics" if trace else "end_to_end"
        for m in (per_layer if trace else end_to_end) or []:
            if not _applies(m, cell):
                continue
            value = load_module(kind, m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        correct = all(v <= limit for _, v, limit in checks)
        result = {
            "correct": correct,
            "attempted": run.requests,
            "failed": failed,
            "metrics": metrics,
            "device": device_record(dev, max(setup_peak, window_peak), run),
        }
        if trace and run.trace_summary is not None:
            t = run.trace_summary
            result["breakdown"] = {"device_ops": tracing.top(t["device_s"]),
                                   "idle_gaps": tracing.top(t["idle_s"])}
        result["checks"] = {name: {"value": v, "limit": limit}
                            for name, v, limit in checks}
        return result, checks
    finally:
        run.close()


def _applies(metric: dict, cell: dict) -> bool:
    names = metric.get("workloads")
    return names is None or cell["name"] in names


def device_record(dev, peak: int, run: Run) -> dict:
    if dev.type == "cuda":
        record = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                  "count": int(run.cell.get("chips", 1)),
                  "memory_peak_bytes": int(peak),
                  "power_limit": power_limit()}
    else:
        record = {"platform": "cpu", "kind": "cpu", "count": 1,
                  "memory_peak_bytes": 0}
    if run.trace_summary is not None:
        record["busy_s"] = run.trace_summary["busy_s"]
        record["window_s"] = run.trace_summary["window_s"]
    return record


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them (a card
    set below 700 W runs slower under load), or "not read"."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.stdout.strip().splitlines()[0]


def main(argv=None, t_process=None) -> int:
    if t_process is None:
        t_process = time.perf_counter()
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    man = manifest()
    cell = find_cell(man, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the port on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"{cell['name']} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result, checks = run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda:0", t_process,
                              per_layer=man["per_layer"],
                              end_to_end=man["end_to_end"])
    bad = forbidden_modules()
    if bad:
        print(f"modules that no run may load were loaded: {bad}",
              file=sys.stderr)
        return 3
    for name, value, limit in checks:
        print(f"check {name}: {value} (limit {limit})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
