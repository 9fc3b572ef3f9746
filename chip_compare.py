#!/usr/bin/env python3
"""Kernels K6 (gather_loop) and K7 (rmw_loop) of this checkout timed on one
GPU against those of an earlier commit, in one process and in turns.

    git archive 8d196f1 graph_kmer_index_tpu_torch/csrc | tar -x -C DIR
    python3 chip_compare.py --parent-csrc DIR/graph_kmer_index_tpu_torch/csrc

(DIR: a git-ignored directory such as ``.parent_checkout``.) The earlier
commit is one whose ``probes.cu`` has the first interface of the probes
(8d196f1 and before): ``gki_rmw_loop`` adds into a table that the caller
has zeroed. It is called here as that commit's wrappers called it (the
checks, ``torch.empty`` or ``torch.zeros``, a device context, the stream,
the ctypes call). ``--design-csrc DIR`` (any number) adds a ``probes.cu``
with this checkout's interface: to try a design, copy ``csrc``, edit the
copy and name it here; a design that loses is deleted, not kept behind a
macro.

Sizes are bench_primitives.py's: 2^22 int32 indices in blocks of 8192
into a (4096, 128) int32 table. Every side is first held against the
kernel's plain twin, bit for bit, on every timed buffer. Then each is
timed by the device's clock (chip_smoke.device_time: torch.profiler's
device time of everything a call runs on the card, so K7's time covers
the zeroing of its table, whoever does it): the whole list forwards, then
backwards, the two means averaged, so that a drift of the card's clocks
favours neither side; the turns are made twice. Three index sets:

- cold: the launches rotate over ``chip_smoke.COLD_BUFFERS`` seeded
  buffers (128 MiB, several times the L2), so each reads its indices from
  device memory; the byte bound is compared with this time;
- warm: one buffer over and over, which the L2 keeps;
- skewed: the cold buffers with half of the indices one value.

Beside them the host's cost of one wrapper call (host clock, no
synchronise inside) and what CUDA events around the Python calls read,
the method of the earlier records. Prints one line per timing, each with
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke  # noqa: E402
from graph_kmer_index_tpu_torch.ops import _kernels, primitives  # noqa: E402

NEW = "this checkout's kernel"
PARENT = "the earlier commit's kernel"


def build_probes(csrc_dir: Path, workdir: str, name: str,
                 first_interface: bool) -> ctypes.CDLL:
    """``csrc_dir``'s probes.cu as a library of its own, with the argument
    types of K6 and K7: those of the first interface (the caller zeroes
    K7's table) or this checkout's."""
    path = Path(workdir) / f"libgki_{name}.so"
    subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared", "-o",
                    str(path), str(csrc_dir / "probes.cu")], check=True)
    lib = ctypes.CDLL(str(path))
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    if first_interface:
        lib.gki_gather_loop.argtypes = [ptr, ptr, i64, i32, i64, i32, ptr,
                                        ptr]
        lib.gki_rmw_loop.argtypes = [ptr, i64, i32, i64, ptr, ptr]
    else:
        lib.gki_gather_loop.argtypes = [ptr, ptr, i64, i32, i64, i32, ptr,
                                        ptr, ptr]
        lib.gki_rmw_loop.argtypes = [ptr, i64, i32, i64, ptr, ptr, i32, ptr]
    return lib


def first_interface_calls(lib, table, block_q) -> dict:
    """{probe: call(idx)} through a library with the first interface, as
    the wrappers of that time made the calls."""
    n_c, cols = table.shape

    def gather(idx):
        _kernels.check_cuda_tensor(idx, "idx", torch.int32, 1)
        primitives._check_gather_args(idx, table, block_q)
        out = torch.empty(idx.shape[0] // block_q, dtype=torch.int32,
                          device=idx.device)
        with torch.cuda.device(idx.device):
            err = lib.gki_gather_loop(
                idx.data_ptr(), table.data_ptr(), idx.shape[0], n_c, cols,
                block_q, out.data_ptr(), _kernels.stream_handle(idx.device))
        _kernels.check_launch("the earlier gather_loop", err)
        return out

    def rmw(idx):
        _kernels.check_cuda_tensor(idx, "idx", torch.int32, 1)
        primitives._check_rmw_args(idx, n_c, cols)
        counts = torch.zeros((n_c, cols), dtype=torch.int32,
                             device=idx.device)
        with torch.cuda.device(idx.device):
            err = lib.gki_rmw_loop(idx.data_ptr(), idx.shape[0], n_c, cols,
                                   counts.data_ptr(),
                                   _kernels.stream_handle(idx.device))
        _kernels.check_launch("the earlier rmw_loop", err)
        return counts

    return {"gather_loop": gather, "rmw_loop": rmw}


def design_calls(lib, table, block_q) -> dict:
    """{probe: call(idx)} through a library with this checkout's
    interface."""
    n_c, cols = table.shape
    return {"gather_loop": lambda idx: primitives.launch_gather_loop(
                lib, idx, table, block_q),
            "rmw_loop": lambda idx: primitives.launch_rmw_loop(
                lib, idx, n_c, cols)}


def in_turns(measure, sides: dict) -> dict:
    """{side: (mean, forwards, backwards)} of ``measure(call)``: the sides
    forwards, then backwards."""
    forward = {name: measure(call) for name, call in sides.items()}
    backward = {name: measure(call) for name, call in reversed(sides.items())}
    return {name: ((forward[name] + backward[name]) / 2, forward[name],
                   backward[name]) for name in sides}


def report(what, times, card, bound_ms=None):
    for name, (ms, fwd, bwd) in times.items():
        share = (f", bound {bound_ms:.6f} ms = {bound_ms / ms:.4f} of it"
                 if bound_ms else "")
        print(f"timing {what}: {name}: {ms:.6f} ms (forwards {fwd:.6f}, "
              f"backwards {bwd:.6f}){share} [{card}]", flush=True)


def compare_probe(dev, card, probe, sides, plain, sets, bound_ms, reps):
    """One probe: ``sides`` {name: call(idx)} against ``plain(idx)`` on
    every buffer of ``sets`` {name: buffers}, then the timings."""
    for name, call in sides.items():
        for kind, buffers in sets.items():
            for i, idx in enumerate(buffers):
                chip_smoke.assert_equal(call(idx), plain(idx),
                                        f"{probe}, {name}, {kind} buffer {i}")
    n_buffers = sum(len(buffers) for buffers in sets.values())
    print(f"{probe}: every side == the plain twin (exact) on {n_buffers} "
          f"buffers of {sets['cold'][0].shape[0]} indices", flush=True)
    cold, skew = sets["cold"], sets["skewed"]
    rounds = max(1, reps // len(cold))

    def device_ms(buffers, n_rounds):
        return lambda call: chip_smoke.device_time(
            dev, [lambda idx=idx: call(idx) for idx in buffers], n_rounds)[0]

    measures = {
        f"device clock, cold ({len(cold)} buffers in turn)":
            (device_ms(cold, rounds), bound_ms),
        "device clock, warm (one buffer)":
            (device_ms(cold[:1], rounds * len(cold)), None),
        f"device clock, skewed and cold ({len(skew)} buffers in turn, half "
        "of the indices one value)": (device_ms(skew, rounds), None),
        "host cost of one call": (lambda call: chip_smoke.host_call_time(
            dev, lambda: call(cold[0]), reps), None),
        f"CUDA events around {reps} Python calls, warm":
            (lambda call: chip_smoke.time_one(dev, lambda: call(cold[0]),
                                              reps), None)}
    for turn in range(2):
        for what, (measure, share_of) in measures.items():
            report(f"{probe}, {what}, turn {turn + 1}",
                   in_turns(measure, sides), card, share_of)
    for name, call in sides.items():
        _, parts = chip_smoke.device_time(
            dev, [lambda idx=idx: call(idx) for idx in cold], rounds)
        print(f"{probe}, {name}: device time by kernel, cold, ms a call: "
              f"{parts} [{card}]", flush=True)


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parent-csrc", type=Path, metavar="DIR", required=True,
                   help="the csrc directory of the earlier commit (first "
                        "interface of the probes: 8d196f1 and before)")
    p.add_argument("--design-csrc", type=Path, metavar="DIR", action="append",
                   default=[], help="a csrc directory whose probes.cu has "
                   "this checkout's interface; may be given more than once")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reps", type=int, default=200,
                   help="launches per timing")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_compare: no CUDA device")
    dev = torch.device("cuda:0")
    card = chip_smoke.card_line()
    print(card, flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    p = chip_smoke.probe_inputs(dev, gen, primitives.PROBE_QUERIES,
                                primitives.PROBE_BLOCK, 128, 16)
    table, block_q, cold = p["table"], p["block_q"], p["cold"]
    sets = {"cold": cold,
            "skewed": [chip_smoke.skewed(idx, table.shape[0] // 3)
                       for idx in cold]}
    bounds = chip_smoke.probe_bounds(cold[0].shape[0], table, block_q)
    calls = chip_smoke.probe_calls(table, block_q)
    with tempfile.TemporaryDirectory() as workdir:
        sides = {NEW: {probe: kernel for probe, (kernel, _) in calls.items()},
                 PARENT: first_interface_calls(
                     build_probes(args.parent_csrc, workdir, "parent", True),
                     table, block_q)}
        for i, csrc in enumerate(args.design_csrc):
            sides[f"the design in {csrc}"] = design_calls(
                build_probes(csrc, workdir, f"design{i}", False), table,
                block_q)
        for probe in ("gather_loop", "rmw_loop"):
            compare_probe(dev, card, probe,
                          {name: side[probe] for name, side in sides.items()},
                          calls[probe][1], sets, bounds[probe]["bound_ms"],
                          args.reps)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
