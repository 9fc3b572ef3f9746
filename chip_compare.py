#!/usr/bin/env python3
"""Kernels K4 (stream_copy) and K2 (packed lookup) of this checkout timed
on one GPU against those of an earlier commit, in one process and in
turns.

    git archive <commit> graph_kmer_index_tpu_torch/csrc | tar -x -C DIR
    python3 chip_compare.py --parent-csrc DIR/graph_kmer_index_tpu_torch/csrc

(DIR: a git-ignored directory such as ``.parent_checkout``.) The earlier
commit is one whose K2 is the decode head ``gki_packed_decode``: the head
writes a class byte per query, and plain-torch follow-ups (the deep scan
by depth, the ultra resolution per unique k-mer) finish what it marks.
That whole earlier packed path is rebuilt here from the head and
``lookup.finish_classes``.

Every function is first held against the kernel's plain twin on the timed
inputs (bit-exact), then timed with CUDA events: the whole list forwards,
then backwards, the two means averaged, so that a drift of the card's
clocks favours neither side; the turns are made twice.

K4, on the (2^20, 128) float32 table of the controls (512 MiB): this
checkout's kernel, the earlier one and ``clone()``.

K2, on chip_smoke.py's read-mapping state (150 Mb genome, 1,000,000
reads): counts and membership on the largest read segment, and
``map_read_kmers`` / ``has_read_kmers`` over all segments; beside them, as
a yardstick of the card's random reads, one PyTorch call that gathers 16
bytes of each query's record.

Prints one line per timing, each with the card's name and power limit.
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
from graph_kmer_index_tpu_torch.ops import (  # noqa: E402
    _kernels, lookup, primitives)


def build_parent(csrc_dir: Path, workdir: str) -> ctypes.CDLL:
    """The earlier commit's stream.cu and packed_lookup.cu as a library of
    their own, with the argument types of the two entry points timed."""
    path = Path(workdir) / "libgki_parent.so"
    subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared", "-o",
                    str(path), str(csrc_dir / "stream.cu"),
                    str(csrc_dir / "packed_lookup.cu")], check=True)
    lib = ctypes.CDLL(str(path))
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.gki_stream_copy.argtypes = [ptr, ptr, i64, ptr]
    lib.gki_packed_decode.argtypes = [ptr, ptr, i64, i64, i64, ptr, i64,
                                      ptr, ptr, ptr]
    return lib


def time_in_turns(dev, fns: dict, reps: int) -> dict:
    """{name: (mean ms, forward ms, backward ms)}: the list forwards, then
    backwards."""
    forward = {name: chip_smoke.time_one(dev, fn, reps)
               for name, fn in fns.items()}
    backward = {name: chip_smoke.time_one(dev, fn, reps)
                for name, fn in reversed(fns.items())}
    return {name: ((forward[name] + backward[name]) / 2, forward[name],
                   backward[name]) for name in fns}


def report(what, times, card, per_ms=None):
    for name, (ms, fwd, bwd) in times.items():
        rate = (f", {per_ms[0] / ms / 1e6:.3f} G {per_ms[1]}/s" if per_ms
                else "")
        print(f"timing {what}: {name}: {ms:.6f} ms (forwards {fwd:.6f}, "
              f"backwards {bwd:.6f}){rate} [{card}]", flush=True)


def compare_k4(dev, card, parent, reps=20):
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    table = torch.rand((primitives.STREAM_ROWS, primitives.STREAM_COLS),
                       generator=gen, device=dev)

    def parent_copy():
        out = torch.empty_like(table)
        _kernels.check_launch("the earlier stream_copy",
                              parent.gki_stream_copy(
                                  table.data_ptr(), out.data_ptr(),
                                  table.numel() // 4,
                                  _kernels.stream_handle(dev)))
        return out

    fns = {"clone() (one PyTorch call)": table.clone,
           "this checkout's kernel": lambda: primitives.stream_copy(table),
           "the earlier commit's kernel": parent_copy}
    for name, fn in fns.items():
        chip_smoke.assert_equal(fn(), table, f"K4, {name}")
    nbytes = table.numel() * 4
    print(f"K4: every copy == its source (exact) on {nbytes} bytes",
          flush=True)
    bound_ms = chip_smoke.bound(2 * nbytes)["bound_ms"]
    for _ in range(2):
        report(f"K4 stream_copy, {nbytes} bytes, bound {bound_ms:.6f} ms",
               time_in_turns(dev, fns, reps), card, (2 * nbytes, "bytes"))


def parent_packed_path(parent, t, q, n_nodes=None):
    """The earlier packed path: the decode head, whose class byte sends
    deep and ultra queries to the plain-torch follow-ups."""
    n, dev = q.shape[0], q.device
    cls = torch.empty(n, dtype=torch.uint8, device=dev)
    counts_mode = n_nodes is not None
    out = (torch.zeros(n_nodes, dtype=torch.int64, device=dev) if counts_mode
           else torch.empty(n, dtype=torch.bool, device=dev))
    _kernels.check_launch("packed_decode", parent.gki_packed_decode(
        t.records.data_ptr(), q.data_ptr(), n, n, t.modulo2,
        out.data_ptr() if counts_mode else None, n_nodes or 0,
        None if counts_mode else out.data_ptr(), cls.data_ptr(),
        _kernels.stream_handle(dev)))
    return lookup.finish_classes(t, q, out, cls, n_nodes)


def compare_k2(dev, card, args, parent, reps=5):
    with tempfile.TemporaryDirectory() as workdir:
        state = chip_smoke.main_path(dev, card, args, workdir)
    t, n_nodes = state["tables"], state["n_nodes"]
    index, read_kmers = state["index"].device_index, state["read_kmers"]
    segments = read_kmers.segments
    seg = max(segments, key=lambda s: s.shape[0])
    n = seg.shape[0]
    scratch_counts = torch.zeros(n_nodes, dtype=torch.int64, device=dev)
    scratch_cls = torch.empty(n, dtype=torch.uint8, device=dev)

    def head_alone():
        # into buffers made once: the kernel's time and no allocation
        _kernels.check_launch("packed_decode", parent.gki_packed_decode(
            t.records.data_ptr(), seg.data_ptr(), n, n, t.modulo2,
            scratch_counts.data_ptr(), n_nodes, None,
            scratch_cls.data_ptr(), _kernels.stream_handle(dev)))

    # a yardstick for the random record reads, by one PyTorch call: the
    # first 16 bytes of each query's record gathered from a flat view of
    # the table (decodes nothing, and writes 16 bytes a query)
    halves = t.records.view(torch.complex128).view(-1)
    first_half = (seg % t.modulo2) * 2
    new, old = "this checkout's kernel", "the earlier decode head"
    old_path = old + " and its plain-torch follow-ups"
    counts = {
        new: lambda: lookup.packed_lookup(t, seg, n, n_nodes),
        old + " alone": head_alone,
        old_path: lambda: parent_packed_path(parent, t, seg, n_nodes),
        "index_select of the first 16 bytes of each query's record (a "
        "yardstick)": lambda: halves.index_select(0, first_half)}
    member = {new: lambda: lookup.packed_lookup(t, seg, n),
              old_path: lambda: parent_packed_path(parent, t, seg)}
    whole_map = {
        new: lambda: index.map_read_kmers(read_kmers, n_nodes),
        old_path: lambda: sum(parent_packed_path(parent, t, s, n_nodes)
                              for s in segments)}
    whole_has = {
        new: lambda: index.has_read_kmers(read_kmers),
        old_path: lambda: torch.cat([parent_packed_path(parent, t, s)
                                     for s in segments])}
    want = (lookup.packed_lookup_plain(t, seg, n, n_nodes),
            lookup.packed_lookup_plain(t, seg, n))
    for name in (new, old_path):
        chip_smoke.assert_equal((counts[name](), member[name]()), want,
                                f"K2, {name}")
    chip_smoke.assert_equal(whole_map[new](), whole_map[old_path](),
                            "map_read_kmers, new against earlier")
    chip_smoke.assert_equal(whole_has[new](), whole_has[old_path](),
                            "has_read_kmers, new against earlier")
    print(f"K2: both packed paths == the plain twin (bit-exact), counts and "
          f"membership, on {n} queries; classes final/deep/ultra "
          f"{chip_smoke.query_classes(t, seg).tolist()}", flush=True)
    bound_ms = chip_smoke.bound(chip_smoke.k2_bytes(t, seg, n_nodes))[
        "bound_ms"]
    n_all = len(read_kmers)
    for _ in range(2):
        report(f"K2 counts, {n} queries, bound {bound_ms:.6f} ms",
               time_in_turns(dev, counts, reps), card, (n, "queries"))
        report(f"K2 membership, {n} queries",
               time_in_turns(dev, member, reps), card, (n, "queries"))
        report(f"packed map_read_kmers, {n_all} queries",
               time_in_turns(dev, whole_map, reps), card, (n_all, "queries"))
        report(f"packed has_read_kmers, {n_all} queries",
               time_in_turns(dev, whole_has, reps), card, (n_all, "queries"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parent-csrc", type=Path, metavar="DIR", required=True,
                   help="the csrc directory of the earlier commit")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--genome-bases", type=int, default=150_000_000)
    p.add_argument("--reads", type=int, default=1_000_000)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_compare: no CUDA device")
    dev = torch.device("cuda:0")
    card = chip_smoke.card_line()
    print(card, flush=True)
    with tempfile.TemporaryDirectory() as workdir:
        parent = build_parent(args.parent_csrc, workdir)
        compare_k4(dev, card, parent)
        compare_k2(dev, card, args, parent)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
