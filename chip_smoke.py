#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (graph_kmer_index_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0]

1. Prints the card (nvidia-smi name and power limit); with no CUDA device
   it raises: there is no CPU path.
2. Builds the hand-written kernels from the checkout's sources (one nvcc
   per source, all at once): K1 (csrc/sliding_hash.cu), K2
   (csrc/packed_lookup.cu), K3 (csrc/sliding_pack.cu), K4 and K5
   (csrc/stream.cu), K6-K8 (csrc/probes.cu), K9 (csrc/rolled_decode.cu);
   and the native host library (g++ over csrc/host/gki.cpp, walker.cpp
   and rolled.cpp), which it requires: the reads' parse, the build path's
   walk and the rolled upload's encoder run in it.
3. Holds K1 against its plain PyTorch twin on the card (bit-exact).
4. Drives the read-mapping path at chromosome scale, all from --seed: a
   150 Mb genome with planted repeats (a poly-A run, 0.5% copied
   segments) is hashed by K1 into an index of every window (node =
   position // 32 + 1); 1,000,000 reads of 150 bp with 1% substitutions
   are written as FASTA, parsed, hashed on the card (forward and reverse
   complement) and mapped to node counts and membership through K2,
   one launch per read segment and mode and no trip to the host between
   the query classes.
5. Checks the counts and membership against an independent
   sort-and-search join on the card, 1,000 reads' hashes against numpy,
   and that K1 and K2 were launched by step 4 (each path's launches are
   counted from 0 just before it and read just after it).
6. Holds K1 and K2 against their plain twins (bit-exact) on exactly the
   main path's inputs: K1 on the genome, K2 (the whole packed lookup)
   in counts and membership mode on every read segment, which between
   them hold queries of all three classes (final, deep, ultra; counted
   with the twin's classifier). Then K2 on 2^22 queries, half of them
   hits and 1% of them in the poly-A run's ultra bucket.
7. Times both kernels against their twins at the main path's shapes
   (CUDA events, plain / kernel / kernel / plain), and raises unless
   the timed outputs of kernel and twin are equal. Every kernel also
   gets its bound (the least time the card could take: the bytes it
   must move at PEAK_BYTES_PER_S, or for K8 its integer operations at
   PEAK_INT32_OPS_PER_S) and, where one PyTorch call computes the same
   function, that call's time (clone() for K4, a row sum for K5,
   bincount for K7), timed here and used nowhere in the port. In the
   kernels line ``ms`` is a CUDA-event mean, except for K6 and K7, whose
   launches are shorter than a Python call: theirs is the device's own
   time on cold indices (step 9), with ``warm_ms``, ``host_call_ms`` and
   ``events_ms`` beside it.
   Then the upload path (its launches counted from 0): the first
   UPLOAD_QUERIES read k-mers of step 4, one chunk of the staging ring's
   rolled upload, are encoded on the host into the rolled form
   (ops/rolled.py, native), copied to the card and decoded there by K9
   and by its plain twin; both must equal the read k-mers bit for bit,
   and K9 is timed against the twin, its bound the form read once and 8
   bytes a query written.
8. The hashing path. Holds K3 (P16 and P8) against its twin, bit-exact,
   on 2^26 random bases and on lengths 1, 31 and 1,000,003, for k in
   PACK_KS. Then drives the path on the main path's genome: the k = 31
   rows of every window by the P16 route and by the P8 route (K3, the
   lane derivation, combine_lanes), and the bandwidth controls K4
   (stream_copy) and K5 (stream_sum) on a random 512 MiB float32 table;
   checks that K3 (both modes), K4 and K5 were launched; holds K3
   against its twin on the genome, both routes' rows against K1's, K4
   against the table (exact, and on a length below one tile and one
   that is no multiple of the tile) and K5 against a float64 sum
   (relative 1e-4). Times K3, K4 and K5 against their twins and both routes
   against K1, and prints bytes/s and each hashing kernel's share of the
   copy rate that K4 measured.
9. The lookup path (its launches counted from 0 as well). Builds a CSR
   index (KmerIndex.from_rows: bucket layout and set_frequencies) from
   the main path's rows at the reference modulo 452,930,477, ref offset
   = row position, seeded float32 allele frequencies; maps and tests
   every read k-mer through the CSR path (packed budget 0); runs
   get_batched on the first 2^24 read k-mers through the searchsorted
   route and the tables route, and the get API (max_hits 10) on them;
   runs the probes K6 (gather_loop), K7 (rmw_loop) and K8 (bcast_cmp)
   at bench_primitives.py's full sizes, K8 with planted matches and
   repeated table keys. Checks that K6-K8 were launched; that the CSR
   counts and membership equal the packed path's; that both get_batched
   routes are equal, and equal an independent sort-and-search join on a
   sample of 10,000 queries; that the get API keeps exactly the rows of
   frequency <= max_hits; and each probe against its twin (exact), K6
   and K7 also on indices outside the table, on an offset slice cut in
   blocks that are no whole 16-byte vectors, on a skewed set (half of
   the indices one value), on a narrow table, and K7 called again after
   another input (equal tables). Times the probes: K6 and K7 by the
   device's clock (torch.profiler's device time of everything a call
   runs on the card, so K7's covers the zeroing of its table), cold
   (the launches rotate over COLD_BUFFERS seeded index buffers, 128 MiB,
   so every launch reads its indices from device memory) and warm (one
   buffer, which the L2 keeps), beside the host's cost of one wrapper
   call and the earlier method's reading (CUDA events around the Python
   calls); K8 by both clocks; the CSR map/has against the packed path
   and the two get_batched routes against each other.
10. torch.profiler over a second packed call of map_kmers and of
   has_kmers: a summary line each on stdout with the call's host syncs
   (the ops that wait, by name, the runtime's synchronize calls and the
   copies to the host), which must not exceed two a read segment.
   With ``--profile PATH`` the CSR calls are profiled too and the
   operator tables are written to PATH.

11. The build path (bench_chromosome.py's build in the port; its
   launches counted from 0 as well, after every earlier path's state is
   freed). A synthetic SNP/indel graph of
   ``--build-bases`` bases and ``--build-variants`` variants
   (random_snp_graph, 10% indels) -> CriticalGraphPaths.from_graph ->
   find_kmers_parallel_device: 4 spawned workers walk the graph with the
   native span walker (required: a chunk that took the Python walker
   raises) while the parent expands the span groups on the card (K1
   hashes each tape) -> KmerIndex.from_flat_kmers at modulo 452,930,477
   with frequencies -> the packed table -> ``--build-reads`` reads of
   150 bp sampled from the graph's linear reference, hashed on the card
   and mapped to node counts (K2). Checks: the row count equals the
   spans' windows x nodes; the node counts equal an independent join on
   the card; K1 and K2 were launched; K1 equals its twin on a tape of the
   largest group's length; and on a second graph of ``--check-bases``
   bases the four columns of find_kmers_parallel_device on the card equal
   find_kmers_parallel on the host (native finalize_rows) bit for bit,
   and the index built from them has the bucket tables and frequencies of
   an independent numpy build. Prints a stage line each (graph, critical
   paths, streamed find with rows, rows/s, groups and the card's idle
   share inside it by torch.profiler's device time, index build, packed
   table, read mapping) and the path's peak device memory.

12. The signature path: what KAGE ships (its launches counted from 0 as
   well). The build path's graph is written out as a reference sequence
   and ``--build-variants`` VcfVariant records (90% SNPs, 10% insertions)
   -> build_graph_from_vcf, which must give the build path's graph again
   node for node, so that the build path's index (every k-mer of the
   graph, with frequencies) is this graph's scoring index -> the
   SnpKmerFinder sweep of the linear reference at the CLI's defaults
   (k = 31, spacing 31), whose tape K1 hashes -> batched signature
   selection (UniqueVariantKmersFinder.find_unique_kmers_batched, scored
   by KmerIndex.get_frequencies on the card) -> the signature KmerIndex
   at modulo 200,000,033 -> ReverseKmerIndex, ReferenceKmerIndex (of the
   sweep's rows) and VariantNodesIndex -> IndexBundle.to_file ->
   IndexBundle.from_file on the card -> ``--build-reads`` reference reads
   from a FASTA file, both strands, hashed by K1 and mapped through K2
   against the index read from the bundle. Checks, each raising: the two
   graphs are equal; K1 ran inside the sweep and equals its twin on the
   sweep's tape; the sweep's rows hold numpy's hash of the reference
   window at 10,000 sampled positions; get_frequencies on the card
   equals the native library's answer on 100,000 candidate hashes and
   misses; the batched selection equals the per-variant search on the
   first 2,000 variants, column for column; every variant with nodes has
   k-mers for both nodes or is counted as failed; no node is selected at
   two positions; the index read back from the bundle equals the one
   written, column by column, and so do the other entries; K2 ran inside
   the final mapping and its node counts equal an independent join on
   the card. Prints a stage line each and the phase's peak device memory.

13. The sharded phase: a genome-scale index built to disk and served from
   bucket-range shards (its launches counted from 0 as well; those that
   hold K2 against its twin are counted apart and taken off). Over the
   build path's graph and critical paths: find_and_build_out_of_core
   (make_index_out_of_core's function) with SHARD_RANGES bucket ranges
   and 4 spawned workers, which walk the graph (native walker required)
   and spill their rows to disk -> index_from_shard_checkpoint onto the
   card -> convert_checkpoint_to_packed (convert_shards_to_packed's
   function) -> each packed shard read onto the card alone
   (checkpoint.load_shard) and the build path's read k-mers counted
   through K2 in shard mode -> reshard_checkpoint to one shard a card ->
   map_reads -T, the CLI's function in one spawned process a card (NCCL,
   an explicit address and port), on the build path's reads written as
   FASTA, both strands. Checks, each raising: the out-of-core index
   equals the build path's from_flat_kmers index column for column; K2
   in shard mode equals its twin on each shard (counts and membership,
   SHARD_SAMPLE owned read k-mers and SHARD_MISSES random hashes); the
   shards' counts sum to the single table's; the map_reads -T counts
   equal KmerIndex.map_kmers on the same reads; K1 (in the ranks) and K2
   were launched. Prints a stage line each (with the find, spill-write
   and shard-build seconds and the spill and checkpoint bytes).

14. The sharded-build phase (its launches counted from 0 as well; those of
   its checks taken off, those of the dry run's ranks added), over the
   build path's index, in a one-rank process group (NCCL; one card, and
   NCCL refuses two ranks on one card, so the multi-rank exchange is the
   CPU tests' to hold). The index's rows in a seeded random order (the
   finder's emission order is hash-random) -> build_packed_shards_sharded
   (inside device_trace; the trace's bytes printed) -> the packed count
   and membership steps from k-mers (K2 in shard mode) on the build path's
   read k-mers -> build_table_shards_sharded at modulo 452,930,477 -> the
   CSR count step -> frequencies_sharded -> count_min_sketch_sharded (three
   primes near 10^6), merge_flat_kmers_all_gather (the index's four
   columns), run_sharded_function, map_kmers_sharded and has_kmers_sharded
   -> save_shards of the CSR shard on the mesh and load_shards back ->
   entry()'s forward (K1) -> dryrun_multichip on every card, spawned.
   Checks, each raising: the packed shard equals lookup.build_packed of
   the same rows, record for record and row for row; the steps' counts
   equal the build path's and their membership K2's on build_packed's
   table; K2 in shard mode equals its twin; the CSR shard's sizes equal
   the index's, and its starts where a bucket holds rows; frequencies
   (un-permuted) equal the index's; the sketch equals bincount, the merge
   its inputs, run_sharded_function the function applied whole, the
   sharded map/has the index's; the checkpoint reads back equal; entry()'s
   forward equals the toy index's map_kmers on the same valid windows and
   K1 its twin on those reads; every dry-run rank passes; K1 and K2 were
   launched. Prints a stage line each, Timings.report() of the stages and
   the phase's peak device memory.

Any failed check raises before the last line, which is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from graph_kmer_index_tpu_torch import (  # noqa: E402
    CriticalGraphPaths, DeviceReadKmers, IndexBundle, KmerIndex,
    ReferenceKmerIndex, ReverseKmerIndex, SnpKmerFinder,
    UniqueVariantKmersFinder, VariantNodesIndex, VcfVariants,
    build_graph_from_vcf, entry, hash_fasta_file, native)
from graph_kmer_index_tpu_torch.hashing import (  # noqa: E402
    kmer_hashes_to_reverse_complement_hash, sliding_window_hashes)
from graph_kmer_index_tpu_torch.ops import _kernels  # noqa: E402
from graph_kmer_index_tpu_torch.ops import (  # noqa: E402
    encode, host_buffers, lookup, primitives, rolled)
from graph_kmer_index_tpu_torch.parallel import (  # noqa: E402
    checkpoint, mesh, oocbuild, sharded)
from graph_kmer_index_tpu_torch.parallel.host_pool import (  # noqa: E402
    find_kmers_parallel, find_kmers_parallel_device)
from graph_kmer_index_tpu_torch.utils import synthetic  # noqa: E402
from graph_kmer_index_tpu_torch.utils.profiling import (  # noqa: E402
    Timings, device_trace)

K1_SOURCE = "graph_kmer_index_tpu_torch/csrc/sliding_hash.cu"
K2_SOURCE = "graph_kmer_index_tpu_torch/csrc/packed_lookup.cu"
K3_SOURCE = "graph_kmer_index_tpu_torch/csrc/sliding_pack.cu"
K45_SOURCE = "graph_kmer_index_tpu_torch/csrc/stream.cu"
K678_SOURCE = "graph_kmer_index_tpu_torch/csrc/probes.cu"
K9_SOURCE = "graph_kmer_index_tpu_torch/csrc/rolled_decode.cu"
K1_REPLACES = "graph_kmer_index_tpu/ops/encode.py:133"
K2_REPLACES = "graph_kmer_index_tpu/ops/lookup.py:349"
K3_REPLACES = "graph_kmer_index_tpu/ops/encode.py:242"
K4_REPLACES = "benchmarks/bench_primitives.py:325"
K5_REPLACES = "benchmarks/bench_primitives.py:369"
K6_REPLACES = "benchmarks/bench_primitives.py:140"
K7_REPLACES = "benchmarks/bench_primitives.py:182"
K8_REPLACES = "benchmarks/bench_primitives.py:224"
K9_REPLACES = "none: the JAX package uploads its queries whole"
K = 31
READ_LEN = 150
PACK_KS = (1, 5, 8, 9, 12, 15, 16, 17, 21, 31)
READ_MAPPING_KERNELS = ("sliding_hash", "packed_lookup")
HASHING_KERNELS = ("sliding_pack_p16", "sliding_pack_p8", "stream_copy",
                   "stream_sum")
LOOKUP_KERNELS = ("gather_loop", "rmw_loop", "bcast_cmp")
UPLOAD_KERNELS = ("rolled_decode",)
BUILD_KERNELS = ("sliding_hash", "packed_lookup")
SIGNATURE_KERNELS = ("sliding_hash", "packed_lookup")
SHARDED_KERNELS = ("sliding_hash", "packed_lookup")
SHARDED_BUILD_KERNELS = ("sliding_hash", "packed_lookup")
# the sharded-build phase's count-min sketch: three primes near 10^6
CMS_MODULOS = (999_983, 1_000_003, 1_000_033)
# the sharded phase: the out-of-core build's bucket ranges (table shards),
# and the queries of each shard that K2 in shard mode is held against its
# twin on (owned read k-mers, then random hashes that mostly miss)
SHARD_RANGES = 4
SHARD_SAMPLE = 1 << 20
SHARD_MISSES = 1 << 18
# one rank of map_reads -T: the CLI's function in a fresh process, which
# prints its kernel launches last
CLI_RANK = ("import json, sys\n"
            "from graph_kmer_index_tpu_torch import cli\n"
            "from graph_kmer_index_tpu_torch.ops import _kernels\n"
            "cli.run_argument_parser(sys.argv[1:])\n"
            "print('LAUNCHES ' + json.dumps(_kernels.launch_counts))\n")
# the signature path: the modulo of the signature index (the CLI's
# default for an index over an index's k-mers, create_counter_index), the
# sweep's spacing and caps (the CLI's defaults for ``make``), the
# selection's variant-node cap (the CLI's default), and the sizes of the
# samples its checks draw
SIGNATURE_MODULO = 200_000_033
SWEEP_SPACING = 31
SWEEP_CAPS = dict(max_kmers_same_position=100000, max_frequency=10000000,
                  max_variant_nodes=100000)
SELECT_MAX_VARIANT_NODES = 6
SWEEP_SAMPLE = 10_000
FREQUENCY_SAMPLE = 100_000
EXACT_VARIANTS = 2_000
GRAPH_ARRAYS = ("sequence", "node_sizes", "seq_start", "edge_targets",
                "edge_index", "linear_ref_mask", "node_to_ref_offset",
                "allele_frequencies")
# the build path: bench_chromosome.py's worker count and stream targets,
# and the modulo of the small graph's index, which a numpy build repeats
BUILD_WORKERS = 4
STREAM_TARGET = 24_000_000
CHECK_MODULO = 15_485_863
# the upload path: the read k-mers of one chunk of the rolled upload
UPLOAD_QUERIES = host_buffers.ROLL_QUERIES
# the CSR index of the lookup path: the reference's default modulo, and
# the get_batched batch and its sample checked against a join
REF_MODULO = 452_930_477
GET_QUERIES = 1 << 24
GET_SAMPLE = 10_000
GET_MAX_HITS = 10
CAPS_OFF = (1 << 31) - 1
# device bytes per base of each hashing kernel: 1 in, plus 8 (int64
# hash), 4 (P16) or 2 (P8) out
BYTES_PER_BASE = {"K1 sliding_hash": 9, "K3 P16": 5, "K3 P8": 3}
SUM_RTOL = 1e-4  # the JAX benchmark's own bound (bench_primitives.py:420)
# The card's published peaks, which every bound is stated against (NVIDIA's
# H100 SXM data sheet): 3.35 TB/s of device memory; 67 TFLOP/s of float32
# outside the tensor cores is 33.5 T instructions a second on 128 float32
# lanes per SM, and an SM has 64 int32 lanes, so 16.75 T int32 operations.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 16.75e12
# integer operations of one (query, entry) compare in K8: the compare of
# lo, the compare of hi joined with it (one predicate instruction), the
# add to the count, the select of the first node
CMP_OPS = 4
# K6 and K7 are timed over this many seeded index buffers in turn: 8 x 16
# MiB at the probes' full size, several times the card's 50 MB L2, so that
# each launch finds its indices in device memory as a caller's would be
COLD_BUFFERS = 8
# ops that make the host wait for the device
SYNC_OPS = ("aten::nonzero", "aten::item", "aten::_local_scalar_dense")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Stages:
    """Host-clock seconds per stage, each ending in a device synchronise."""

    def __init__(self, dev, card):
        self.dev, self.card = dev, card

    def run(self, name, fn, *args, **kw):
        sync(self.dev)
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        sync(self.dev)
        self.report(name, time.perf_counter() - t0)
        return out

    def report(self, name, seconds, extra=""):
        print(f"stage {name}: {seconds:.6f} s{extra} [{self.card}]",
              flush=True)


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    if a.is_floating_point():
        return float((a.double() - b.double()).abs().max())
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def assert_equal(got, want, what: str) -> int:
    """Raise unless a kernel's output (a tensor or a tuple of them) equals
    its twin's bit for bit; returns the max abs difference (0)."""
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    err = 0
    for a, b in zip(got, want, strict=True):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: kernel != plain")
        err = max(err, max_abs_diff(a, b))
    return err


def check_k1(dev, n_random: int, gen) -> int:
    """K1 == plain twin, bit-exact; returns the max abs difference."""
    err = 0
    cases = [(n_random, k) for k in (1, 15, 16, 17, 31)]
    cases += [(n, k) for n in (1, 31, 1_000_003) for k in (1, 17, 31)]
    for n, k in cases:
        seq = torch.randint(0, 4, (n,), dtype=torch.int8, device=dev,
                            generator=gen)
        err = max(err, assert_equal(encode.sliding_hashes(seq, k),
                                    encode.sliding_hashes_plain(seq, k),
                                    f"K1 at n={n} k={k}"))
    print(f"K1 == plain (bit-exact) on {len(cases)} cases, "
          f"incl. {n_random} bases x k in (1,15,16,17,31)", flush=True)
    return err


def assert_close_sums(got, want, what: str) -> float:
    """Raise unless float sums agree within SUM_RTOL, relative; returns the
    max relative difference."""
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if got.numel() == 0:
        return 0.0
    want = want.double()
    rel = float(((got.double() - want).abs() / want.abs()).max())
    if not rel <= SUM_RTOL:
        raise AssertionError(f"{what}: relative error {rel} > {SUM_RTOL}")
    return rel


def require_launches(launches: dict, names, path: str) -> None:
    for name in names:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"{path}")


def bound(nbytes: float = 0, ops: float = 0) -> dict:
    """The least time the card could take: the larger of bytes over its
    memory rate and operations over its int32 rate, with what bounds it."""
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def time_one(dev, fn, reps) -> float:
    """CUDA-event mean over ``reps`` calls after one warm-up, in ms."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps


def _device_us(event) -> float:
    us = getattr(event, "self_device_time_total", None)
    return us if us is not None else event.self_cuda_time_total


def device_time(dev, calls, rounds) -> tuple[float, dict]:
    """The device's own time for one call, in ms, and its parts by kernel
    name: torch.profiler's device time of everything the card ran
    (kernels, memsets, copies) while ``calls`` were made in turn
    ``rounds`` times over, divided by the number of calls. The host's
    pace does not enter: a gap between two launches is no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for fn in calls:
        fn()  # warm-up: the build, the allocator's blocks
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(rounds):
            for fn in calls:
                fn()
        sync(dev)
    n = rounds * len(calls)
    parts = {e.key: _device_us(e) / n / 1e3 for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA}
    if not parts:
        raise AssertionError("the profiler saw no device activity")
    return sum(parts.values()), parts


def host_call_time(dev, fn, reps) -> float:
    """Host-clock mean of one call of ``fn`` in ms: what the host spends to
    check, allocate and launch, with no wait for the device inside."""
    fn()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    seconds = time.perf_counter() - t0
    sync(dev)
    return seconds / reps * 1e3


def classify(t, q) -> torch.Tensor:
    """0 final, 1 deep, 2 ultra per query, by the twin's classifier (counts
    mode)."""
    return lookup.packed_decode_plain(t.records, q, q.shape[0], t.modulo2,
                                      0)[1]


def query_classes(t, q) -> torch.Tensor:
    """final/deep/ultra counts of the queries."""
    return torch.bincount(classify(t, q).to(torch.int64), minlength=3)


def k2_bytes(t, q, n_nodes) -> int:
    """Bytes a packed lookup (counts) of ``q`` must move: per query 8 of
    query and one 32-byte record, the counts written once, and for every
    distinct k-mer that its record does not answer the k-mers of its
    bucket's rows and the nodes of the rows that match."""
    uniq = torch.unique(q[classify(t, q) > 0])
    scanned = int(lookup._bucket_meta(t, uniq)[1].sum())
    matched = lookup._ultra_matches(t, uniq)[1].shape[0]
    return q.shape[0] * 40 + n_nodes * 8 + (scanned + matched) * 8


def main_path(dev, card, args, workdir):
    """The read-mapping path at the requested scale; returns its state."""
    st = Stages(dev, card)
    rng = np.random.default_rng(args.seed)
    k = K

    t0 = time.perf_counter()
    genome, poly_a = synthetic.random_genome(args.genome_bases, rng)
    st.report("genome (host set-up)", time.perf_counter() - t0,
              f", {len(genome)} bases, poly-A (start, length) {poly_a}")
    genome_dev = st.run("genome upload", lambda: torch.from_numpy(genome)
                        .to(dev))
    n_win = len(genome) - k + 1
    rows = st.run("genome hash (K1)",
                  lambda: encode.sliding_hashes(genome_dev, k)[:n_win])
    nodes = torch.arange(n_win, device=dev) // 32 + 1
    index = KmerIndex.from_arrays(rows, nodes, lookup.internal_modulo(n_win),
                                  dev)
    tables = st.run("table build", index.device_index.packed)
    n_nodes = index.max_node_id() + 1
    print(f"table: {n_win} rows, {n_nodes} nodes, modulo2 "
          f"{tables.modulo2}, records {tables.records.numel() * 4} bytes, "
          f"max bucket {tables.max_sz}, deep rows {tables.deep_frac:.6f}",
          flush=True)

    t0 = time.perf_counter()
    reads = synthetic.sample_reads(genome, args.reads, READ_LEN, rng,
                                   poly_a)
    fasta = Path(workdir) / "reads.fa"
    synthetic.write_fasta(fasta, reads)
    st.report("reads (host set-up)", time.perf_counter() - t0,
              f", {args.reads} x {READ_LEN} bp, "
              f"{fasta.stat().st_size} bytes of FASTA")

    stages = {}
    t0 = time.perf_counter()
    read_kmers = hash_fasta_file(str(fasta), k, device=dev,
                                 include_reverse_complements=True,
                                 stage_seconds=stages)
    total = time.perf_counter() - t0
    n_q = len(read_kmers)
    for name in ("read", "parse", "upload", "hash"):
        st.report(f"reads {name}", stages.get(name, 0.0))
    st.report("hash_fasta_file total", total,
              f", {n_q} query k-mers, {n_q / total:.1f} k-mers/s")
    t0 = time.perf_counter()
    counts = index.map_kmers(read_kmers, n_nodes)
    sync(dev)
    t_map = time.perf_counter() - t0
    st.report("map_kmers", t_map, f", {n_q / t_map:.1f} queries/s")
    t0 = time.perf_counter()
    member = index.has_kmers(read_kmers)
    sync(dev)
    t_has = time.perf_counter() - t0
    st.report("has_kmers", t_has, f", {n_q / t_has:.1f} queries/s")
    return dict(genome=genome_dev, index=index, tables=tables,
                n_nodes=n_nodes, reads=reads, read_kmers=read_kmers,
                counts=counts, member=member)


def join_counts(table_kmers, table_nodes, queries, n_nodes) -> torch.Tensor:
    """Node counts by a join that shares no code with the lookup: every
    table row adds the number of queries equal to its k-mer (nodes >=
    n_nodes dropped)."""
    uq, qc = torch.unique(queries, return_counts=True)
    ref = torch.zeros(n_nodes, dtype=torch.int64, device=queries.device)
    if uq.shape[0] == 0:
        return ref
    pos = torch.searchsorted(uq, table_kmers).clamp(max=uq.shape[0] - 1)
    match = (uq[pos] == table_kmers) & (table_nodes < n_nodes)
    ref.index_add_(0, table_nodes[match], qc[pos[match]])
    return ref


def check_results(dev, state, k, n_sample, rng):
    """Counts and membership against an independent join on the device;
    sampled reads' hashes against numpy."""
    index, read_kmers = state["index"], state["read_kmers"]
    queries = torch.cat(read_kmers.segments)
    n_nodes = state["n_nodes"]
    counts = torch.from_numpy(state["counts"]).to(dev)
    member = torch.from_numpy(state["member"]).to(dev)
    if counts.shape != (n_nodes,) or member.shape != queries.shape:
        raise AssertionError("result shapes differ from the contract")

    ref = join_counts(index.kmers, index.nodes, queries, n_nodes)
    if not torch.equal(counts, ref):
        raise AssertionError(f"counts differ from the join at "
                             f"{int((counts != ref).sum())} nodes")
    # membership: searchsorted in the sorted unique table k-mers
    tu = torch.unique(index.kmers)
    pos = torch.searchsorted(tu, queries).clamp(max=tu.shape[0] - 1)
    ref_member = tu[pos] == queries
    if not torch.equal(member, ref_member):
        raise AssertionError(f"membership differs from the join at "
                             f"{int((member != ref_member).sum())} queries")
    print(f"counts == join ({int(counts.sum())} hits over {n_nodes} nodes); "
          f"membership == join ({int(member.sum())} of {queries.shape[0]} "
          "query k-mers present)", flush=True)

    reads = state["reads"]
    n_reads, read_len = reads.shape
    per = read_len - k + 1
    n_fw = n_reads * per
    sample = rng.choice(n_reads, size=min(n_sample, n_reads), replace=False)
    for r in sample.tolist():
        fw = sliding_window_hashes(reads[r], k)
        rc = kmer_hashes_to_reverse_complement_hash(fw, k)
        got_fw = queries[r * per:(r + 1) * per].cpu().numpy().view(np.uint64)
        got_rc = (queries[n_fw + r * per:n_fw + (r + 1) * per]
                  .cpu().numpy().view(np.uint64))
        if not (np.array_equal(got_fw, fw) and np.array_equal(got_rc, rc)):
            raise AssertionError(f"read {r}: device hashes != numpy")
    print(f"read hashes == numpy on {len(sample)} sampled reads "
          "(forward and reverse complement)", flush=True)
    hit_share = float(member[:n_fw].float().mean()) if n_fw else 0.0
    print(f"forward k-mers found in the index: {hit_share:.6f}", flush=True)
    if not 0.5 < hit_share <= 1.0:
        raise AssertionError(f"implausible forward hit share {hit_share}")


def check_at_main_shapes(state, k) -> tuple[int, int]:
    """K1 and K2 against their twins, bit-exact, on exactly the inputs the
    main path gave them: K1 on the genome, K2 in counts and membership
    mode on every read segment. Fails unless the segments held queries of
    all three classes. Returns the max abs differences (K1, K2)."""
    genome = state["genome"]
    k1_err = assert_equal(encode.sliding_hashes(genome, k),
                          encode.sliding_hashes_plain(genome, k),
                          "K1 on the main path's genome")
    t, n_nodes = state["tables"], state["n_nodes"]
    k2_err, cls = 0, torch.zeros(3, dtype=torch.int64, device=genome.device)
    segments = state["read_kmers"].segments
    for seg in segments:
        n = seg.shape[0]
        for mode in (n_nodes, None):
            k2_err = max(k2_err, assert_equal(
                lookup.packed_lookup(t, seg, n, mode),
                lookup.packed_lookup_plain(t, seg, n, mode),
                f"K2 ({'counts' if mode else 'membership'}) on a main-path "
                f"segment of {n} queries"))
        cls += query_classes(t, seg)
    cls = cls.tolist()
    if min(cls) == 0:
        raise AssertionError(f"main-path queries miss a class: final/deep/"
                             f"ultra {cls}")
    print(f"K1 == plain (bit-exact) on the main path's {genome.shape[0]} "
          f"bases; K2 == plain (bit-exact), counts and membership, on its "
          f"{len(segments)} read segments ({sum(cls)} queries, classes "
          f"final/deep/ultra {cls})", flush=True)
    return k1_err, k2_err


def check_k2(dev, state, n_q, gen) -> int:
    """K2 == plain twin (counts and membership) on n_q queries: half of
    them table hits, 1% rows of buckets deeper than SCAN_CAP (the planted
    poly-A run's), the first 64th of them one such k-mer over and over,
    the last 1,000 padding past n_valid, so that every class is
    compared."""
    t = state["tables"]
    n_nodes = state["n_nodes"]
    _, run = torch.unique_consecutive(t.ks % t.modulo2, return_counts=True)
    ultra_rows = t.ks[torch.repeat_interleave(run > lookup.SCAN_CAP, run)]
    del run
    half, n_ultra = n_q // 2, n_q // 100
    if ultra_rows.shape[0] == 0:
        raise AssertionError("the table has no bucket deeper than SCAN_CAP")
    q = torch.cat([
        t.ks[torch.randint(0, t.ks.shape[0], (half,), device=dev,
                           generator=gen)],
        ultra_rows[torch.randint(0, ultra_rows.shape[0], (n_ultra,),
                                 device=dev, generator=gen)],
        torch.randint(0, 1 << 62, (n_q - half - n_ultra,), device=dev,
                      generator=gen)])
    q = q[torch.randperm(n_q, device=dev, generator=gen)]
    # a run of one ultra k-mer: every query of a tile on one table slot
    q[:n_q // 64] = ultra_rows[0]
    n_valid = n_q - min(1000, n_q // 4)
    err = 0
    for mode in (n_nodes, None):
        err = max(err, assert_equal(
            lookup.packed_lookup(t, q, n_valid, mode),
            lookup.packed_lookup_plain(t, q, n_valid, mode),
            f"K2 ({'counts' if mode else 'membership'}) on {n_q} queries"))
    # batches below and just over one tile of the kernel
    for n in (1, 255, 257):
        for mode in (n_nodes, None):
            err = max(err, assert_equal(
                lookup.packed_lookup(t, q[:n], n, mode),
                lookup.packed_lookup_plain(t, q[:n], n, mode),
                f"K2 on {n} queries"))
    cls = query_classes(t, q[:n_valid]).tolist()
    if min(cls) == 0:
        raise AssertionError(f"K2 check misses a class: final/deep/ultra "
                             f"{cls}")
    print(f"K2 == plain (bit-exact) on {n_q} queries ({n_valid} valid), "
          f"counts and membership; classes final/deep/ultra {cls}",
          flush=True)
    return err


def time_pair(dev, kernel, plain, reps, what, compare=assert_equal):
    """CUDA-event means over ``reps`` calls, in the order plain, kernel,
    kernel, plain: (kernel ms, plain ms, the four means, max error).
    Raises unless ``compare`` accepts the kernel's output against the
    twin's on these inputs (by default: equal bit for bit)."""
    outs = []

    def once(fn):
        outs.append(fn())  # warm-up, kept for the comparison
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / reps

    p1 = once(plain)
    k1 = once(kernel)
    err = compare(outs.pop(), outs.pop(), what)
    k2, p2 = once(kernel), once(plain)
    err = max(err, compare(outs[0], outs[1], what))
    return (k1 + k2) / 2, (p1 + p2) / 2, (k1, k2, p1, p2), err


def time_kernels(dev, card, state, k) -> dict:
    """Both kernels against their twins on the main path's inputs, each
    timed output also compared: K1 on the genome, K2 (counts) on the
    largest read segment. Returns {name: the kernels line's measured
    fields}."""
    genome = state["genome"]
    genome_bases = genome.shape[0]
    k1_ms, k1_plain, raw1, k1_err = time_pair(
        dev, lambda: encode.sliding_hashes(genome, k),
        lambda: encode.sliding_hashes_plain(genome, k), 3,
        "K1 timed on the genome")
    t = state["tables"]
    seg = max(state["read_kmers"].segments, key=lambda s: s.shape[0])
    n_nodes = state["n_nodes"]
    k2_ms, k2_plain, raw2, k2_err = time_pair(
        dev, lambda: lookup.packed_lookup(t, seg, seg.shape[0], n_nodes),
        lambda: lookup.packed_lookup_plain(t, seg, seg.shape[0], n_nodes), 3,
        "K2 (counts) timed on the largest read segment")
    has_ms = time_one(dev, lambda: lookup.packed_lookup(t, seg, seg.shape[0]),
                      3)
    b1 = bound(BYTES_PER_BASE["K1 sliding_hash"] * genome_bases)
    b2 = bound(k2_bytes(t, seg, n_nodes))
    print(f"timing K1 sliding_hash, {genome_bases} bases k={k}: kernel "
          f"{k1_ms:.6f} ms ({genome_bases / k1_ms / 1e6:.3f} G bases/s), "
          f"plain {k1_plain:.6f} ms, bound {b1['bound_ms']:.6f} ms, outputs "
          f"equal; kernel,kernel,plain,plain = {raw1} [{card}]", flush=True)
    print(f"timing K2 packed_lookup (counts), {seg.shape[0]} queries: "
          f"kernel {k2_ms:.6f} ms "
          f"({seg.shape[0] / k2_ms / 1e6:.3f} G queries/s), plain "
          f"{k2_plain:.6f} ms, bound {b2['bound_ms']:.6f} ms, outputs equal; "
          f"kernel,kernel,plain,plain = {raw2}; membership mode "
          f"{has_ms:.6f} ms; classes final/deep/ultra "
          f"{query_classes(t, seg).tolist()} [{card}]", flush=True)
    return {"sliding_hash": {"max_abs_err": k1_err, "ms": k1_ms,
                             "plain_ms": k1_plain, **b1, "library_ms": None},
            "packed_lookup": {"max_abs_err": k2_err, "ms": k2_ms,
                              "plain_ms": k2_plain, **b2,
                              "library_ms": None}}


def upload_path(dev, card, read_kmers, n=UPLOAD_QUERIES) -> dict:
    """One chunk of the rolled upload at the staging ring's size: the first
    ``n`` read k-mers on the host, their rolled form (native), its copy to
    the card and K9's decode of it there. Returns each of them."""
    queries = first_queries(read_kmers, n).cpu()
    room = torch.empty(host_buffers.ROLL_BYTES, dtype=torch.uint8)
    form = rolled.encode(queries, room)
    if form is None:
        raise AssertionError(f"{queries.shape[0]} read k-mers did not take "
                             "the rolled form")
    device_form = room[:form.nbytes].to(dev)
    out = torch.empty(form.n, dtype=torch.int64, device=dev)
    rolled.decode(form, device_form, out)
    print(f"upload path: {form.n} read k-mers in {form.nbytes} bytes of "
          f"rolled form ({form.n_anchors} anchors, {form.w} digits a "
          f"hash) against {8 * form.n} raw [{card}]", flush=True)
    return dict(queries=queries, form=form, device_form=device_form, out=out)


def _decode_twin(form, device_form) -> torch.Tensor:
    out = torch.empty(form.n, dtype=torch.int64, device=device_form.device)
    rolled.decode_plain(form, device_form, out)
    return out


def check_upload(up) -> dict:
    """K9's output against its plain twin's on the same form and against
    the read k-mers that were encoded (bit-exact); the kernels line's error
    field."""
    err = max(assert_equal(up["out"], _decode_twin(up["form"],
                                                   up["device_form"]),
                           "K9 against its twin"),
              assert_equal(up["out"].cpu(), up["queries"],
                           "K9 against the uploaded read k-mers"))
    print(f"K9 == plain == the read k-mers (bit-exact) on {up['form'].n} "
          "queries", flush=True)
    return {"rolled_decode": {"max_abs_err": err}}


def time_upload(dev, card, up, reps=10) -> dict:
    """K9 against its twin on the upload path's form, each timed output
    compared; its bound the form read once and 8 bytes a query written."""
    form, device_form = up["form"], up["device_form"]

    def kernel():
        out = torch.empty(form.n, dtype=torch.int64, device=dev)
        rolled.decode(form, device_form, out)
        return out

    ms, plain_ms, raw, err = time_pair(
        dev, kernel, lambda: _decode_twin(form, device_form), reps,
        "K9 timed on a chunk of read k-mers")
    b = bound(nbytes=form.nbytes + 8 * form.n)
    print(f"timing K9 rolled_decode, {form.n} queries from {form.nbytes} "
          f"bytes: kernel {ms:.6f} ms ({form.n / ms / 1e6:.3f} G queries/s), "
          f"plain {plain_ms:.6f} ms, bound {b['bound_ms']:.6f} ms, outputs "
          f"equal; kernel,kernel,plain,plain = {raw} [{card}]", flush=True)
    return {"rolled_decode": {"max_abs_err": err, "ms": ms,
                              "plain_ms": plain_ms, **b, "library_ms": None}}


def check_k3(dev, n_random: int, gen) -> int:
    """K3 == plain twin in both modes (P16, P8), bit-exact; returns the max
    abs difference."""
    err = 0
    cases = [(n, k) for n in (n_random, 1, 31, 1_000_003) for k in PACK_KS]
    for n, k in cases:
        seq = torch.randint(0, 4, (n,), dtype=torch.int8, device=dev,
                            generator=gen)
        for m_cap in (16, 8):
            err = max(err, assert_equal(
                encode.sliding_pack(seq, k, m_cap),
                encode.sliding_pack_plain(seq, k, m_cap),
                f"K3 P{m_cap} at n={n} k={k}"))
    print(f"K3 == plain (bit-exact), P16 and P8, on {len(cases)} cases: "
          f"{n_random}, 1, 31 and 1000003 bases x k in {PACK_KS}",
          flush=True)
    return err


def hashing_path(dev, card, genome, stream_rows, block_rows, gen):
    """The genome-hashing path and the bandwidth controls, through the
    functions a user calls: the k = 31 rows of every window of the genome
    (the rows KmerIndex.from_arrays takes) by the P16 and by the P8 route
    (K3, then the lane derivation and combine_lanes), and stream_copy /
    stream_sum over a random float32 table of stream_rows x 128. Returns
    every output."""
    st = Stages(dev, card)
    out = {}
    routes = {16: (encode.sliding_p16, encode.p16_to_lanes),
              8: (encode.sliding_p8, encode.p8_to_lanes)}
    for m_cap, (pack, to_lanes) in routes.items():
        packed = st.run(f"genome P{m_cap} (K3)", pack, genome, K)
        out[f"rows{m_cap}"] = st.run(
            f"P{m_cap} lanes + combine",
            lambda: encode.combine_lanes(*to_lanes(packed, K)))
        out[f"p{m_cap}"] = packed
    table = torch.rand((stream_rows, primitives.STREAM_COLS),
                       generator=gen, device=dev)
    seed = torch.randint(1, 100, (1024,), dtype=torch.int32, device=dev,
                         generator=gen)
    out.update(table=table, seed=seed, block_rows=block_rows)
    out["copy"] = st.run("stream_copy (K4)", primitives.stream_copy, table)
    # below one tile of K4, and whole tiles plus a ragged last one
    words = table.view(-1, 4)
    tile = primitives.COPY_TILE_BYTES // 16
    out["ragged"] = [(n, primitives.stream_copy(words[:n]))
                     for n in (5, min(1000 * tile + 37, words.shape[0] - 1))]
    out["sums"] = st.run("stream_sum (K5)", primitives.stream_sum, table,
                         seed, block_rows)
    return out


def check_hashing(state, h) -> dict:
    """The hashing path's outputs: K3 against its twin on the genome
    (bit-exact), both routes' rows against K1's (bit-exact), K4 against its
    source and clone() (exact), K5 against a float64 sum and its twin
    (relative SUM_RTOL). Returns each kernel's error fields for the
    kernels line: max_abs_err (K5: against the float64 sum, with its
    max_rel_err)."""
    genome = state["genome"]
    errs = {f"sliding_pack_p{m}": {"max_abs_err": assert_equal(
        h[f"p{m}"], encode.sliding_pack_plain(genome, K, m),
        f"K3 P{m} on the main path's genome")} for m in (16, 8)}
    want = encode.sliding_hashes(genome, K)
    for m in (16, 8):
        assert_equal(h[f"rows{m}"], want, f"the P{m} route's k={K} rows "
                     "against K1's")
    del want
    table, seed, block_rows = h["table"], h["seed"], h["block_rows"]
    errs["stream_copy"] = {"max_abs_err": max(
        assert_equal(h["copy"], table, "K4 against its source"),
        assert_equal(h["copy"], primitives.stream_copy_plain(table),
                     "K4 against clone()"),
        *(assert_equal(got, table.view(-1, 4)[:n], f"K4 on {n} words")
          for n, got in h["ragged"]))}
    n_blocks = table.shape[0] // block_rows
    exact = table.view(n_blocks, -1).double().sum(1) + float(seed[0])
    rel = assert_close_sums(h["sums"], exact, "K5 against a float64 sum")
    assert_close_sums(h["sums"], primitives.stream_sum_plain(
        table, seed, block_rows), "K5 against its twin")
    errs["stream_sum"] = {"max_abs_err": max_abs_diff(h["sums"], exact),
                          "max_rel_err": rel}
    print(f"K3 == plain (bit-exact), P16 and P8, on the main path's "
          f"{genome.shape[0]} bases; the P16 and the P8 route's k={K} rows "
          f"== K1's (bit-exact); K4 == source and clone() (exact) on "
          f"{table.numel() * 4} bytes and on "
          f"{[n * 16 for n, _ in h['ragged']]} bytes (tile "
          f"{primitives.COPY_TILE_BYTES}); K5 within {rel:.3e} relative "
          f"(bound {SUM_RTOL}) of a float64 sum over {n_blocks} blocks",
          flush=True)
    return errs


def time_hashing(dev, card, state, h, reps=10):
    """K3 (both modes), K4 and K5 against their twins, and the whole P16
    and P8 routes against K1, on the hashing path's inputs; every timed
    output is compared; clone() beside K4 and a row sum beside K5 as the
    one PyTorch call that computes the same function. Prints the rates;
    returns {name: the kernels line's timed fields}."""
    genome = state["genome"]
    n = genome.shape[0]
    table, seed, block_rows = h["table"], h["seed"], h["block_rows"]
    timed = {}
    for m in (16, 8):
        timed[f"sliding_pack_p{m}"] = time_pair(
            dev, lambda m=m: encode.sliding_pack(genome, K, m),
            lambda m=m: encode.sliding_pack_plain(genome, K, m), reps,
            f"K3 P{m} timed on the genome")
    timed["stream_copy"] = time_pair(
        dev, lambda: primitives.stream_copy(table),
        lambda: primitives.stream_copy_plain(table), reps, "K4 timed")
    timed["stream_sum"] = time_pair(
        dev, lambda: primitives.stream_sum(table, seed, block_rows),
        lambda: primitives.stream_sum_plain(table, seed, block_rows), reps,
        "K5 timed", compare=assert_close_sums)
    n_blocks = table.shape[0] // block_rows
    library = {"stream_copy": time_one(dev, table.clone, reps),
               "stream_sum": time_one(
                   dev, lambda: table.view(n_blocks, -1).sum(1), reps)}
    routes = {}
    for m, route in ((16, encode.sliding_hashes_p16),
                     (8, encode.sliding_hashes_p8)):
        routes[m] = time_pair(
            dev, lambda route=route: encode.combine_lanes(*route(genome, K)),
            lambda: encode.sliding_hashes(genome, K), reps,
            f"the P{m} route timed against K1")

    nbytes = table.numel() * 4
    bounds = {"sliding_pack_p16": bound(BYTES_PER_BASE["K3 P16"] * n),
              "sliding_pack_p8": bound(BYTES_PER_BASE["K3 P8"] * n),
              "stream_copy": bound(2 * nbytes),
              "stream_sum": bound(nbytes + 4 * n_blocks + 4)}
    for name, moved, call in (
            ("stream_copy", 2 * nbytes, "clone()"),
            ("stream_sum", nbytes, f"view({n_blocks}, -1).sum(1)")):
        ms, plain_ms, raw, _ = timed[name]
        print(f"timing K{4 if name == 'stream_copy' else 5} {name}, "
              f"{nbytes} bytes: kernel {ms:.6f} ms "
              f"({moved / ms / 1e9:.3f} TB/s), plain {plain_ms:.6f} ms "
              f"({moved / plain_ms / 1e9:.3f} TB/s), bound "
              f"{bounds[name]['bound_ms']:.6f} ms, one PyTorch call "
              f"({call}) {library[name]:.6f} ms; kernel,kernel,plain,"
              f"plain = {raw} [{card}]", flush=True)
    copy_rate = 2 * nbytes / timed["stream_copy"][0] * 1e3
    k1_ms = (routes[16][1] + routes[8][1]) / 2
    for name, ms in (("K1 sliding_hash", k1_ms),
                     ("K3 P16", timed["sliding_pack_p16"][0]),
                     ("K3 P8", timed["sliding_pack_p8"][0])):
        rate = BYTES_PER_BASE[name] * n / ms * 1e3
        print(f"timing {name}, {n} bases k={K}: {ms:.6f} ms, "
              f"{BYTES_PER_BASE[name]} B/base, {rate / 1e12:.3f} TB/s, "
              f"{rate / copy_rate:.4f} of K4's copy rate [{card}]",
              flush=True)
    for m in (16, 8):
        ms, k1, raw, _ = routes[m]
        kernel_ms, plain_ms = timed[f"sliding_pack_p{m}"][:2]
        print(f"timing the P{m} route (K3, lanes, combine_lanes) to int64 "
              f"rows: {ms:.6f} ms against K1's {k1:.6f} ms, outputs equal; "
              f"K3 P{m} alone {kernel_ms:.6f} ms (plain {plain_ms:.6f} ms), "
              f"so the derivation takes {ms - kernel_ms:.6f} ms; "
              f"route,route,K1,K1 = {raw} [{card}]", flush=True)
    return {name: {"ms": t[0], "plain_ms": t[1], **bounds[name],
                   "library_ms": library.get(name)}
            for name, t in timed.items()}


def probe_inputs(dev, gen, n_q, block_q, n_cmp, n_entries,
                 n_cold=COLD_BUFFERS) -> dict:
    """Seeded inputs of the three probes at bench_primitives.py's shapes:
    n_q int32 indices into a (PROBE_ROWS, PROBE_COLS) int32 table of
    values < 2^30 (K6, K7), and ``n_cold`` such index buffers for the
    timings (``cold``; the first is ``idx``); n_cmp queries as
    (n_cmp / 128, 128) lo and hi against n_entries table keys (K8), where
    every 16th entry repeats its predecessor's key with its own node and a
    quarter of the queries take a table entry's key, so that counts above
    1 and the first-match rule are exercised."""
    rows, cols = primitives.PROBE_ROWS, primitives.PROBE_COLS

    def ints(hi, shape):
        return torch.randint(0, hi, shape, dtype=torch.int32, device=dev,
                             generator=gen)

    tlo, thi = ints(1 << 31, (n_entries,)), ints(1 << 30, (n_entries,))
    tlo[1::16], thi[1::16] = tlo[0::16][:tlo[1::16].shape[0]], \
        thi[0::16][:thi[1::16].shape[0]]
    qlo, qhi = ints(1 << 31, (n_cmp // 128, 128)), ints(1 << 30,
                                                        (n_cmp // 128, 128))
    at = torch.randperm(n_cmp, device=dev, generator=gen)[:n_cmp // 4]
    pick = torch.randint(0, n_entries, at.shape, device=dev, generator=gen)
    qlo.view(-1)[at], qhi.view(-1)[at] = tlo[pick], thi[pick]
    cold = [ints(rows, (n_q,)) for _ in range(n_cold)]
    return dict(idx=cold[0], cold=cold, table=ints(1 << 30, (rows, cols)),
                block_q=block_q,
                cmp=(qlo, qhi, tlo, thi, ints(1 << 20, (n_entries,))))


def skewed(idx: torch.Tensor, value: int) -> torch.Tensor:
    """``idx`` with every second index set to ``value``: half of a warp's
    increments then land on one counter."""
    out = idx.clone()
    out[::2] = value
    return out


def probe_edge_cases(p, gen) -> dict:
    """{name: (idx, block_q, table)}: index sets that the designs of K6 and
    K7 make risky. ``outside``: an eighth of the indices below 0 or past
    the table. ``ragged``: an offset slice (its base is not 16-byte
    aligned) cut in blocks that are no whole 16-byte vectors. ``skewed``:
    half of the indices one value. ``narrow``: a table of 300 rows of 3
    columns (rows that are no whole vectors either). ``tall``: one column
    of as many rows as the shared memory takes."""
    idx, table, block_q = p["idx"], p["table"], p["block_q"]
    rows, n = table.shape[0], idx.shape[0]

    def ints(lo, hi, size):
        return torch.randint(lo, hi, (size,), dtype=torch.int32,
                             device=idx.device, generator=gen)

    odd_block = max(1, block_q // 8 - 3)
    if odd_block % 4 == 0:
        odd_block += 1
    tall = primitives.SHARED_BYTES // 4
    return {
        "outside": (ints(-rows // 16, rows + rows // 16, n), block_q, table),
        "ragged": (ints(0, rows, odd_block * 997 + 1)[1:], odd_block, table),
        "skewed": (skewed(idx, rows // 3), block_q, table),
        "narrow": (ints(-5, 305, odd_block * 64), odd_block,
                   table[:300, :3].contiguous()),
        "tall": (ints(-5, tall + 5, odd_block * 64), odd_block,
                 ints(0, 1 << 30, tall).view(tall, 1))}


def check_probe_edges(p, gen) -> int:
    """K6 and K7 against their twins (exact) on probe_edge_cases, and K7
    called again on its first input after another one: the two tables must
    be equal (a stale scratch or an output that was not zeroed shows
    here). Returns the max abs difference (0)."""
    err = 0
    cases = probe_edge_cases(p, gen)
    for name, (idx, block_q, table) in cases.items():
        n_c, cols = table.shape
        err = max(err, assert_equal(
            primitives.gather_loop(idx, table, block_q),
            primitives.gather_loop_plain(idx, table, block_q),
            f"K6 on the {name} indices"))
        for c in (cols, 1):
            err = max(err, assert_equal(
                primitives.rmw_loop(idx, n_c, c),
                primitives.rmw_loop_plain(idx, n_c, c),
                f"K7 on the {name} indices, {c} columns"))
    first = primitives.rmw_loop(p["idx"])
    primitives.rmw_loop(cases["skewed"][0])
    err = max(err, assert_equal(primitives.rmw_loop(p["idx"]), first,
                                "K7 called again on its first input"))
    sizes = {name: (case[0].shape[0], case[1]) for name, case in
             cases.items()}
    print(f"K6 and K7 == plain (exact) on (indices, block) {sizes}; K7 "
          f"called again == its first table", flush=True)
    return err


def first_queries(read_kmers, n: int) -> torch.Tensor:
    """The first ``n`` read k-mers of a DeviceReadKmers batch."""
    parts, have = [], 0
    for seg in read_kmers.segments:
        if have >= n:
            break
        parts.append(seg[:n - have])
        have += parts[-1].shape[0]
    return torch.cat(parts)


def lookup_path(dev, card, state, probes, modulo, n_get, gen) -> dict:
    """The CSR lookup path through the functions a user calls: a CSR
    index (KmerIndex.from_rows) over the main path's rows at ``modulo``,
    ref offset = row position, seeded float32 allele frequencies;
    map_kmers / has_kmers over every read k-mer with the packed budget at
    0; get_batched on the first ``n_get`` read k-mers through a view on
    the searchsorted route and one on the tables route (its budget
    raised); the get API on the same queries; and the three probes on
    ``probes``. Returns every output."""
    st = Stages(dev, card)
    rows = state["index"]
    n = rows.kmers.shape[0]
    afs = torch.rand(n, generator=gen, device=dev)
    csr = st.run("CSR index build (from_rows: layout + set_frequencies)",
                 KmerIndex.from_rows, rows.kmers, rows.nodes,
                 torch.arange(n, device=dev), afs, modulo, device=dev)
    csr.device_index.PACKED_BYTE_BUDGET = 0
    out = dict(csr=csr, afs=afs, modulo=modulo, probes=probes)
    read_kmers, n_nodes = state["read_kmers"], state["n_nodes"]
    out["counts"] = st.run("CSR map_kmers", csr.map_kmers, read_kmers,
                           n_nodes)
    out["member"] = st.run("CSR has_kmers", csr.has_kmers, read_kmers)

    default_route = ("tables" if csr.device_index._bucket_tables_cheap()
                     else "searchsorted")
    # the searchsorted route serves an index whose bucket tables are not
    # on the device and too large to move: here, the rows alone
    searched = lookup.DeviceKmerIndex(KmerIndex(
        csr.kmers, csr.nodes, modulo, ref_offsets=csr.ref_offsets,
        frequencies=csr.frequencies,
        allele_frequencies=csr.allele_frequencies, dtypes=csr.dtypes))
    searched.BUCKET_TABLE_BYTE_BUDGET = 0
    tabled = lookup.DeviceKmerIndex(csr)
    tabled.BUCKET_TABLE_BYTE_BUDGET = 1 << 62
    if searched._bucket_tables_cheap() or not tabled._bucket_tables_cheap():
        raise AssertionError("the two get_batched views share a route")
    q = first_queries(read_kmers, n_get)
    print(f"CSR index: {n} rows at modulo {modulo}, max bucket "
          f"{tabled.max_scan}; get_batched's default route: "
          f"{default_route} (tables that the build left on the device are "
          f"taken as they are; to move them the budget counts 12 B per "
          f"bucket, {12 * modulo} bytes, against "
          f"{lookup.DeviceKmerIndex.BUCKET_TABLE_BYTE_BUDGET})", flush=True)
    out.update(q=q, searched=searched, tabled=tabled,
               default_route=default_route)
    out["get_searched"] = st.run("get_batched (searchsorted route)",
                                 searched.get_batched, q)
    out["get_tables"] = st.run("get_batched (tables route)",
                               tabled.get_batched, q)
    if "starts_tbl" in searched._cache or "starts_tbl" not in tabled._cache:
        raise AssertionError("a get_batched view took the other's route")
    out["get_api"] = st.run(
        "get_nodes_and_ref_offsets_from_multiple_kmers",
        csr.get_nodes_and_ref_offsets_from_multiple_kmers, q, GET_MAX_HITS)

    out["gather"] = st.run("gather_loop (K6)", primitives.gather_loop,
                           probes["idx"], probes["table"], probes["block_q"])
    out["rmw"] = st.run("rmw_loop (K7)", primitives.rmw_loop, probes["idx"])
    out["cmp"] = st.run("bcast_cmp (K8)", primitives.bcast_cmp,
                        *probes["cmp"])
    return out


def join_rows(state, lk, sample, hit_cap, freq_cap) -> torch.Tensor:
    """get_batched's rows for the queries ``q[sample]`` by a join that
    shares no code with the index: the main path's rows sorted by k-mer,
    each query matched by searchsorted, its bucket size counted in the
    sorted buckets of every row, then the caps. A k-mer's rows keep
    their row order, which is the CSR index's order within a bucket;
    ref offsets are row positions, so a k-mer's frequency is its number
    of rows (in 16 bits)."""
    kmers, nodes = state["index"].kmers, state["index"].nodes
    modulo = lk["modulo"]
    q = lk["q"][sample]
    sk, perm = torch.sort(kmers, stable=True)
    left = torch.searchsorted(sk, q)
    cnt = torch.searchsorted(sk, q, right=True) - left
    del sk
    buckets = torch.sort(kmers % modulo).values
    qb = q % modulo
    bsize = (torch.searchsorted(buckets, qb, right=True)
             - torch.searchsorted(buckets, qb))
    del buckets
    freq = cnt & 0xFFFF
    cnt = torch.where((bsize <= hit_cap) & (freq <= freq_cap), cnt, 0)
    owner = torch.repeat_interleave(torch.arange(q.shape[0], device=q.device),
                                    cnt)
    first = torch.cumsum(cnt, 0) - cnt
    rows = perm[left[owner] + torch.arange(owner.shape[0],
                                           device=q.device) - first[owner]]
    return torch.stack([nodes[rows], rows, sample[owner], freq[owner],
                        (lk["afs"][rows] * 1000).to(torch.int64)])


def check_lookup(dev, state, lk, n_sample, gen) -> dict:
    """The lookup path's outputs: CSR counts and membership equal to the
    packed path's, both get_batched routes equal to each other and to
    join_rows on a sample of queries, the get API's rows equal to the
    uncapped rows of frequency <= GET_MAX_HITS, each probe equal to its
    twin, K6 and K7 also on check_probe_edges' inputs. Returns each
    probe's error fields for the kernels line."""
    if not (np.array_equal(lk["counts"], state["counts"])
            and np.array_equal(lk["member"], state["member"])):
        raise AssertionError("CSR counts or membership differ from the "
                             "packed path's")
    got = lk["get_searched"]
    assert_equal(got, lk["get_tables"], "get_batched: searchsorted route "
                 "against the tables route")
    q = lk["q"]
    sample = torch.sort(torch.randperm(q.shape[0], device=dev,
                                       generator=gen)[:n_sample]).values
    want = join_rows(state, lk, sample, lookup.DEFAULT_HIT_CAP,
                     lookup.DEFAULT_FREQUENCY_CAP)
    assert_equal(got[:, torch.isin(got[2], sample)], want,
                 f"get_batched against the join on {n_sample} queries")
    full = lk["tabled"].get_batched(q, hit_cap=CAPS_OFF,
                                    frequency_cap=CAPS_OFF)
    keep = full[:, full[3] <= GET_MAX_HITS].cpu().numpy()
    nodes, offs, qi, freqs = lk["get_api"]
    if not (np.array_equal(nodes, keep[0]) and np.array_equal(offs, keep[1])
            and np.array_equal(qi, keep[2].astype(np.float64))
            and np.array_equal(freqs, keep[3].astype(np.uint16))
            and freqs.dtype == np.uint16 and qi.dtype == np.float64):
        raise AssertionError("the get API's rows differ from get_batched's")
    csr = lk["csr"]
    picks = q[sample[:20]].tolist()
    member = lk["member"]
    if any((kmer in csr) != bool(member[int(i)])
           for kmer, i in zip(picks, sample[:20].tolist())):
        raise AssertionError("KmerIndex.__contains__ differs from has_kmers")

    p = lk["probes"]
    errs = {"gather_loop": assert_equal(
        lk["gather"], primitives.gather_loop_plain(p["idx"], p["table"],
                                                   p["block_q"]),
        "K6 against its twin"),
        "rmw_loop": assert_equal(lk["rmw"], primitives.rmw_loop_plain(
            p["idx"]), "K7 against its twin"),
        "bcast_cmp": assert_equal(lk["cmp"], primitives.bcast_cmp_plain(
            *p["cmp"]), "K8 against its twin")}
    edge_err = check_probe_edges(p, gen)
    for name in ("gather_loop", "rmw_loop"):
        errs[name] = max(errs[name], edge_err)
    cnt = lk["cmp"][1]
    if int(cnt.max()) < 2 or not bool((cnt == 1).any()):
        raise AssertionError("K8's inputs hold no single and no repeated "
                             "match")
    print(f"CSR counts and membership == the packed path's on "
          f"{lk['member'].shape[0]} read k-mers; get_batched: searchsorted "
          f"route == tables route ({got.shape[1]} rows for {q.shape[0]} "
          f"queries), == the join on {n_sample} sampled queries "
          f"({want.shape[1]} rows); the get API (max_hits {GET_MAX_HITS}) "
          f"== the uncapped rows of frequency <= {GET_MAX_HITS} "
          f"({nodes.shape[0]} rows); K6, K7 and K8 == plain (exact), K8 "
          f"with up to {int(cnt.max())} matches per query", flush=True)
    return {name: {"max_abs_err": err} for name, err in errs.items()}


def probe_calls(table, block_q) -> dict:
    """{probe: (kernel(idx), plain(idx))} of K6 and K7 on ``table``."""
    rows, cols = table.shape
    return {
        "gather_loop": (
            lambda idx: primitives.gather_loop(idx, table, block_q),
            lambda idx: primitives.gather_loop_plain(idx, table, block_q)),
        "rmw_loop": (lambda idx: primitives.rmw_loop(idx, rows, cols),
                     lambda idx: primitives.rmw_loop_plain(idx, rows, cols))}


def probe_bounds(n_idx, table, block_q) -> dict:
    """K6 reads the indices and column 0 and writes a sum per block; K7
    reads the indices and writes the whole counts table."""
    rows, cols = table.shape
    return {
        "gather_loop": bound(4 * n_idx + 4 * rows + 4 * (n_idx // block_q)),
        "rmw_loop": bound(4 * n_idx + 4 * rows * cols)}


def time_probes(dev, card, p, reps=100) -> dict:
    """K6, K7 and K8 against their twins; returns {probe: the kernels
    line's timed fields}. ``ms`` of K6 and K7 is the device's own time
    for one call (device_time: for K7 it covers the zeroing of the table,
    whoever does it) on cold indices, the launches rotating over
    p["cold"]; ``warm_ms`` the same on one buffer, ``host_call_ms`` the
    host's cost of a wrapper call, ``events_ms`` what CUDA events around
    ``reps`` Python calls read (the earlier method: the slower of host
    and device). K8's ``ms`` stays by events (reps // 10 launches), with
    ``device_ms`` and ``host_call_ms`` beside it. Every timed call's
    output is compared with the twin's; bincount beside K7 as the one
    PyTorch call that computes its counts (no one call computes K6's
    wrapping block sums or K8's count and first node)."""
    cold, table, block_q = p["cold"], p["table"], p["block_q"]
    rows = table.shape[0]
    n_idx = cold[0].shape[0]
    n_cmp, n_entries = p["cmp"][0].numel(), p["cmp"][2].shape[0]
    rounds = max(1, reps // len(cold))
    probes = probe_calls(table, block_q)
    idx64 = cold[0].to(torch.int64)
    library = {"rmw_loop": time_one(
        dev, lambda: torch.bincount(idx64, minlength=rows), reps)}
    # K8 reads and writes two int32 per query and the table's three columns
    bounds = {**probe_bounds(n_idx, table, block_q),
              "bcast_cmp": bound(16 * n_cmp + 12 * n_entries,
                                 CMP_OPS * n_cmp * n_entries)}
    out = {}
    for (name, (kernel, plain)), unit in zip(probes.items(),
                                             ("gathers", "increments")):
        for i, idx in enumerate(cold):
            assert_equal(kernel(idx), plain(idx),
                         f"{name} timed, cold buffer {i}")
        cold_ms, parts = device_time(
            dev, [lambda idx=idx: kernel(idx) for idx in cold], rounds)
        warm_ms, _ = device_time(dev, [lambda: kernel(cold[0])],
                                 rounds * len(cold))
        host_ms = host_call_time(dev, lambda: kernel(cold[0]), reps)
        events_ms = time_one(dev, lambda: kernel(cold[0]), reps)
        plain_ms = time_one(dev, lambda: plain(cold[0]), max(1, reps // 10))
        lib_ms = library.get(name)
        out[name] = {"ms": cold_ms, "plain_ms": plain_ms, **bounds[name],
                     "library_ms": lib_ms, "warm_ms": warm_ms,
                     "host_call_ms": host_ms, "events_ms": events_ms}
        bound_ms = bounds[name]["bound_ms"]
        print(f"timing {name}: device clock, cold indices ({len(cold)} "
              f"buffers of {n_idx} in turn) {cold_ms:.6f} ms "
              f"({n_idx / cold_ms / 1e6:.3f} G {unit}/s), warm (one buffer) "
              f"{warm_ms:.6f} ms; by kernel {parts}; host cost of a call "
              f"{host_ms:.6f} ms; CUDA events around {reps} Python calls "
              f"{events_ms:.6f} ms; plain {plain_ms:.6f} ms; bound "
              f"{bound_ms:.6f} ms by {bounds[name]['bound_by']} "
              f"({bound_ms / cold_ms:.4f} of the cold time); one PyTorch "
              f"call {'(bincount) %.6f ms' % lib_ms if lib_ms else 'none'} "
              f"[{card}]", flush=True)

    def cmp_kernel():
        return primitives.bcast_cmp(*p["cmp"])

    ms, plain_ms, raw, _ = time_pair(
        dev, cmp_kernel, lambda: primitives.bcast_cmp_plain(*p["cmp"]),
        max(1, reps // 10), "K8 timed")
    device_ms, _ = device_time(dev, [cmp_kernel], max(1, reps // 10))
    host_ms = host_call_time(dev, cmp_kernel, max(1, reps // 10))
    items = n_cmp * n_entries
    out["bcast_cmp"] = {"ms": ms, "plain_ms": plain_ms,
                        **bounds["bcast_cmp"], "library_ms": None,
                        "device_ms": device_ms, "host_call_ms": host_ms}
    print(f"timing bcast_cmp: kernel {ms:.6f} ms by CUDA events "
          f"({items / ms / 1e6:.3f} G compares/s), {device_ms:.6f} ms by the "
          f"device's clock, host cost of a call {host_ms:.6f} ms; plain "
          f"{plain_ms:.6f} ms; bound {bounds['bcast_cmp']['bound_ms']:.6f} "
          f"ms by {bounds['bcast_cmp']['bound_by']}, one PyTorch call none; "
          f"kernel,kernel,plain,plain = {raw} [{card}]", flush=True)
    return out


def time_lookup(dev, card, state, lk, reps=100) -> dict:
    """The probes (time_probes), the CSR map/has against the packed
    path's and the two get_batched routes against each other; every timed
    output is compared. Prints the rates; returns {probe: the kernels
    line's timed fields}."""
    timed = time_probes(dev, card, lk["probes"], reps)

    csr, packed = lk["csr"].device_index, state["index"].device_index
    read_kmers, n_nodes = state["read_kmers"], state["n_nodes"]
    n_q = len(read_kmers)
    pairs = {
        "map_kmers": (lambda: csr.map_read_kmers(read_kmers, n_nodes),
                      lambda: packed.map_read_kmers(read_kmers, n_nodes)),
        "has_kmers": (lambda: csr.has_read_kmers(read_kmers),
                      lambda: packed.has_read_kmers(read_kmers))}
    for name, (csr_fn, packed_fn) in pairs.items():
        ms, packed_ms, raw, _ = time_pair(dev, csr_fn, packed_fn, 1,
                                          f"CSR {name} timed")
        print(f"timing {name} on {n_q} read k-mers: CSR {ms:.6f} ms "
              f"({n_q / ms / 1e6:.3f} G queries/s), packed {packed_ms:.6f} "
              f"ms ({n_q / packed_ms / 1e6:.3f} G queries/s); csr,csr,"
              f"packed,packed = {raw} [{card}]", flush=True)
    q = lk["q"]
    ms, ms_s, raw, _ = time_pair(
        dev, lambda: lk["tabled"].get_batched(q),
        lambda: lk["searched"].get_batched(q), 3, "get_batched routes timed")
    print(f"timing get_batched on {q.shape[0]} queries: tables route "
          f"{ms:.6f} ms ({q.shape[0] / ms / 1e6:.3f} G queries/s), "
          f"searchsorted route {ms_s:.6f} ms "
          f"({q.shape[0] / ms_s / 1e6:.3f} G queries/s); tables,tables,"
          f"searchsorted,searchsorted = {raw} [{card}]", flush=True)
    return timed


def profile_lookup(dev, card, state, path, csr=None):
    """torch.profiler over a second call of map_kmers and of has_kmers
    (and, given the lookup path's CSR index, of its CSR map/has): per
    call, one summary line on stdout (host wall ms, the profiler's
    self-time totals, the number of read segments and of host waits for
    the device: the ops that wait, by name, the runtime's synchronize
    calls and the copies to the host, of which the largest count is the
    call's; and the K2, nonzero and device-to-host copy rows) and the
    operator table in ``path``. Returns {call: host syncs}."""
    from torch.profiler import ProfilerActivity, profile

    index, read_kmers = state["index"], state["read_kmers"]
    calls = {"map_kmers": lambda: index.map_kmers(read_kmers,
                                                  state["n_nodes"]),
             "has_kmers": lambda: index.has_kmers(read_kmers)}
    if csr is not None:
        calls["CSR map_kmers"] = lambda: csr.map_kmers(read_kmers,
                                                       state["n_nodes"])
        calls["CSR has_kmers"] = lambda: csr.has_kmers(read_kmers)
    n_seg = len(read_kmers.segments)
    syncs = {}
    with open(path, "w") as out:
        for name, fn in calls.items():
            sync(dev)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                sync(dev)
                wall_ms = (time.perf_counter() - t0) * 1e3
            table = prof.key_averages().table(
                sort_by="self_cuda_time_total", row_limit=30,
                max_name_column_width=60)
            out.write(f"== {name}: wall {wall_ms:.3f} ms [{card}]\n{table}\n")
            totals = [line.strip() for line in table.splitlines()
                      if line.startswith("Self ") and "time total" in line]
            events = prof.key_averages()
            rows = [f"{e.key[:40]!r} x{e.count} {_device_us(e):.1f} us"
                    for e in events
                    if "packed_lookup" in e.key or e.key == "aten::nonzero"
                    or e.key.startswith("Memcpy DtoH")]
            by_name = {op: sum(e.count for e in events if e.key == op)
                       for op in SYNC_OPS}
            # the same waits seen from below, which also shows one hidden
            # in another op (unique, a copy to the host): the runtime's
            # synchronize calls, less the one that ends this profile
            waits = {e.key: e.count for e in events
                     if e.key.startswith("cuda")
                     and e.key.endswith("Synchronize")}
            copies = sum(e.count for e in events
                         if e.key.startswith("Memcpy DtoH"))
            # item calls _local_scalar_dense: one wait, two names
            syncs[name] = max(by_name["aten::nonzero"]
                              + by_name["aten::_local_scalar_dense"],
                              sum(waits.values()) - 1, copies)
            print(f"profile {name}: wall {wall_ms:.3f} ms; "
                  f"{'; '.join(totals)}; host syncs {syncs[name]} over "
                  f"{n_seg} read segments {by_name}, runtime waits {waits} "
                  f"(one is this profile's own), copies to the host "
                  f"{copies}; self device time: {', '.join(rows)} [{card}]",
                  flush=True)
    return syncs


def require_native() -> None:
    """The build path walks the graph in the native library or not at all."""
    if not native.available():
        raise AssertionError("the native host library did not build or "
                             f"load: {native.build_error()}")
    print(f"native host library: {Path(native.library_path()).name} (g++, "
          "from csrc/host/gki.cpp and walker.cpp)", flush=True)


def device_busy_seconds(prof) -> float:
    """Seconds the card was busy inside a torch.profiler run: the device
    time of everything it ran."""
    from torch.autograd import DeviceType

    return sum(_device_us(e) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e6


def streamed_find(dev, graph, cpaths, n_workers, mp_context, stats):
    """find_kmers_parallel_device with the native walker required; on a
    CUDA device under torch.profiler (device activity only), so that the
    card's busy time inside the find can be read. Returns (FlatKmers,
    wall seconds, busy seconds or None)."""
    def find():
        flat = find_kmers_parallel_device(
            graph, K, n_workers=n_workers, critical_paths=cpaths,
            stream_rows_target=STREAM_TARGET,
            stream_tape_target=STREAM_TARGET, mp_context=mp_context,
            device=dev, require_native=True, stats=stats)
        sync(dev)
        return flat

    sync(dev)
    t0 = time.perf_counter()
    if dev.type != "cuda":
        return find(), time.perf_counter() - t0, None
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        flat = find()
    seconds = time.perf_counter() - t0
    return flat, seconds, device_busy_seconds(prof) or None


def sample_reference_reads(graph, n_reads, rng) -> np.ndarray:
    """(n_reads, READ_LEN) int8 reads at uniform positions of the graph's
    linear reference."""
    refseq = graph.linear_ref_sequence()[2]
    starts = rng.integers(0, len(refseq) - READ_LEN, n_reads)
    return refseq[starts[:, None] + np.arange(READ_LEN)].astype(np.int8)


def build_path(dev, card, args, n_workers=BUILD_WORKERS, mp_context="spawn",
               modulo=REF_MODULO) -> dict:
    """The build path at the requested scale, through the functions a user
    calls: graph -> critical paths -> streamed find (rows left on the
    device) -> index with frequencies -> packed table -> read mapping.
    Returns its state."""
    st = Stages(dev, card)
    t0 = time.perf_counter()
    graph, variant_to_nodes = synthetic.random_snp_graph(
        args.build_bases, args.build_variants, seed=args.seed,
        indel_fraction=0.1)
    st.report("graph build (host)", time.perf_counter() - t0,
              f", {args.build_bases} bases, {args.build_variants} variants, "
              f"{graph.n_nodes()} nodes")
    t0 = time.perf_counter()
    cpaths = CriticalGraphPaths.from_graph(graph, K)
    st.report("critical paths (host)", time.perf_counter() - t0,
              f", {len(cpaths)} paths")

    stats = {}
    flat, t_find, busy = streamed_find(dev, graph, cpaths, n_workers,
                                       mp_context, stats)
    n_rows = len(flat)
    idle = ("not measured" if busy is None else
            f"{1 - busy / t_find:.6f} (busy {busy:.6f} s)")
    st.report("streamed find (host walk + device finalize)", t_find,
              f", {n_rows} rows, {n_rows / t_find:.1f} rows/s, "
              f"{args.build_bases / t_find:.1f} bases/s, "
              f"{stats['groups']} groups flushed in "
              f"{stats['flush_seconds']:.6f} s of the pool loop, "
              f"{n_workers} workers ({mp_context}), first chunk back after "
              f"{stats['first_result_seconds']:.6f} s (worker start-up and "
              f"one chunk's walk), device idle share {idle}")

    index = st.run("index build (from_flat_kmers: layout + frequencies)",
                   KmerIndex.from_flat_kmers, flat, modulo, device=dev)
    del flat
    tables = st.run("packed table build", index.device_index.packed)
    if tables is None:
        raise AssertionError("the packed records exceed the device's "
                             "budget: map_kmers would not take K2")
    print(f"built index: {n_rows} rows at modulo {modulo}, modulo2 "
          f"{tables.modulo2}, records {tables.records.numel() * 4} bytes, "
          f"max bucket {tables.max_sz}", flush=True)

    n_nodes = graph.n_nodes()
    reads = sample_reference_reads(graph, args.build_reads,
                                   np.random.default_rng(args.seed + 1))

    def map_reads():
        tape = torch.from_numpy(reads.reshape(-1)).to(dev)
        starts = torch.arange(len(reads), device=dev) * READ_LEN
        lens = torch.full((len(reads),), READ_LEN, device=dev)
        hashes, _ = encode.read_tape_hashes(tape, starts, lens,
                                            tape.shape[0], K)
        queries = DeviceReadKmers([hashes], K)
        return queries, index.map_kmers(queries, n_nodes)

    sync(dev)
    t0 = time.perf_counter()
    queries, counts = map_reads()
    t_map = time.perf_counter() - t0
    st.report("read mapping (hash + map_kmers)", t_map,
              f", {len(queries)} query k-mers, "
              f"{len(queries) / t_map:.1f} k-mers/s, "
              f"{int(counts.sum()) / max(1, len(queries)):.4f} hits a query")
    return dict(graph=graph, variant_to_nodes=variant_to_nodes, index=index,
                tables=tables, stats=stats, cpaths=cpaths, reads=reads,
                n_rows=n_rows, n_nodes=n_nodes, queries=queries,
                counts=counts)


def check_build(dev, b, launches, gen) -> int:
    """The build path's results: the row count against the spans' own
    total, the node counts against join_counts, the path's launches, and
    K1 against its twin on a tape of the largest group's length. Returns
    K1's max abs difference (0)."""
    stats = b["stats"]
    if b["n_rows"] != stats["span_rows"] or b["n_rows"] == 0:
        raise AssertionError(f"{b['n_rows']} rows, but the spans hold "
                             f"{stats['span_rows']} (windows x nodes)")
    index = b["index"]
    queries = torch.cat(b["queries"].segments)
    want = join_counts(index.kmers, index.nodes, queries, b["n_nodes"])
    counts = torch.from_numpy(b["counts"]).to(dev)
    if counts.shape != (b["n_nodes"],) or not torch.equal(counts, want):
        raise AssertionError("the build path's node counts differ from the "
                             "join")
    hits = int(counts.sum())
    if hits < queries.shape[0]:
        raise AssertionError(f"{hits} hits for {queries.shape[0]} k-mers of "
                             "reference reads: every one is in the graph")
    require_launches(launches, BUILD_KERNELS, "build path")
    if launches["sliding_hash"] < stats["groups"] + 1:
        raise AssertionError("K1 was not launched once a span group")
    n = max(stats["tape_bases"])
    tape = torch.randint(0, 4, (n,), dtype=torch.int8, device=dev,
                         generator=gen)
    err = assert_equal(encode.sliding_hashes(tape, K),
                       encode.sliding_hashes_plain(tape, K),
                       f"K1 on a tape of {n} bases")
    print(f"build path: {b['n_rows']} rows == the spans' windows x nodes; "
          f"node counts == join ({hits} hits of {queries.shape[0]} read "
          f"k-mers over {b['n_nodes']} nodes); K1 == plain (bit-exact) on a "
          f"tape of {n} bases, the largest of {stats['groups']} groups",
          flush=True)
    return err


def numpy_index_build(kmers, ref_offsets, modulo):
    """(bucket starts, bucket sizes, frequencies of the rows in bucket
    order) of an index over these rows, in numpy and by other means than
    the port's: buckets by np.unique over the stably sorted bucket column,
    a k-mer's frequency as its number of distinct (k-mer, ref offset)
    pairs, counted through dense ids."""
    order = np.argsort(kmers % np.uint64(modulo), kind="stable")
    km, ro = kmers[order], ref_offsets[order]
    buckets, first, size = np.unique((km % np.uint64(modulo)).astype(
        np.int64), return_index=True, return_counts=True)
    starts = np.zeros(modulo, dtype=np.int64)
    sizes = np.zeros(modulo, dtype=np.int64)
    starts[buckets], sizes[buckets] = first, size
    kid = np.unique(km, return_inverse=True)[1].astype(np.int64)
    offsets, rid = np.unique(ro, return_inverse=True)
    pairs = np.unique(kid * len(offsets) + rid)
    distinct = np.bincount(pairs // len(offsets), minlength=kid.max() + 1)
    return starts, sizes, (distinct[kid] & 0xFFFF).astype(np.uint16)


def check_build_small(dev, card, args, n_workers=BUILD_WORKERS,
                      mp_context="spawn", modulo=CHECK_MODULO) -> None:
    """On a graph of ``--check-bases`` bases from the same generator: the
    four columns of find_kmers_parallel_device on the device against
    find_kmers_parallel on the host (the native finalize_rows route), bit
    for bit, and the index built from the device's rows against
    numpy_index_build."""
    st = Stages(dev, card)
    graph, _ = synthetic.random_snp_graph(
        args.check_bases, max(1, args.check_bases // 250),
        seed=args.seed + 2, indel_fraction=0.1)
    cpaths = CriticalGraphPaths.from_graph(graph, K)
    t0 = time.perf_counter()
    host = find_kmers_parallel(graph, K, n_workers, critical_paths=cpaths,
                               mp_context=mp_context, require_native=True)
    st.report("small graph: host find (native finalize_rows)",
              time.perf_counter() - t0, f", {len(host)} rows")
    stats = {}
    # small stream targets, so that several groups are joined
    t0 = time.perf_counter()
    flat = find_kmers_parallel_device(
        graph, K, n_workers=n_workers, critical_paths=cpaths,
        stream_rows_target=max(1, len(host) // 5),
        stream_tape_target=STREAM_TARGET, mp_context=mp_context, device=dev,
        require_native=True, stats=stats)
    sync(dev)
    st.report("small graph: streamed find", time.perf_counter() - t0,
              f", {len(flat)} rows in {stats['groups']} groups")
    columns = {"hashes": (flat._hashes, host._hashes, np.uint64),
               "nodes": (flat._nodes, host._nodes, np.uint32),
               "ref_offsets": (flat._ref_offsets, host._ref_offsets,
                               np.uint64),
               "allele_frequencies": (flat._allele_frequencies,
                                      host._allele_frequencies, np.float32)}
    for name, (got, want, dtype) in columns.items():
        got = got.cpu().numpy()
        if got.itemsize != np.dtype(dtype).itemsize:
            raise AssertionError(f"{name}: {got.dtype} on the device")
        if want.dtype != dtype or not np.array_equal(got.view(dtype), want):
            raise AssertionError(f"the device's {name} differ from the "
                                 "host's")
    index = KmerIndex.from_flat_kmers(flat, modulo, device=dev)
    starts, sizes, freqs = numpy_index_build(host._hashes,
                                             host._ref_offsets, modulo)
    got = {"hashes_to_index": (index.hashes_to_index, starts),
           "n_kmers": (index.n_kmers, sizes),
           "frequencies": (index.frequencies, freqs)}
    for name, (tensor, want) in got.items():
        if not np.array_equal(tensor.cpu().numpy().astype(np.int64), want):
            raise AssertionError(f"the built index's {name} differ from the "
                                 "numpy build's")
    print(f"small graph ({args.check_bases} bases, {graph.n_nodes()} nodes): "
          f"the device's four columns == the host's (bit for bit) on "
          f"{len(host)} rows in {stats['groups']} groups; the built index's "
          f"hashes_to_index, n_kmers (modulo {modulo}) and frequencies "
          f"(max {int(freqs.max())}) == a numpy build", flush=True)


def profiled(dev, fn):
    """(fn(), wall seconds, seconds the card was busy inside it or None):
    on a CUDA device ``fn`` runs under torch.profiler (device activity
    only)."""
    sync(dev)
    t0 = time.perf_counter()
    if dev.type != "cuda":
        out = fn()
        return out, time.perf_counter() - t0, None
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        sync(dev)
    return out, time.perf_counter() - t0, device_busy_seconds(prof) or None


def columns_of(flat) -> dict:
    return {name: np.asarray(getattr(flat, "_" + name))
            for name in ("hashes", "nodes", "ref_offsets",
                         "allele_frequencies")}


def assert_columns_equal(got: dict, want: dict, what: str) -> None:
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: columns {sorted(got)} != "
                             f"{sorted(want)}")
    for name, a in want.items():
        b = got[name]
        if np.ndim(a) == 0 or np.ndim(b) == 0:
            equal = np.ndim(a) == np.ndim(b) and a == b
        else:
            equal = (np.asarray(a).dtype == np.asarray(b).dtype
                     and np.array_equal(a, b))
        if not equal:
            raise AssertionError(f"{what}: {name} differs")


def signature_path(dev, card, args, built, workdir,
                   modulo=SIGNATURE_MODULO) -> dict:
    """The signature path over the build path's graph and index, through
    the classes a user calls: reference + variants -> graph -> sweep ->
    batched selection -> signature index -> the other indexes -> bundle on
    disk and back -> read counts. Returns its state."""
    st = Stages(dev, card)
    scoring = built["index"]
    t0 = time.perf_counter()
    reference, variants = synthetic.reference_and_variants(
        built["graph"], built["variant_to_nodes"])
    st.report("reference and variants (host, set-up)",
              time.perf_counter() - t0,
              f", {len(reference)} bases, {len(variants)} variants")
    t0 = time.perf_counter()
    graph, v2n = build_graph_from_vcf({"1": reference}, variants)
    del reference
    st.report("graph from variants (build_graph_from_vcf, host)",
              time.perf_counter() - t0, f", {graph.n_nodes()} nodes")

    before = _kernels.launch_counts["sliding_hash"]
    finder = SnpKmerFinder(graph, k=K, spacing=SWEEP_SPACING, device=dev,
                           **SWEEP_CAPS)
    swept, t_sweep, busy = profiled(dev, finder.find_kmers)
    sweep_launches = _kernels.launch_counts["sliding_hash"] - before
    st.report("sweep (SnpKmerFinder.find_kmers)", t_sweep,
              f", {graph.linear_ref_length() // SWEEP_SPACING} positions, "
              f"{len(swept)} rows, {sweep_launches} K1 launch(es), device "
              "time inside it "
              + ("not measured" if busy is None else f"{busy:.6f} s"))

    selector = UniqueVariantKmersFinder(
        graph, v2n, variants, k=K,
        max_variant_nodes=SELECT_MAX_VARIANT_NODES,
        kmer_index_with_frequencies=scoring)
    signatures, t_select, busy = profiled(
        dev, selector.find_unique_kmers_batched)
    st.report("batched signature selection", t_select,
              f", {len(variants) / t_select:.1f} variants/s, "
              f"{len(signatures)} rows, n_batched_variants "
              f"{selector.n_batched_variants}, n_fallback_variants "
              f"{selector.n_fallback_variants}, n_zero_node_variants "
              f"{selector.n_zero_node_variants}, n_failed_variants "
              f"{selector.n_failed_variants}, device time inside it "
              + ("not measured" if busy is None else f"{busy:.6f} s"))

    index = st.run("signature index build (from_flat_kmers)",
                   KmerIndex.from_flat_kmers, signatures, modulo,
                   device=dev)

    def other_indexes():
        return {"ReverseKmerIndex": ReverseKmerIndex.from_flat_kmers(
                    signatures),
                "ReferenceKmerIndex": ReferenceKmerIndex.from_flat_kmers(
                    swept),
                "VariantNodesIndex": VariantNodesIndex.from_graph(graph)}

    others = st.run("reverse, reference and variant-nodes indexes (host)",
                    other_indexes)
    bundle = IndexBundle({"KmerIndex": index, "VariantToNodes": v2n,
                          **others})
    bundle_path = Path(st.run("bundle write (IndexBundle.to_file)",
                              bundle.to_file, Path(workdir) / "bundle"))
    n_bytes = bundle_path.stat().st_size
    loaded = st.run("bundle read (IndexBundle.from_file)",
                    IndexBundle.from_file, bundle_path, device=dev)
    print(f"bundle: {n_bytes} bytes on disk, entries "
          f"{sorted(loaded.indexes)}", flush=True)

    reads = sample_reference_reads(graph, args.build_reads,
                                   np.random.default_rng(args.seed + 3))
    reads_path = Path(workdir) / "signature_reads.fa"
    synthetic.write_fasta(reads_path, reads)
    served = loaded["KmerIndex"]
    n_nodes = graph.n_nodes()
    before = _kernels.launch_counts["packed_lookup"]

    def map_reads():
        kmers = hash_fasta_file(reads_path, K, device=dev,
                                include_reverse_complements=True)
        return kmers, served.map_kmers(kmers, n_nodes)

    sync(dev)
    t0 = time.perf_counter()
    queries, counts = map_reads()
    t_map = time.perf_counter() - t0
    map_launches = _kernels.launch_counts["packed_lookup"] - before
    st.report("reads -> counts (hash_fasta_file + map_kmers on the bundle's "
              "index)", t_map,
              f", {len(queries)} query k-mers, {int(counts.sum())} hits, "
              f"{map_launches} K2 launch(es)")
    return dict(graph=graph, v2n=v2n, variants=variants, swept=swept,
                selector=selector, signatures=signatures, index=index,
                bundle=bundle, loaded=loaded, queries=queries, counts=counts,
                n_nodes=n_nodes, scoring=scoring,
                sweep_launches=sweep_launches, map_launches=map_launches)


def check_signature(dev, card, built, sig, launches, n_sweep_sample,
                    n_frequency_sample, n_exact, rng) -> int:
    """The signature path's results, each check raising. Returns K1's max
    abs difference against its twin on the sweep's tape (0)."""
    st = Stages(dev, card)
    graph = sig["graph"]
    for name in GRAPH_ARRAYS:
        if not np.array_equal(getattr(graph, name),
                              getattr(built["graph"], name)):
            raise AssertionError(f"the graph from the variants differs from "
                                 f"the build path's in {name}")
    require_launches(launches, SIGNATURE_KERNELS, "signature path")
    if sig["sweep_launches"] < 1:
        raise AssertionError("K1 was not launched inside "
                             "SnpKmerFinder.find_kmers")
    if sig["map_launches"] < 1:
        raise AssertionError("K2 was not launched inside the final mapping")

    refseq = graph.linear_ref_sequence()[2]
    tape = torch.from_numpy(refseq.astype(np.int8)).to(dev)
    err = assert_equal(encode.sliding_hashes(tape, K),
                       encode.sliding_hashes_plain(tape, K),
                       f"K1 on the sweep's tape of {len(refseq)} bases")
    del tape

    # the sweep's rows come in position order; at every swept position one
    # of them is the reference window itself
    swept = columns_of(sig["swept"])
    n_positions = (len(refseq) - K) // SWEEP_SPACING
    sample = rng.integers(0, n_positions, n_sweep_sample) * SWEEP_SPACING
    windows = refseq[sample[:, None] + np.arange(K)].astype(np.uint64)
    want = (windows << (2 * np.arange(K, dtype=np.uint64))).sum(
        axis=1, dtype=np.uint64)
    if not np.array_equal(want[:16], np.array(
            [sliding_window_hashes(w, K)[0] for w in windows[:16]])):
        raise AssertionError("the sample's window hashes are not numpy's")
    offsets = swept["ref_offsets"]
    if np.any(offsets[1:] < offsets[:-1]):
        raise AssertionError("the sweep's rows are not in position order")
    lo = np.searchsorted(offsets, sample.astype(offsets.dtype), "left")
    hi = np.searchsorted(offsets, sample.astype(offsets.dtype), "right")
    for a, b, h in zip(lo, hi, want):
        if h not in swept["hashes"][a:b]:
            raise AssertionError("a swept position lacks the hash of its "
                                 "reference window")

    # the scoring route of the selection against the host library's
    scoring = sig["scoring"]
    signatures = columns_of(sig["signatures"])
    n_half = n_frequency_sample // 2
    picked = rng.integers(0, len(signatures["hashes"]), n_half)
    q = np.concatenate([
        signatures["hashes"][picked],
        rng.integers(0, 1 << 62, n_frequency_sample - n_half,
                     dtype=np.uint64)])
    on_card = st.run(f"get_frequencies on the card, {len(q)} queries",
                     scoring.get_frequencies, q, backend="device")
    on_host = st.run("get_frequencies by the native library (the index "
                     "copied to the host once)",
                     scoring.get_frequencies, q, backend="native")
    if on_card.dtype != np.int64 or not np.array_equal(on_card, on_host):
        raise AssertionError("get_frequencies on the card differs from the "
                             "native library's")
    if not (on_card[:n_half] >= 1).all():
        raise AssertionError("a signature k-mer is missing from the scoring "
                             "index")
    scoring._invalidate_query_caches()  # frees the host copy

    head = VcfVariants(sig["variants"].variants[:n_exact])

    def select(method):
        finder = UniqueVariantKmersFinder(
            graph, sig["v2n"], head, k=K,
            max_variant_nodes=SELECT_MAX_VARIANT_NODES,
            kmer_index_with_frequencies=scoring)
        return columns_of(getattr(finder, method)())

    batched = select("find_unique_kmers_batched")
    exact = st.run(f"per-variant search of {len(head)} variants",
                   select, "find_unique_kmers")
    assert_columns_equal(batched, exact, "batched selection against the "
                         "per-variant search")

    # both nodes of every variant, each at one position
    ref_nodes = np.asarray(sig["v2n"].ref_nodes).astype(np.int64)
    var_nodes = np.asarray(sig["v2n"].var_nodes).astype(np.int64)
    has_nodes = (ref_nodes > 0) & (var_nodes > 0)
    selected = np.zeros(sig["n_nodes"] + 1, dtype=bool)
    selected[signatures["nodes"]] = True
    incomplete = int((has_nodes & ~(selected[ref_nodes]
                                    & selected[var_nodes])).sum())
    selector = sig["selector"]
    if incomplete > selector.n_failed_variants:
        raise AssertionError(f"{incomplete} variants lack k-mers for one of "
                             f"their nodes, {selector.n_failed_variants} "
                             "were counted as failed")
    order = np.argsort(signatures["nodes"], kind="stable")
    nodes_s = signatures["nodes"][order]
    offsets_s = signatures["ref_offsets"][order]
    same_node = nodes_s[1:] == nodes_s[:-1]
    if np.any(same_node & (offsets_s[1:] != offsets_s[:-1])):
        raise AssertionError("a node was selected at two positions")

    written, loaded = sig["bundle"], sig["loaded"]
    if sorted(written.indexes) != sorted(loaded.indexes):
        raise AssertionError("the bundle read back has other entries")
    served = loaded["KmerIndex"]
    if served.device != dev:
        raise AssertionError(f"the bundle's index lies on {served.device}")
    assert_columns_equal(served.to_properties(),
                         written["KmerIndex"].to_properties(),
                         "the index read back from the bundle")
    for name in ("ReverseKmerIndex", "ReferenceKmerIndex",
                 "VariantNodesIndex"):
        # a class the bundle does not know comes back as a namespace of
        # its arrays, as in the JAX package
        assert_columns_equal(
            vars(loaded[name]),
            {p: getattr(written[name], p) for p in written[name].properties},
            f"{name} read back from the bundle")
    assert_columns_equal(
        {p: getattr(loaded["VariantToNodes"], p)
         for p in ("ref_nodes", "var_nodes")},
        {"ref_nodes": sig["v2n"].ref_nodes, "var_nodes": sig["v2n"].var_nodes},
        "VariantToNodes read back from the bundle")

    queries = torch.cat(sig["queries"].segments)
    want = join_counts(served.kmers, served.nodes, queries, sig["n_nodes"])
    counts = torch.from_numpy(sig["counts"]).to(dev)
    if counts.shape != (sig["n_nodes"],) or not torch.equal(counts, want):
        raise AssertionError("the signature path's node counts differ from "
                             "the join")
    hits = int(counts.sum())
    if hits == 0:
        raise AssertionError("no read k-mer hit the signature index")
    print(f"signature path: graph from variants == the build path's graph; "
          f"K1 == plain (bit-exact) on the sweep's tape of {len(refseq)} "
          f"bases; the sweep holds numpy's hash at {len(sample)} sampled "
          f"positions; get_frequencies on the card == native on {len(q)} "
          f"queries; batched == per-variant selection on {len(head)} "
          f"variants ({len(exact['hashes'])} rows); {int(has_nodes.sum())} "
          f"variants with nodes, {incomplete} incomplete, "
          f"{selector.n_failed_variants} failed; no node at two positions; "
          f"bundle read back == written; node counts == join ({hits} hits "
          f"of {queries.shape[0]} read k-mers)", flush=True)
    return err


def disk_bytes(prefix: str) -> int:
    """Bytes on disk of a shard checkpoint (every ``prefix.*`` file)."""
    p = Path(prefix)
    return sum(f.stat().st_size for f in p.parent.glob(p.name + ".*"))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def map_reads_sharded(dev, prefix, fasta, n_nodes, out) -> dict:
    """``map_reads -T``: the CLI's function on one rank per card (one
    process each, NCCL; gloo for a CPU device), the group started from an
    explicit address and port. Returns the kernel launches of all ranks."""
    n_ranks = torch.cuda.device_count() if dev.type == "cuda" else 1
    init = f"tcp://127.0.0.1:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", CLI_RANK, "map_reads", "-T", prefix, "-r",
         str(fasta), "-k", str(K), "-R", "true", "-n", str(n_nodes), "-o",
         str(out), "--dist-init-method", init, "--dist-world-size",
         str(n_ranks), "--dist-rank", str(rank), "--device", dev.type],
        cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(n_ranks)]
    try:
        logs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    launches = dict.fromkeys(_kernels.launch_counts, 0)
    for p, log in zip(procs, logs):
        if p.returncode != 0:
            raise AssertionError(f"a map_reads -T rank failed "
                                 f"({p.returncode}):\n{log[-4000:]}")
        line = [x for x in log.splitlines() if x.startswith("LAUNCHES ")]
        for name, n in json.loads(line[-1][len("LAUNCHES "):]).items():
            launches[name] += n
    return launches


def check_shard_k2(dev, shard, t, tables, queries, n_nodes, gen) -> int:
    """K2 in shard mode against its twin, counts and membership, on
    SHARD_SAMPLE of the read k-mers that table shard ``t`` owns and
    SHARD_MISSES random hashes (most owned by other shards). Returns the
    max abs difference (0)."""
    owner = (queries % shard.modulo2) // shard.m2_local
    mine = queries[owner == t][:SHARD_SAMPLE]
    misses = torch.randint(0, 1 << 62, (SHARD_MISSES,), device=dev,
                           generator=gen)
    q = torch.cat([mine, misses])
    base, m2 = t * shard.m2_local, shard.m2_local
    err = 0
    for nodes in (n_nodes, None):
        err = max(err, assert_equal(
            sharded.shard_lookup(shard, t, tables, q, nodes),
            lookup.packed_lookup_plain(tables, q, q.shape[0], nodes, base,
                                       m2),
            f"K2 in shard mode on shard {t} ({'counts' if nodes else 'has'})"
        ))
    return err


def sharded_path(dev, card, args, built, workdir, gen,
                 n_workers=BUILD_WORKERS, mp_context="spawn",
                 modulo=REF_MODULO, n_ranges=SHARD_RANGES) -> dict:
    """The sharded phase over the build path's graph, through the
    functions a user calls: the out-of-core build to a CSR shard
    checkpoint -> the whole index back onto the card -> the packed
    checkpoint, each shard served on the card by K2 in shard mode ->
    reshard to one shard a card -> ``map_reads -T``. Returns its state;
    the kernel launches that hold K2 against its twin are counted apart
    (``compare_launches``)."""
    st = Stages(dev, card)
    wd = Path(workdir)
    stats = {}
    t0 = time.perf_counter()
    built_ooc = oocbuild.find_and_build_out_of_core(
        built["graph"], K, n_workers, workdir=str(wd / "ooc"), modulo=modulo,
        n_ranges=n_ranges, critical_paths=built["cpaths"],
        mp_context=mp_context, require_native=True, stats=stats)
    t_ooc = time.perf_counter() - t0
    csr = built_ooc["prefix"]
    csr_bytes = disk_bytes(csr)
    st.report("out-of-core build (find_and_build_out_of_core)", t_ooc,
              f", {built_ooc['total_rows']} rows in {n_ranges} shards; "
              f"find + worker spill {stats['find_seconds']:.6f} s (spill "
              f"writes {stats['spill_write_seconds']:.6f} s summed over "
              f"{n_workers} workers, {mp_context}), shard builds "
              f"{stats['build_seconds']:.6f} s; {stats['spill_bytes']} "
              f"bytes spilled, {csr_bytes} bytes of CSR checkpoint")
    index = st.run("index_from_shard_checkpoint onto the card",
                   oocbuild.index_from_shard_checkpoint, csr, dev)

    t0 = time.perf_counter()
    packed = oocbuild.convert_checkpoint_to_packed(
        csr, str(wd / "convert"), n_table=n_ranges, n_workers=n_workers)
    packed_bytes = disk_bytes(packed["prefix"])
    st.report("convert_shards_to_packed", time.perf_counter() - t0,
              f", {n_ranges} shards, modulo2 {packed['modulo2']}, "
              f"{packed_bytes} bytes of packed checkpoint")

    n_nodes = built["n_nodes"]
    queries = torch.cat(built["queries"].segments)
    counts = torch.zeros(n_nodes, dtype=torch.int64, device=dev)
    k2_err, compare_launches, load_s, serve_s = 0, 0, 0.0, 0.0
    for t in range(n_ranges):
        sync(dev)
        t0 = time.perf_counter()
        shard = checkpoint.load_shard(packed["prefix"], t, dev)
        tables = sharded.shard_tables(shard, t, shard.records,
                                      shard.row_kmers, shard.row_nodes, dev)
        sync(dev)
        t1 = time.perf_counter()
        counts += sharded.shard_lookup(shard, t, tables, queries, n_nodes)
        sync(dev)
        load_s += t1 - t0
        serve_s += time.perf_counter() - t1
        before = _kernels.launch_counts["packed_lookup"]
        k2_err = max(k2_err, check_shard_k2(dev, shard, t, tables, queries,
                                            n_nodes, gen))
        compare_launches += _kernels.launch_counts["packed_lookup"] - before
        del shard, tables
    st.report("packed shards to the card, one at a time", load_s)
    st.report(f"K2 in shard mode, {n_ranges} shards", serve_s,
              f", {queries.shape[0]} read k-mers a shard")
    for f in Path(packed["prefix"]).parent.glob(
            Path(packed["prefix"]).name + ".*"):
        f.unlink()  # the disk for the resharded checkpoint

    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 1
    serve = st.run(f"reshard_checkpoint to {n_cards} shard(s)",
                   oocbuild.reshard_checkpoint, csr, str(wd / "serve"),
                   n_cards)["prefix"]
    fasta = wd / "sharded_reads.fa"
    synthetic.write_fasta(fasta, built["reads"])
    out = wd / "sharded_counts.npy"
    t0 = time.perf_counter()
    rank_launches = map_reads_sharded(dev, serve, fasta, n_nodes, out)
    st.report(f"map_reads -T ({n_cards} rank(s), spawned)",
              time.perf_counter() - t0,
              f", {len(built['reads'])} reads, both strands, from "
              f"{disk_bytes(serve)} bytes of checkpoint")
    return dict(ooc=built_ooc, index=index, packed=packed, counts=counts,
                k2_err=k2_err, compare_launches=compare_launches,
                rank_launches=rank_launches, fasta=fasta,
                served=np.load(out), n_nodes=n_nodes, csr_bytes=csr_bytes,
                packed_bytes=packed_bytes, stats=stats)


def check_sharded(dev, built, sh, launches) -> None:
    """The sharded phase's results, each check raising: the out-of-core
    index equals the build path's column for column; the shards' counts
    sum to the single table's; map_reads -T counts equal map_kmers on the
    same reads; the path launched K1 (map_reads -T) and K2 (the shards)."""
    if sh["ooc"]["total_rows"] != built["n_rows"]:
        raise AssertionError(f"{sh['ooc']['total_rows']} rows out of core, "
                             f"{built['n_rows']} in memory")
    got, want = sh["index"], built["index"]
    if got.modulo != want.modulo or not (torch.equal(got.kmers, want.kmers)
                                         and torch.equal(got.nodes,
                                                         want.nodes)):
        raise AssertionError("the out-of-core index's k-mers or nodes "
                             "differ from the build path's")
    for name in ("hashes_to_index", "n_kmers", "ref_offsets", "frequencies",
                 "allele_frequencies"):
        a = np.asarray(got._file_column(name))
        b = np.asarray(want._file_column(name))
        if a.shape != b.shape or not np.array_equal(a, b):
            raise AssertionError(f"the out-of-core index's {name} differ "
                                 "from the build path's")
    single = torch.from_numpy(built["counts"]).to(dev)
    if not torch.equal(sh["counts"], single):
        raise AssertionError("the shards' counts do not sum to the single "
                             "table's")
    kmers = hash_fasta_file(sh["fasta"], K, device=dev,
                            include_reverse_complements=True)
    expected = want.map_kmers(kmers, sh["n_nodes"])
    if sh["served"].shape != expected.shape or not np.array_equal(
            sh["served"], expected):
        raise AssertionError("map_reads -T counts differ from map_kmers")
    require_launches(launches, SHARDED_KERNELS, "sharded path")
    if sh["rank_launches"]["sliding_hash"] < 1:
        raise AssertionError("K1 was not launched by map_reads -T")
    print(f"sharded path: the out-of-core index == the build path's "
          f"({built['n_rows']} rows, every column); K2 in shard mode == "
          f"plain (bit-exact) on {SHARD_RANGES} shards; the shards' counts "
          f"sum to the single table's ({int(single.sum())} hits of "
          f"{sum(s.shape[0] for s in built['queries'].segments)} read "
          f"k-mers); map_reads -T == map_kmers ({int(expected.sum())} hits "
          f"of {len(kmers)} read k-mers)", flush=True)


class CheckLaunches:
    """The kernel launches that checks make (a kernel held against its
    twin, an expected value computed through the kernels): each ``with
    checks():`` block's launches are tallied in ``counts``, to be taken
    off the path's."""

    def __init__(self):
        self.counts = dict.fromkeys(_kernels.launch_counts, 0)

    @contextlib.contextmanager
    def __call__(self):
        before = dict(_kernels.launch_counts)
        try:
            yield
        finally:
            for name, n in _kernels.launch_counts.items():
                self.counts[name] += n - before[name]


def require_equal(got, want, what: str) -> None:
    """Raise unless two tensors hold the same values (dtypes may differ;
    equal ones are compared as they are, without a widened copy)."""
    if got.dtype != want.dtype:
        got, want = got.to(torch.int64), want.to(torch.int64)
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{what}: {tuple(got.shape)} != "
                             f"{tuple(want.shape)} or values differ")


def sharded_build_path(dev, card, built, workdir, gen,
                       modulo=REF_MODULO) -> dict:
    """The sharded-build phase over the build path's index, through the
    functions a user calls, each stage's checks raising: its rows in a
    seeded emission order -> build_packed_shards_sharded (equal to
    build_packed, record for record; served by the packed steps, K2 in
    shard mode) -> build_table_shards_sharded at ``modulo`` (equal to the
    index's bucket layout; served by the CSR step) -> frequencies_sharded
    (equal to the index's) -> map/has_kmers_sharded,
    count_min_sketch_sharded, merge_flat_kmers_all_gather and
    run_sharded_function -> save_shards on the mesh and load_shards back
    -> entry()'s forward against the toy index, and dryrun_multichip on
    every card. One rank (the card's machine has one card): the group is
    started here and stopped at the end. Returns the phase's launches (the
    checks' taken off, the dry-run ranks' added), its timings and its
    K2-against-twin error."""
    st = Stages(dev, card)
    timings = Timings()
    checks = CheckLaunches()
    index, n_nodes = built["index"], built["n_nodes"]
    queries = torch.cat(built["queries"].segments)
    single = torch.from_numpy(built["counts"]).to(dev)
    n = index.kmers.shape[0]
    _kernels.reset_launch_counts()

    def stage(name, fn, *args, **kw):
        with timings.span(name):
            return st.run(name, fn, *args, **kw)

    mesh.start_process_group(dev.type)
    try:
        m = mesh.build_mesh(1, 1)
        perm = stage("rows in emission order (randperm)",
                     torch.randperm, n, device=dev, generator=gen)
        kmers, nodes = index.kmers[perm], index.nodes[perm]

        with device_trace(str(Path(workdir) / "trace")) as trace:
            shard, rows = stage("build_packed_shards_sharded",
                                sharded.build_packed_shards_sharded,
                                kmers, nodes)
        trace_bytes = os.path.getsize(trace.path)
        with checks():
            want = lookup.build_packed(kmers, nodes, shard.modulo2)
            require_equal(shard.records[0], want.records,
                          "sharded packed records != build_packed")
            if rows != n or shard.max_scan != want.max_sz:
                raise AssertionError("sharded packed rows or depth differ")
            require_equal(shard.row_kmers[0, :rows], want.ks,
                          "sharded packed rows' k-mers")
            require_equal(shard.row_nodes[0, :rows], want.ns,
                          "sharded packed rows' nodes")
            want_hit = lookup.packed_lookup(want, queries, queries.shape[0])
            del want
        cols = (shard.records, shard.row_kmers, shard.row_nodes)
        k2_before = _kernels.launch_counts["packed_lookup"]
        counts = stage("packed count step (from k-mers)",
                       sharded.make_count_step_packed(
                           m, shard, n_nodes, K, from_kmers=True),
                       queries, *cols)
        hit = stage("packed member step (from k-mers)",
                    sharded.make_member_step_packed(m, shard, K,
                                                    from_kmers=True),
                    queries, *cols)
        step_k2 = _kernels.launch_counts["packed_lookup"] - k2_before
        require_equal(counts, single, "packed step counts != map_kmers")
        require_equal(hit, want_hit, "packed step membership != has_kmers")
        with checks():
            tables = sharded.shard_tables(shard, 0, *cols, dev)
            k2_err = check_shard_k2(dev, shard, 0, tables, queries, n_nodes,
                                    gen)
        del shard, tables, cols, want_hit, hit

        cshard, rows = stage("build_table_shards_sharded",
                             sharded.build_table_shards_sharded,
                             kmers, nodes, modulo)
        sizes, starts = cshard.sizes[0], cshard.starts[0]
        require_equal(sizes, index.n_kmers, "sharded CSR sizes != n_kmers")
        full = sizes > 0
        require_equal(starts[full], index.hashes_to_index[full],
                      "sharded CSR starts != the index's")
        if rows != n:
            raise AssertionError(f"{rows} rows in the CSR shard, {n} built")
        counts = stage("CSR count step (from k-mers)",
                       sharded.make_count_step(m, cshard, n_nodes, K,
                                               from_kmers=True),
                       queries, cshard.starts, cshard.sizes,
                       cshard.row_kmers, cshard.row_nodes)
        require_equal(counts, single, "CSR step counts != map_kmers")
        del full

        refs = index.ref_offsets[perm]
        freqs = stage("frequencies_sharded", sharded.frequencies_sharded,
                      kmers, refs)
        unpermuted = torch.empty_like(freqs)
        unpermuted[perm] = freqs
        require_equal(unpermuted, index.frequencies,
                      "frequencies_sharded != the index's frequencies")
        del perm, kmers, nodes, refs, freqs, unpermuted

        sketch = stage("count_min_sketch_sharded",
                       sharded.count_min_sketch_sharded, queries,
                       CMS_MODULOS)
        require_equal(sketch, torch.cat([torch.bincount(queries % p,
                                                        minlength=p)
                                         for p in CMS_MODULOS]),
                      "count_min_sketch_sharded != bincount")
        columns = (index.kmers, index.nodes, index.ref_offsets,
                   index.allele_frequencies)
        merged = stage("merge_flat_kmers_all_gather",
                       sharded.merge_flat_kmers_all_gather, None, columns)
        for got, col in zip(merged, columns):
            if not torch.equal(got, col):
                raise AssertionError("merge_flat_kmers_all_gather != its "
                                     "inputs")
        del merged
        mapped = stage("run_sharded_function", sharded.run_sharded_function,
                       lambda a: a * 2 + 1, 1, [queries])
        require_equal(mapped, queries * 2 + 1,
                      "run_sharded_function != the function whole")
        del mapped
        got = stage("map_kmers_sharded", sharded.map_kmers_sharded, index,
                    queries, n_nodes)
        require_equal(torch.from_numpy(got), single.cpu(),
                      "map_kmers_sharded != map_kmers")
        got = stage("has_kmers_sharded", sharded.has_kmers_sharded, index,
                    queries)
        with checks():
            want = index.has_kmers(queries)
        if not np.array_equal(got, want):
            raise AssertionError("has_kmers_sharded != has_kmers")
        index._invalidate_query_caches()

        prefix = str(Path(workdir) / "sharded_csr")
        stage("save_shards on the mesh (CSR shard)",
              checkpoint.save_shards, cshard, prefix, mesh=m)
        loaded = stage("load_shards onto the mesh", checkpoint.load_shards,
                       prefix, mesh=m)
        for name in ("starts", "sizes", "row_kmers", "row_nodes"):
            require_equal(getattr(loaded, name), getattr(cshard, name),
                          f"checkpoint round trip: {name}")
        ckpt_bytes = disk_bytes(prefix)
        del cshard, loaded

        fn, (reads,) = stage("entry() (toy index and reads)",
                             entry.entry, dev)
        k1_before = _kernels.launch_counts["sliding_hash"]
        toy_counts = stage("entry()'s forward", fn, reads)
        forward_k1 = _kernels.launch_counts["sliding_hash"] - k1_before
        with checks():
            toy, n_toy, _, _ = entry.toy_setup(K, dev)
            tape = reads.reshape(-1).to(torch.int8)
            hashes = encode.sliding_hashes_plain(tape, K)
            k1_err = assert_equal(encode.sliding_hashes(tape, K), hashes,
                                  "K1 on entry()'s reads")
            valid = (torch.arange(tape.shape[0], device=dev)
                     % reads.shape[1]) <= reads.shape[1] - K
            want = toy.map_kmers(hashes[valid], n_toy)
        if not np.array_equal(toy_counts.cpu().numpy(), want):
            raise AssertionError("entry()'s forward != the toy index's "
                                 "map_kmers")
        n_cards = torch.cuda.device_count() if dev.type == "cuda" else 1
        rank_launches = stage(f"dryrun_multichip({n_cards}), spawned",
                              entry.dryrun_multichip, n_cards, dev.type)
    finally:
        mesh.stop_process_group()
    launches = {name: count - checks.counts[name] + rank_launches[name]
                for name, count in _kernels.launch_counts.items()}
    print(f"sharded-build phase: {n} rows; build_packed_shards_sharded == "
          f"build_packed (records, rows); the packed and CSR steps' counts "
          f"== map_kmers ({int(single.sum())} hits); CSR shard == the "
          f"index's layout; frequencies_sharded == the index's; map/has_"
          f"kmers_sharded, the sketch, the merge and run_sharded_function "
          f"hold; save/load round trip of {ckpt_bytes} bytes; entry() == "
          f"map_kmers ({int(toy_counts.sum())} hits); dryrun_multichip("
          f"{n_cards}) passed; trace {trace_bytes} bytes", flush=True)
    print("timings of the phase (Timings.report):\n" + timings.report(),
          flush=True)
    return dict(launches=launches, rank_launches=rank_launches,
                step_k2=step_k2, forward_k1=forward_k1, k2_err=k2_err,
                k1_err=k1_err, trace_bytes=trace_bytes, timings=timings)


def check_sharded_build(sb) -> None:
    """The sharded-build phase launched K1 and K2: K2 in shard mode in
    each of the two packed steps, K1 in entry()'s forward."""
    require_launches(sb["launches"], SHARDED_BUILD_KERNELS,
                     "sharded-build path")
    if sb["step_k2"] < 2:
        raise AssertionError("the packed steps did not launch K2")
    if sb["forward_k1"] < 1:
        raise AssertionError("entry()'s forward did not launch K1")


KERNEL_KEYS = ("name", "route", "source", "replaces", "launches",
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")


def kernel_entries(launches, hash_launches, lookup_launches,
                   upload_launches, errs, timed, later_paths=None) -> list:
    """The entries of the ``kernels`` line: every kernel with its source,
    the code it replaces, its launches on its own path, its error against
    the twin and its measured and bound times. A kernel that a later path
    launched too (``later_paths``: path name -> that path's launch counts,
    e.g. ``build``, ``signature``) reports the sum over its paths, and
    each path's count under ``launches_by_path``."""
    sources = {"sliding_hash": (K1_SOURCE, K1_REPLACES, launches),
               "packed_lookup": (K2_SOURCE, K2_REPLACES, launches),
               "sliding_pack_p16": (K3_SOURCE, K3_REPLACES, hash_launches),
               "sliding_pack_p8": (K3_SOURCE, K3_REPLACES, hash_launches),
               "stream_copy": (K45_SOURCE, K4_REPLACES, hash_launches),
               "stream_sum": (K45_SOURCE, K5_REPLACES, hash_launches),
               "gather_loop": (K678_SOURCE, K6_REPLACES, lookup_launches),
               "rmw_loop": (K678_SOURCE, K7_REPLACES, lookup_launches),
               "bcast_cmp": (K678_SOURCE, K8_REPLACES, lookup_launches),
               "rolled_decode": (K9_SOURCE, K9_REPLACES, upload_launches)}
    kernels = [{"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": path_launches[name],
                **errs[name], **timed[name]}
               for name, (source, replaces, path_launches)
               in sources.items()]
    for entry in kernels:
        later = {path: counts.get(entry["name"], 0)
                 for path, counts in (later_paths or {}).items()}
        if any(later.values()):
            entry["launches_by_path"] = {"read_mapping": entry["launches"],
                                         **later}
            entry["launches"] += sum(later.values())
        missing = [key for key in KERNEL_KEYS if key not in entry]
        if missing:
            raise AssertionError(f"kernel {entry['name']} lacks {missing}")
    return kernels


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--genome-bases", type=int, default=150_000_000)
    p.add_argument("--reads", type=int, default=1_000_000)
    p.add_argument("--build-bases", type=int, default=150_000_000,
                   help="reference bases of the build path's graph")
    p.add_argument("--build-variants", type=int, default=600_000)
    p.add_argument("--build-reads", type=int, default=100_000)
    p.add_argument("--check-bases", type=int, default=3_000_000,
                   help="bases of the small graph whose device rows are "
                        "held against the host's")
    p.add_argument("--profile", metavar="PATH",
                   help="profile the CSR map_kmers and has_kmers calls as "
                        "well as the packed ones; write the operator "
                        "tables to PATH")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (there is no CPU path)")
    dev = torch.device("cuda:0")
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    path, seconds = _kernels.build()
    print(f"built {path.name} in {seconds:.3f} s", flush=True)
    _kernels.library()
    # the host library too, before any stage that would time its build:
    # the reads' parse and the build path's walk run in it
    t0 = time.perf_counter()
    require_native()
    print(f"native host library ready in {time.perf_counter() - t0:.3f} s",
          flush=True)

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    k1_err = check_k1(dev, 1 << 26, gen)

    torch.cuda.reset_peak_memory_stats(dev)
    _kernels.reset_launch_counts()
    with tempfile.TemporaryDirectory() as workdir:
        state = main_path(dev, card, args, workdir)
    launches = dict(_kernels.launch_counts)
    print(f"main path launches {launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev)} bytes [{card}]",
          flush=True)
    require_launches(launches, READ_MAPPING_KERNELS, "read-mapping path")

    check_results(dev, state, K, 1000,
                  np.random.default_rng(args.seed + 1))
    main_k1_err, main_k2_err = check_at_main_shapes(state, K)
    k1_err = max(k1_err, main_k1_err)
    k2_err = max(main_k2_err, check_k2(dev, state, 1 << 22, gen))
    timed = time_kernels(dev, card, state, K)
    errs = {}
    for name, err in (("sliding_hash", k1_err), ("packed_lookup", k2_err)):
        errs[name] = {"max_abs_err": max(err,
                                         timed[name].pop("max_abs_err"))}

    _kernels.reset_launch_counts()
    up = upload_path(dev, card, state["read_kmers"])
    upload_launches = dict(_kernels.launch_counts)
    print(f"upload path launches {upload_launches} [{card}]", flush=True)
    require_launches(upload_launches, UPLOAD_KERNELS, "upload path")
    errs.update(check_upload(up))
    timed.update(time_upload(dev, card, up))
    errs["rolled_decode"]["max_abs_err"] = max(
        errs["rolled_decode"]["max_abs_err"],
        timed["rolled_decode"].pop("max_abs_err"))
    del up

    check_k3(dev, 1 << 26, gen)
    _kernels.reset_launch_counts()
    hashed = hashing_path(dev, card, state["genome"], primitives.STREAM_ROWS,
                          primitives.BLOCK_ROWS, gen)
    hash_launches = dict(_kernels.launch_counts)
    print(f"hashing path launches {hash_launches} [{card}]", flush=True)
    require_launches(hash_launches, HASHING_KERNELS, "hashing path")
    errs.update(check_hashing(state, hashed))
    timed.update(time_hashing(dev, card, state, hashed))
    del hashed

    probes = probe_inputs(dev, gen, primitives.PROBE_QUERIES,
                          primitives.PROBE_BLOCK, primitives.CMP_QUERIES,
                          primitives.CMP_ENTRIES)
    torch.cuda.reset_peak_memory_stats(dev)
    _kernels.reset_launch_counts()
    lk = lookup_path(dev, card, state, probes, REF_MODULO, GET_QUERIES, gen)
    lookup_launches = dict(_kernels.launch_counts)
    print(f"lookup path launches {lookup_launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev)} bytes [{card}]",
          flush=True)
    require_launches(lookup_launches, LOOKUP_KERNELS, "lookup path")
    errs.update(check_lookup(dev, state, lk, GET_SAMPLE, gen))
    timed.update(time_lookup(dev, card, state, lk))
    with tempfile.TemporaryDirectory() as workdir:
        syncs = profile_lookup(
            dev, card, state, args.profile or Path(workdir) / "profile.txt",
            lk["csr"] if args.profile else None)
    n_seg = len(state["read_kmers"].segments)
    for name in ("map_kmers", "has_kmers"):
        if syncs[name] > 2 * n_seg:
            raise AssertionError(f"a packed {name} call made the host wait "
                                 f"{syncs[name]} times over {n_seg} read "
                                 "segments")
    del lk, state, probes
    torch.cuda.empty_cache()

    check_build_small(dev, card, args)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    _kernels.reset_launch_counts()
    built = build_path(dev, card, args)
    build_launches = dict(_kernels.launch_counts)
    print(f"build path launches {build_launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev)} bytes [{card}]",
          flush=True)
    errs["sliding_hash"]["max_abs_err"] = max(
        errs["sliding_hash"]["max_abs_err"],
        check_build(dev, built, build_launches, gen))

    # the signature path scores against the build path's index (the
    # sharded path's reference too); its packed table is not needed again
    del built["tables"]
    built["index"]._invalidate_query_caches()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    _kernels.reset_launch_counts()
    with tempfile.TemporaryDirectory() as workdir:
        sig = signature_path(dev, card, args, built, workdir)
    signature_launches = dict(_kernels.launch_counts)
    print(f"signature path launches {signature_launches}; peak device "
          f"memory {torch.cuda.max_memory_allocated(dev)} bytes [{card}]",
          flush=True)
    errs["sliding_hash"]["max_abs_err"] = max(
        errs["sliding_hash"]["max_abs_err"],
        check_signature(dev, card, built, sig, signature_launches,
                        SWEEP_SAMPLE, FREQUENCY_SAMPLE, EXACT_VARIANTS,
                        np.random.default_rng(args.seed + 4)))
    del sig

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    _kernels.reset_launch_counts()
    with tempfile.TemporaryDirectory() as workdir:
        sh = sharded_path(dev, card, args, built, workdir, gen)
        # the ranks' launches (K1 hashes their reads); the launches that
        # held K2 against its twin are not the path's
        sharded_launches = dict(_kernels.launch_counts)
        sharded_launches["packed_lookup"] -= sh["compare_launches"]
        for name, n in sh["rank_launches"].items():
            sharded_launches[name] += n
        print(f"sharded path launches {sharded_launches}; peak device "
              f"memory {torch.cuda.max_memory_allocated(dev)} bytes (this "
              f"process) [{card}]", flush=True)
        check_sharded(dev, built, sh, sharded_launches)
    errs["packed_lookup"]["max_abs_err"] = max(
        errs["packed_lookup"]["max_abs_err"], sh["k2_err"])
    del sh

    # the sharded builds over the build path's index; its query caches
    # (the sharded phase's packed table) are freed first
    built["index"]._invalidate_query_caches()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        sb = sharded_build_path(dev, card, built, workdir, gen)
    print(f"sharded-build phase, stages and checks: "
          f"{time.perf_counter() - t0:.6f} s [{card}]", flush=True)
    sharded_build_launches = sb["launches"]
    print(f"sharded-build path launches {sharded_build_launches} (the "
          f"dry-run ranks' {sb['rank_launches']} included); peak device "
          f"memory {torch.cuda.max_memory_allocated(dev)} bytes (this "
          f"process) [{card}]", flush=True)
    check_sharded_build(sb)
    for name, key in (("sliding_hash", "k1_err"), ("packed_lookup",
                                                   "k2_err")):
        errs[name]["max_abs_err"] = max(errs[name]["max_abs_err"], sb[key])
    del built, sb

    kernels = kernel_entries(launches, hash_launches, lookup_launches,
                             upload_launches, errs, timed, {"build": build_launches,
                                     "signature": signature_launches,
                                     "sharded": sharded_launches,
                                     "sharded_build": sharded_build_launches})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
