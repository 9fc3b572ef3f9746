#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (graph_kmer_index_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0]

1. Prints the card (nvidia-smi name and power limit); with no CUDA device
   it raises: there is no CPU path.
2. Builds the hand-written kernels from the checkout's sources (one nvcc
   per source, all at once): K1 (csrc/sliding_hash.cu), K2
   (csrc/packed_lookup.cu), K3 (csrc/sliding_pack.cu), K4 and K5
   (csrc/stream.cu), K6-K8 (csrc/probes.cu).
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
   bincount for K7), timed here and used nowhere in the port.
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
   frequency <= max_hits; and each probe against its twin (exact). Times
   the probes against their twins, the CSR map/has against the packed
   path and the two get_batched routes against each other.
10. torch.profiler over a second packed call of map_kmers and of
   has_kmers: a summary line each on stdout with the call's host syncs
   (the ops that wait, by name, the runtime's synchronize calls and the
   copies to the host), which must not exceed two a read segment.
   With ``--profile PATH`` the CSR calls are profiled too and the
   operator tables are written to PATH.

Any failed check raises before the last line, which is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from graph_kmer_index_tpu_torch import KmerIndex, hash_fasta_file  # noqa: E402
from graph_kmer_index_tpu_torch.hashing import (  # noqa: E402
    kmer_hashes_to_reverse_complement_hash, sliding_window_hashes)
from graph_kmer_index_tpu_torch.ops import _kernels  # noqa: E402
from graph_kmer_index_tpu_torch.ops import (  # noqa: E402
    encode, lookup, primitives)
from graph_kmer_index_tpu_torch.utils import synthetic  # noqa: E402

K1_SOURCE = "graph_kmer_index_tpu_torch/csrc/sliding_hash.cu"
K2_SOURCE = "graph_kmer_index_tpu_torch/csrc/packed_lookup.cu"
K3_SOURCE = "graph_kmer_index_tpu_torch/csrc/sliding_pack.cu"
K45_SOURCE = "graph_kmer_index_tpu_torch/csrc/stream.cu"
K678_SOURCE = "graph_kmer_index_tpu_torch/csrc/probes.cu"
K1_REPLACES = "graph_kmer_index_tpu/ops/encode.py:133"
K2_REPLACES = "graph_kmer_index_tpu/ops/lookup.py:349"
K3_REPLACES = "graph_kmer_index_tpu/ops/encode.py:242"
K4_REPLACES = "benchmarks/bench_primitives.py:325"
K5_REPLACES = "benchmarks/bench_primitives.py:369"
K6_REPLACES = "benchmarks/bench_primitives.py:140"
K7_REPLACES = "benchmarks/bench_primitives.py:182"
K8_REPLACES = "benchmarks/bench_primitives.py:224"
K = 31
READ_LEN = 150
PACK_KS = (1, 5, 8, 9, 12, 15, 16, 17, 21, 31)
READ_MAPPING_KERNELS = ("sliding_hash", "packed_lookup")
HASHING_KERNELS = ("sliding_pack_p16", "sliding_pack_p8", "stream_copy",
                   "stream_sum")
LOOKUP_KERNELS = ("gather_loop", "rmw_loop", "bcast_cmp")
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
    for name in ("parse", "upload", "hash"):
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

    # counts: every table row adds the number of queries equal to its k-mer
    uq, qc = torch.unique(queries, return_counts=True)
    pos = torch.searchsorted(uq, index.kmers).clamp(max=uq.shape[0] - 1)
    match = uq[pos] == index.kmers
    ref = torch.zeros(n_nodes, dtype=torch.int64, device=dev)
    ref.index_add_(0, index.nodes[match], qc[pos[match]])
    del uq, qc, pos, match
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


def probe_inputs(dev, gen, n_q, block_q, n_cmp, n_entries) -> dict:
    """Seeded inputs of the three probes at bench_primitives.py's shapes:
    n_q int32 indices into a (PROBE_ROWS, PROBE_COLS) int32 table of
    values < 2^30 (K6, K7); n_cmp queries as (n_cmp / 128, 128) lo and hi
    against n_entries table keys (K8), where every 16th entry repeats its
    predecessor's key with its own node and a quarter of the queries take
    a table entry's key, so that counts above 1 and the first-match rule
    are exercised."""
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
    return dict(idx=ints(rows, (n_q,)), table=ints(1 << 30, (rows, cols)),
                block_q=block_q,
                cmp=(qlo, qhi, tlo, thi, ints(1 << 20, (n_entries,))))


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

    searched = lookup.DeviceKmerIndex(csr)
    default_route = ("tables" if searched._bucket_tables_cheap()
                     else "searchsorted")
    searched.BUCKET_TABLE_BYTE_BUDGET = 0
    tabled = lookup.DeviceKmerIndex(csr)
    tabled.BUCKET_TABLE_BYTE_BUDGET = 1 << 62
    q = first_queries(read_kmers, n_get)
    print(f"CSR index: {n} rows at modulo {modulo}, max bucket "
          f"{searched.max_scan}; get_batched's default route: "
          f"{default_route} (the budget counts 12 B per bucket, "
          f"{12 * modulo} bytes, against "
          f"{lookup.DeviceKmerIndex.BUCKET_TABLE_BYTE_BUDGET})", flush=True)
    out.update(q=q, searched=searched, tabled=tabled,
               default_route=default_route)
    out["get_searched"] = st.run("get_batched (searchsorted route)",
                                 searched.get_batched, q)
    out["get_tables"] = st.run("get_batched (tables route)",
                               tabled.get_batched, q)
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
    twin. Returns each probe's error fields for the kernels line."""
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


def time_lookup(dev, card, state, lk, reps=100) -> dict:
    """The probes against their twins (means of ``reps`` launches, K8
    reps // 10), the CSR map/has against the packed path's and the two
    get_batched routes against each other; every timed output is
    compared; bincount beside K7 as the one PyTorch call that computes
    its counts (no one call computes K6's wrapping block sums or K8's
    count and first node). Prints the rates; returns {probe: the kernels
    line's timed fields}."""
    p = lk["probes"]
    timed = {
        "gather_loop": time_pair(
            dev, lambda: primitives.gather_loop(p["idx"], p["table"],
                                                p["block_q"]),
            lambda: primitives.gather_loop_plain(p["idx"], p["table"],
                                                 p["block_q"]),
            reps, "K6 timed"),
        "rmw_loop": time_pair(
            dev, lambda: primitives.rmw_loop(p["idx"]),
            lambda: primitives.rmw_loop_plain(p["idx"]), reps, "K7 timed"),
        "bcast_cmp": time_pair(
            dev, lambda: primitives.bcast_cmp(*p["cmp"]),
            lambda: primitives.bcast_cmp_plain(*p["cmp"]), max(1, reps // 10),
            "K8 timed")}
    n_idx = p["idx"].shape[0]
    n_cmp, n_entries = p["cmp"][0].numel(), p["cmp"][2].shape[0]
    rows, cols = p["table"].shape
    idx64 = p["idx"].to(torch.int64)
    library = {"rmw_loop": time_one(
        dev, lambda: torch.bincount(idx64, minlength=rows), reps)}
    # K6 reads the indices and column 0 and writes a sum per block; K7
    # reads the indices and writes the whole counts table; K8 reads and
    # writes two int32 per query and the table's three columns
    bounds = {
        "gather_loop": bound(4 * n_idx + 4 * rows
                             + 4 * (n_idx // p["block_q"])),
        "rmw_loop": bound(4 * n_idx + 4 * rows * cols),
        "bcast_cmp": bound(16 * n_cmp + 12 * n_entries,
                           CMP_OPS * n_cmp * n_entries)}
    for name, items, unit in (("gather_loop", n_idx, "gathers"),
                              ("rmw_loop", n_idx, "increments"),
                              ("bcast_cmp", n_cmp * n_entries, "compares")):
        ms, plain_ms, raw, _ = timed[name]
        lib_ms = library.get(name)
        print(f"timing {name}: kernel {ms:.6f} ms ({items / ms / 1e6:.3f} G "
              f"{unit}/s), plain {plain_ms:.6f} ms "
              f"({items / plain_ms / 1e6:.3f} G {unit}/s), bound "
              f"{bounds[name]['bound_ms']:.6f} ms by "
              f"{bounds[name]['bound_by']}, one PyTorch call "
              f"{'(bincount) %.6f ms' % lib_ms if lib_ms else 'none'}; "
              f"kernel,kernel,plain,plain = {raw} [{card}]", flush=True)

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
    return {name: {"ms": t[0], "plain_ms": t[1], **bounds[name],
                   "library_ms": library.get(name)}
            for name, t in timed.items()}


def _device_us(event) -> float:
    us = getattr(event, "self_device_time_total", None)
    return us if us is not None else event.self_cuda_time_total


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


KERNEL_KEYS = ("name", "route", "source", "replaces", "launches",
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")


def kernel_entries(launches, hash_launches, lookup_launches, errs,
                   timed) -> list:
    """The entries of the ``kernels`` line: every kernel with its source,
    the code it replaces, its launches on its own path, its error against
    the twin and its measured and bound times."""
    sources = {"sliding_hash": (K1_SOURCE, K1_REPLACES, launches),
               "packed_lookup": (K2_SOURCE, K2_REPLACES, launches),
               "sliding_pack_p16": (K3_SOURCE, K3_REPLACES, hash_launches),
               "sliding_pack_p8": (K3_SOURCE, K3_REPLACES, hash_launches),
               "stream_copy": (K45_SOURCE, K4_REPLACES, hash_launches),
               "stream_sum": (K45_SOURCE, K5_REPLACES, hash_launches),
               "gather_loop": (K678_SOURCE, K6_REPLACES, lookup_launches),
               "rmw_loop": (K678_SOURCE, K7_REPLACES, lookup_launches),
               "bcast_cmp": (K678_SOURCE, K8_REPLACES, lookup_launches)}
    kernels = [{"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": path_launches[name],
                **errs[name], **timed[name]}
               for name, (source, replaces, path_launches)
               in sources.items()]
    for entry in kernels:
        missing = [key for key in KERNEL_KEYS if key not in entry]
        if missing:
            raise AssertionError(f"kernel {entry['name']} lacks {missing}")
    return kernels


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--genome-bases", type=int, default=150_000_000)
    p.add_argument("--reads", type=int, default=1_000_000)
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
    del lk

    kernels = kernel_entries(launches, hash_launches, lookup_launches, errs,
                             timed)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
