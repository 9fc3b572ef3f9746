"""Driver entry points of the port: the counterparts of the JAX package's
``__graft_entry__.py``.

- :func:`entry`: the one-card forward step of the flagship pipeline (the
  KAGE genotyping hot path): 2-bit reads -> sliding-window k-mer hashes
  (K1) -> collision-free index lookup (the CSR scan, ``max_scan`` rows a
  query) -> per-node counts.
- :func:`dryrun_multichip`: the same pipeline, and every sharded path of
  the package, on ``n_devices`` ranks of torch.distributed (NCCL, one rank
  a card; gloo on the CPU), each check held against the one-card result.

A rank of the dry run is this module run as a program:

    python -m graph_kmer_index_tpu_torch.entry INIT WORLD RANK DEVICE WORKDIR
"""
from __future__ import annotations

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

from .device import resolve_device
from .ops.encode import sliding_hashes

K = 31
TOY_MODULO = 2099
ROOT = Path(__file__).resolve().parents[1]


def toy_setup(k: int = K, device="cuda"):
    """(index on ``device``, n_nodes, (64, 128) int32 reads, graph): the
    JAX package's ``_toy_setup``, draw for draw from numpy's
    ``default_rng(0)``, so the graph, the index's rows and the reads are
    its own."""
    from .finder import DenseKmerFinder
    from .graph import Graph
    from .models.kmer_index import KmerIndex

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    bases = "ACGT"
    # small variant graph: ref segments with SNP bubbles between them
    node_seqs, edges, linear_ref = {}, {}, []
    nid = 0
    prev_tails = []
    for _ in range(8):
        seg = "".join(rng.choice(list(bases), size=60))
        node_seqs[nid] = seg
        for t in prev_tails:
            edges.setdefault(t, []).append(nid)
        linear_ref.append(nid)
        ref_snp, var_snp = nid + 1, nid + 2
        node_seqs[ref_snp] = str(rng.choice(list(bases)))
        node_seqs[var_snp] = str(rng.choice(list(bases)))
        edges[nid] = [ref_snp, var_snp]
        linear_ref.append(ref_snp)
        prev_tails = [ref_snp, var_snp]
        nid += 3
    tail = "".join(rng.choice(list(bases), size=60))
    node_seqs[nid] = tail
    for t in prev_tails:
        edges.setdefault(t, []).append(nid)
    linear_ref.append(nid)

    graph = Graph.from_dicts(node_seqs, edges, linear_ref)
    finder = DenseKmerFinder(graph, k=k, max_variant_nodes=4, device=dev)
    finder.find()
    flat = finder.get_flat_kmers(v="0")
    index = KmerIndex.from_flat_kmers(flat, modulo=TOY_MODULO, device=dev)

    # simulated read batch (2-bit codes): windows of the linear-reference
    # sequence plus sequencing noise, so lookups hit
    ref_seq = np.concatenate(
        [graph.get_numeric_node_sequence(v)
         for v in sorted(graph.linear_ref_nodes())])
    starts = rng.integers(0, max(1, len(ref_seq) - 128), size=64)
    reads = np.stack([ref_seq[s:s + 128] for s in starts]).astype(np.int32)
    noise = rng.random(reads.shape) < 0.01
    reads = np.where(noise, rng.integers(0, 4, reads.shape),
                     reads).astype(np.int32)
    return index, graph.n_nodes(), reads, graph


def _window_kmers(reads: torch.Tensor, k: int):
    """(hash of every position's window, valid mask) of a (reads, L) 2-bit
    matrix: K1 over the flat tape; a window that crosses a read's end is
    not valid."""
    r, length = reads.shape
    hashes = sliding_hashes(reads.reshape(-1).to(torch.int8), k)
    pos = torch.arange(r * length, device=reads.device) % length
    return hashes, pos <= length - k


def forward_step(index, n_nodes: int, k: int = K):
    """The forward step over ``index`` (its bucket layout on its device):
    ``forward(reads)`` takes a (reads, L) tensor of 2-bit codes and returns
    int32 node counts, as the JAX ``entry()``'s function does: every
    window hashed by K1, then ``max_scan`` rows of its bucket scanned."""
    table_kmers, table_nodes = index.kmers, index.nodes
    starts_tbl = index.hashes_to_index.to(torch.int64)
    sizes_tbl = index.n_kmers.to(torch.int64)
    modulo = index.modulo
    max_scan = max(1, int(sizes_tbl.max()))
    n_rows = table_kmers.shape[0]

    def forward(reads: torch.Tensor) -> torch.Tensor:
        hashes, valid = _window_kmers(reads, k)
        kmers = torch.where(valid, hashes, 0)
        bucket = kmers % modulo
        start, n_in = starts_tbl[bucket], sizes_tbl[bucket]
        scan = torch.arange(max_scan, device=kmers.device)
        rows = torch.clamp(start[:, None] + scan[None, :], max=n_rows - 1)
        hit = ((scan[None, :] < n_in[:, None])
               & (table_kmers[rows] == kmers[:, None]) & valid[:, None])
        counts = torch.zeros(n_nodes, dtype=torch.int32, device=kmers.device)
        return counts.index_add_(0, table_nodes[rows].reshape(-1),
                                 hit.reshape(-1).to(torch.int32))

    return forward


def entry(device="cuda"):
    """(forward, (reads,)): the one-card forward step over the toy index
    and its read batch on ``device``."""
    index, n_nodes, reads, _graph = toy_setup(K, device)
    return (forward_step(index, n_nodes, K),
            (torch.from_numpy(reads).to(index.device),))


# -- the multi-rank dry run ---------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device="cuda",
                     timeout: float = 600.0) -> dict:
    """Every sharded path of the package on ``n_devices`` ranks, one
    spawned process each (NCCL on ``cuda``, one rank a card, at most the
    cards present; gloo on ``cpu``), each rank raising unless its checks
    hold (``_checks``). Raises when a rank fails (the others are killed)
    or the ranks outlast ``timeout`` seconds. Returns the kernel launches
    of all ranks, summed."""
    dev = resolve_device(device)
    n_devices = int(n_devices)
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(f"{n_devices} ranks need as many cards; "
                         f"{torch.cuda.device_count()} present")
    init = f"tcp://127.0.0.1:{_free_port()}"
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    with tempfile.TemporaryDirectory() as workdir:
        logs = [Path(workdir, f"rank-{r}.log") for r in range(n_devices)]
        procs = []
        try:
            for rank, log in enumerate(logs):
                with open(log, "w") as out:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", __name__, init,
                         str(n_devices), str(rank), dev.type, workdir],
                        cwd=ROOT, env=env, stdout=out,
                        stderr=subprocess.STDOUT))
            _wait_all(procs, logs, timeout)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        launches: dict = {}
        for r in range(n_devices):
            with open(Path(workdir, f"launches-{r}.json")) as f:
                for name, n in json.load(f).items():
                    launches[name] = launches.get(name, 0) + n
    return launches


def _wait_all(procs, logs, timeout: float) -> None:
    """Wait for every rank; raise with its log when one fails."""
    deadline = time.monotonic() + timeout
    while True:
        codes = [p.poll() for p in procs]
        for rank, code in enumerate(codes):
            if code not in (None, 0):
                raise RuntimeError(f"dry-run rank {rank} failed ({code}):\n"
                                   + logs[rank].read_text()[-6000:])
        if all(code == 0 for code in codes):
            return
        if time.monotonic() > deadline:
            raise TimeoutError(f"the dry-run ranks outlasted {timeout} s")
        time.sleep(0.1)


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _checks(n_devices: int, rank: int, dev: torch.device,
            workdir: str) -> None:
    """One rank's dry run: the JAX ``dryrun_multichip``'s checks, each
    raising. The mesh is n_data x n_table with n_table = 2 when
    ``n_devices`` is even, else 1."""
    from .critical_paths import CriticalGraphPaths
    from .finder import DenseKmerFinder
    from .flat_kmers import FlatKmers
    from .models.kmer_index import KmerIndex
    from .ops.build import frequencies_device
    from .parallel import checkpoint, oocbuild
    from .parallel.host_pool import find_kmers_parallel_device
    from .parallel.mesh import build_mesh, coordinates
    from .parallel.sharded import (
        KMER_PAD, PackedTableShards, TableShards, build_packed_shards_sharded,
        frequencies_sharded, make_count_step, make_count_step_packed,
        make_member_step_packed, merge_flat_kmers_all_gather)

    k = K
    index, n_nodes, reads, graph = toy_setup(k, dev)
    n_table = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    n_data = n_devices // n_table
    mesh = build_mesh(n_data, n_table)
    d, t = coordinates(mesh)

    reads = reads[: (len(reads) // n_data) * n_data]
    per = len(reads) // n_data
    all_reads = torch.from_numpy(reads).to(dev)
    mine = all_reads[d * per:(d + 1) * per]
    ref = forward_step(index, n_nodes, k)(all_reads).to(torch.int64)

    # the CSR step over the (data x table) mesh == the one-card step
    shards = TableShards.from_index(index, n_table)
    step = make_count_step(mesh, shards, n_nodes, k)
    counts = step(mine, shards.starts, shards.sizes, shards.row_kmers,
                  shards.row_nodes)
    _require(torch.equal(counts, ref), "sharded counts != one-card counts")

    # the packed-record steps (K2 in shard mode): counts, then membership
    pshards = PackedTableShards.from_index(index, n_table)
    pcols = (pshards.records, pshards.row_kmers, pshards.row_nodes)
    pcounts = make_count_step_packed(mesh, pshards, n_nodes, k)(mine, *pcols)
    _require(torch.equal(pcounts, ref),
             "packed sharded counts != one-card counts")
    mhit = make_member_step_packed(mesh, pshards, k)(mine, *pcols)
    hashes, valid = _window_kmers(all_reads, k)
    hashes, valid = _np(hashes), _np(valid)
    expected_hit = np.zeros(reads.size, dtype=bool)
    expected_hit[valid] = index.has_kmers(hashes[valid].view(np.uint64))
    _require(np.array_equal(_np(mhit), expected_hit.reshape(reads.shape)[
        d * per:(d + 1) * per]),
        "packed sharded membership != one-card has_kmers")

    # the build side's collective: every rank's FlatKmers rows, gathered
    # in rank order, == the host concatenate
    rng = np.random.default_rng(7)
    n_rows = n_devices * 4
    cols = (rng.integers(0, 1 << 62, n_rows).astype(np.uint64),
            rng.integers(1, 99, n_rows).astype(np.uint32),
            rng.integers(0, 999, n_rows).astype(np.uint64),
            rng.random(n_rows).astype(np.float32))
    gh, *_rest = merge_flat_kmers_all_gather(
        None, [c[rank * 4:(rank + 1) * 4] for c in cols])
    _require(np.array_equal(_np(gh).view(np.uint64), cols[0]),
             "all_gather merge mismatch")

    # the find's worklist cut by critical path across the ranks, the
    # rows gathered (uneven counts) and built on the device == the serial
    # find and build
    cgp = CriticalGraphPaths.from_graph(graph, k)
    bounds = np.unique(np.linspace(0, len(cgp), n_devices + 1).astype(int))
    serial = DenseKmerFinder(graph, k=k, max_variant_nodes=4, device=dev)
    serial.find()
    serial_flat = serial.get_flat_kmers(v="0")
    if rank < len(bounds) - 1:
        f = DenseKmerFinder(graph, k=k, max_variant_nodes=4,
                            critical_graph_paths=cgp,
                            start_at_critical_path_number=int(bounds[rank]),
                            stop_at_critical_path_number=int(
                                bounds[rank + 1]), device=dev)
        f.find()
        chunk = f.get_flat_kmers(v="0")
        chunk_cols = (chunk._hashes, chunk._nodes, chunk._ref_offsets,
                      chunk._allele_frequencies)
    else:
        chunk_cols = tuple(np.asarray(c)[:0] for c in (
            serial_flat._hashes, serial_flat._nodes,
            serial_flat._ref_offsets, serial_flat._allele_frequencies))
    mh, mn, mr, ma = merge_flat_kmers_all_gather(None, chunk_cols)
    merged = FlatKmers(_np(mh).view(np.uint64),
                       _np(mn).astype(np.asarray(serial_flat._nodes).dtype),
                       _np(mr).view(np.uint64), _np(ma))
    _require(np.array_equal(merged._hashes, serial_flat._hashes)
             and np.array_equal(merged._nodes, serial_flat._nodes),
             "sharded find != serial find")
    built = KmerIndex.from_flat_kmers(merged, modulo=TOY_MODULO, device=dev)
    ref_built = KmerIndex.from_flat_kmers(serial_flat, modulo=TOY_MODULO,
                                          device=dev)
    for name in ("hashes_to_index", "n_kmers", "kmers", "nodes",
                 "ref_offsets", "frequencies"):
        _require(torch.equal(getattr(built, name), getattr(ref_built, name)),
                 f"device build from the merged rows: {name} differ")

    # the sharded packed build, each table rank holding its slice of the
    # rows == PackedTableShards.from_index, shard for shard
    want = PackedTableShards.from_index(ref_built, n_table)
    got, n_got = build_packed_shards_sharded(
        torch.tensor_split(ref_built.kmers, n_table)[t],
        torch.tensor_split(ref_built.nodes, n_table)[t], mesh=mesh)
    for attr in ("m2_local", "modulo2", "max_scan", "n_table", "has_dup"):
        _require(getattr(got, attr) == getattr(want, attr),
                 f"sharded build's {attr} != host build's")
    _require(np.array_equal(_np(got.records[0]), want.records[t])
             and np.array_equal(_np(got.row_kmers[0, :n_got]),
                                want.row_kmers[t, :n_got]),
             "sharded build records != host build")

    # sharded distinct-ref-offset frequencies == the device path's
    fk = np.asarray(serial_flat._hashes, dtype=np.uint64)
    fo = np.asarray(serial_flat._ref_offsets, dtype=np.uint64)
    part = np.array_split(np.arange(len(fk)), n_devices)[rank]
    _require(np.array_equal(
        _np(frequencies_sharded(fk[part], fo[part])),
        frequencies_device(fk, fo, device=dev)[part]),
        "sharded frequencies != device frequencies")

    # the device finalize of the pooled find (2 spawned workers) == the
    # serial rows
    dev_flat = find_kmers_parallel_device(graph, k, n_workers=2,
                                          max_variant_nodes=4,
                                          mp_context="spawn", device=dev)
    serial_v1 = serial.get_flat_kmers(v="1")
    _require(np.array_equal(_np(dev_flat._hashes).view(np.uint64),
                            serial_v1._hashes)
             and np.array_equal(_np(dev_flat._ref_offsets).view(np.uint64),
                                np.asarray(serial_v1._ref_offsets,
                                           np.uint64)),
             "device finalize != serial rows")

    # checkpoint round trip of the sharded-built shards (each rank writes
    # its own file), served from pre-hashed k-mers == the one-card counts
    prefix = os.path.join(workdir, "shards")
    checkpoint.save_shards(got, prefix, mesh=mesh)
    loaded = checkpoint.load_shards(prefix, mesh=mesh)
    total = -(-reads.size // n_data) * n_data
    q = np.full(total, KMER_PAD, dtype=np.int64)
    q[:reads.size] = np.where(valid, hashes, KMER_PAD)
    q_mine = torch.from_numpy(q).to(dev)[d * (total // n_data):
                                         (d + 1) * (total // n_data)]
    kcounts = make_count_step_packed(mesh, loaded, n_nodes, k,
                                     from_kmers=True)(
        q_mine, loaded.records, loaded.row_kmers, loaded.row_nodes)
    _require(torch.equal(kcounts, ref),
             "checkpoint-served from_kmers counts != one-card counts")

    # the out-of-core build (rows spilled by bucket range, a CSR shard a
    # range) served from its checkpoint, and the worker-spill driver
    own = os.path.join(workdir, f"rank{rank}")
    w = oocbuild.SpillWriter(os.path.join(own, "spill"), index.modulo,
                             n_table)
    w.add_chunk(0, np.asarray(serial_flat._hashes, np.uint64),
                np.asarray(serial_flat._nodes),
                np.asarray(serial_flat._ref_offsets),
                np.asarray(serial_flat._allele_frequencies))
    oocbuild.build_shards_from_spills(os.path.join(own, "spill"),
                                      os.path.join(own, "ooc"))
    ooc = oocbuild.index_from_shard_checkpoint(os.path.join(own, "ooc"), dev)
    _require(torch.equal(ooc.kmers, index.kmers),
             "out-of-core rows != monolithic rows")
    ooc_loaded = checkpoint.load_shards(os.path.join(own, "ooc"), mesh=mesh)
    ocounts = make_count_step(mesh, ooc_loaded, n_nodes, k, from_kmers=True)(
        q_mine, ooc_loaded.starts, ooc_loaded.sizes, ooc_loaded.row_kmers,
        ooc_loaded.row_nodes)
    _require(torch.equal(ocounts, ref),
             "out-of-core checkpoint serve != one-card counts")
    oocbuild.find_and_build_out_of_core(
        graph, k, n_workers=1, workdir=os.path.join(own, "worker"),
        modulo=index.modulo, n_ranges=n_table, max_variant_nodes=4)
    ooc2 = oocbuild.index_from_shard_checkpoint(
        os.path.join(own, "worker", "index"), dev)
    _require(torch.equal(ooc2.kmers, index.kmers)
             and torch.equal(ooc2.nodes, index.nodes),
             "worker-spill rows != monolithic rows")


def _rank_main(init_method: str, world: int, rank: int, device: str,
               workdir: str) -> None:
    from .ops import _kernels
    from .parallel import mesh

    torch.set_num_threads(1)
    dev = mesh.start_process_group(device, init_method, world, rank)
    try:
        _checks(world, rank, dev, workdir)
    finally:
        mesh.stop_process_group()
    with open(os.path.join(workdir, f"launches-{rank}.json"), "w") as f:
        json.dump(_kernels.launch_counts, f)
    print(f"dry-run rank {rank} of {world}: every check held", flush=True)


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
               sys.argv[5])
