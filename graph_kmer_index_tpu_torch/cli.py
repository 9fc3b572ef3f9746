"""Command-line interface of the port: the subcommands of
graph_kmer_index_tpu's CLI over the ported modules (reference
``graph_kmer_index`` entry point, command_line_interface.py:238-689):

make, make_from_flat, make_reverse, make_unique_index,
make_reference_kmer_index, make_unique_variant_kmers,
make_unique_variant_kmers_kivs, sample_kmers_from_structural_variants,
prune_flat_kmers, merge_flat_kmers, make_kmer_frequency_index,
set_frequencies_using_other_index, set_allele_frequencies,
create_counter_index, index, find_critical_paths,
add_reverse_complements, count_kmers, make_graph, map_reads, shard_index,
make_index_out_of_core, reshard_checkpoint, convert_shards_to_packed.

    python -m graph_kmer_index_tpu_torch.cli map_reads -i INDEX -r READS \\
        -k 31 -R true -o counts.npy [--device cuda]

A subcommand that touches a device takes ``--device`` (default ``cuda``;
``cpu`` runs each kernel's plain twin). Every true/false flag is read by
``strict_bool``.

``map_reads -T PREFIX`` serves a shard checkpoint (``shard_index``,
``make_index_out_of_core``, ``reshard_checkpoint``,
``convert_shards_to_packed``) from its bucket-range shards, one rank per
card, over a ``torch.distributed`` group: from ``--dist-init-method
tcp://ADDRESS:PORT --dist-world-size N --dist-rank R``, else from a
launcher's ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT`` (and
``LOCAL_RANK``), else one rank on ``--device``. The checkpoint's shard
count must divide the world; rank 0 writes the counts.

The reference's ``--threads`` parallelism is fork() + POSIX shared memory
+ worklist splits (cli:105-153,574-623). Here worklists split per
interval/chunk, so outputs merge in the same order, and are mapped over a
fork pool (parallel.host_pool.map_over_chunks), serially once CUDA is
initialised in the parent.
"""
from __future__ import annotations

import argparse
import logging
import sys
import time

import numpy as np


def strict_bool(text: str) -> bool:
    """'true'/'1' or 'false'/'0' (any case); argparse's ``type=strict_bool``
    would read 'False' as True."""
    value = text.strip().lower()
    if value in ("true", "1"):
        return True
    if value in ("false", "0"):
        return False
    raise argparse.ArgumentTypeError(
        f"expected true/false/1/0, got {text!r}")


def main() -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s: %(message)s")
    run_argument_parser(sys.argv[1:])


# -- make (SnpKmerFinder sweep, reference cli:44-153) -----------------------

def create_index_single_thread(args, interval=None):
    from . import FlatKmers, SnpKmerFinder
    from .utils.fasta import read_fasta_sequence

    start_position = interval[0] if interval else None
    end_position = interval[1] if interval else None

    graph, reference = args["graph"], None
    if graph is None:
        assert args["reference_fasta"] is not None
        assert args["reference_name"] is not None, \
            "Reference name must be specified"
        # create_index pre-reads the sequence ONCE and shares it with
        # every worklist job via the fork pool's COW pages; parsing the
        # whole FASTA per job (threads*10 jobs) dominated startup
        reference = args.get("reference_sequence")
        if reference is None:
            reference = read_fasta_sequence(args["reference_fasta"],
                                            args["reference_name"])
        assert len(reference) > 0, "Length of ref sequence is 0"

    whitelist = None
    if args["whitelist"] is not None:
        w = FlatKmers.from_file(args["whitelist"])
        whitelist = set(int(h) for h in w._hashes)

    skip_kmers_with_nodes = None
    if args["skip_kmers_with_nodes"] is not None:
        f = FlatKmers.from_file(args["skip_kmers_with_nodes"])
        skip_kmers_with_nodes = set(int(n) for n in f._nodes)

    finder = SnpKmerFinder(
        graph, k=args["kmer_size"], spacing=args["spacing"],
        include_reverse_complements=False,
        pruning=args["pruning"],
        max_kmers_same_position=args["max_kmers_same_position"],
        max_frequency=args["max_frequency"],
        max_variant_nodes=args["max_variant_nodes"],
        only_add_variant_kmers=args["only_add_variant_kmers"],
        whitelist=whitelist,
        only_save_variant_nodes=args["only_save_variant_nodes"],
        start_position=start_position,
        end_position=end_position,
        skip_kmers_with_nodes=skip_kmers_with_nodes,
        only_save_one_node_per_kmer=args["only_save_one_node_per_kmer"],
        reference=reference, device=args["device"])
    kmers = finder.find_kmers()

    if args["include_reverse_complement"]:
        logging.info("Adding reverse complements")
        kmers_revcomp = kmers.get_reverse_complement_flat_kmers(
            args["kmer_size"])
        kmers = FlatKmers.from_multiple_flat_kmers([kmers, kmers_revcomp])
    return kmers


def create_index(args):
    from . import FlatKmers, Graph

    args = vars(args)
    args.pop("func")
    args["graph"] = (Graph.from_file(args["graph_file_name"])
                     if args["graph_file_name"] is not None else None)
    if args["graph"] is None and args.get("reference_fasta") is not None:
        from .utils.fasta import read_fasta_sequence
        args["reference_sequence"] = read_fasta_sequence(
            args["reference_fasta"], args["reference_name"])

    if args["threads"] == 1:
        kmers = create_index_single_thread(args)
    else:
        # same genome-interval worklist split as the reference (cli:122-132)
        n_jobs = args["threads"] * 10
        genome_size = args["genome_size"]
        n_total_start_positions = genome_size // args["spacing"]
        n_positions_each = n_total_start_positions // n_jobs
        intervals = [
            (n_positions_each * i * args["spacing"],
             n_positions_each * (i + 1) * args["spacing"])
            for i in range(n_jobs)]
        from .parallel.host_pool import map_over_chunks
        results = map_over_chunks(
            lambda iv: create_index_single_thread(args, iv), intervals,
            args["threads"])
        kmers = FlatKmers.from_multiple_flat_kmers(results, consume=True)
    kmers.to_file(args["out_file_name"])
    logging.info("Wrote to %s", args["out_file_name"])


# -- index (DenseKmerFinder, reference cli:536-638) --------------------------

def index_command(args):
    from . import (CriticalGraphPaths, FlatKmers, Graph,
                   PositionId)

    graph = Graph.from_file(args.graph)
    critical_paths = args.critical_graph_paths
    if critical_paths is None:
        logging.info("Making critical graph paths since not specified")
        critical_paths = CriticalGraphPaths.from_graph(graph, args.kmer_size)
    position_id = PositionId.from_graph(graph)

    whitelist = None
    if args.whitelist is not None:
        from .models.kmer_index import KmerIndex
        whitelist = KmerIndex.from_file(args.whitelist, device=args.device)

    from .parallel.host_pool import find_kmers_parallel
    t = time.perf_counter()
    flat = find_kmers_parallel(
        graph, args.kmer_size, n_workers=args.n_threads,
        critical_paths=critical_paths, position_id=position_id,
        max_variant_nodes=args.max_variant_nodes,
        only_save_one_node_per_kmer=True,
        whitelist=whitelist,
        checkpoint_dir=args.checkpoint_dir)
    logging.info("Time spent to make indexes: %.2f", time.perf_counter() - t)
    if args.include_reverse_complement:
        logging.info("Adding reverse complements")
        rev = flat.get_reverse_complement_flat_kmers(args.kmer_size)
        flat = FlatKmers.from_multiple_flat_kmers([flat, rev])
    flat.to_file(args.out_file_name)
    logging.info("Wrote final FlatKmers to %s", args.out_file_name)


# -- simple converters --------------------------------------------------------

def make_from_flat(args):
    from . import FlatKmers
    from .models.kmer_index import KmerIndex, MinimalKmerIndex

    flat = FlatKmers.from_file(args.flat_index)
    if args.add_reverse_complements:
        logging.info("Adding reverse complements (k=%d)", args.kmer_size)
        rev = flat.get_reverse_complement_flat_kmers(k=args.kmer_size)
        flat = FlatKmers.from_multiple_flat_kmers([flat, rev])
    if args.make_minimal:
        index = MinimalKmerIndex.from_flat_kmers(flat, modulo=args.hash_modulo)
    else:
        index = KmerIndex.from_flat_kmers(
            flat, modulo=args.hash_modulo,
            skip_frequencies=args.skip_frequencies,
            skip_singletons=args.skip_singletons, device=args.device)
    index.to_file(args.out_file_name)
    logging.info("Done making kmer index")


def make_reverse(args):
    from . import FlatKmers, ReverseKmerIndex
    reverse = ReverseKmerIndex.from_flat_kmers(
        FlatKmers.from_file(args.flat_index))
    reverse.to_file(args.out_file_name)
    logging.info("Wrote reverse index to %s", args.out_file_name)


def make_reference_kmer_index(args):
    from . import FlatKmers, ReferenceKmerIndex
    if args.reference_fasta is not None:
        index = ReferenceKmerIndex.from_linear_reference(
            args.reference_fasta, args.reference_name, args.kmer_size,
            args.only_store_kmers)
    else:
        index = ReferenceKmerIndex.from_flat_kmers(
            FlatKmers.from_file(args.flat_index))
    index.to_file(args.out_file_name)
    logging.info("Saved reference kmer index to %s", args.out_file_name)


def make_unique_index(args):
    from . import FlatKmers, Graph, ReverseKmerIndex, UniqueKmerIndex
    graph = Graph.from_file(args.graph)
    reverse = ReverseKmerIndex.from_file(args.reverse)
    flat = FlatKmers.from_file(args.flat_index)
    unique = UniqueKmerIndex.from_flat_kmers_and_snps_graph(
        flat, graph, reverse)
    unique.to_file(args.out_file_name)


def prune_flat_kmers(args):
    """Drop consecutive duplicate (hash, ref_offset) rows (vectorized; the
    reference's loop at cli:210-237 computes this but never writes the
    result — an evident bug; we write it)."""
    from . import FlatKmers
    index = FlatKmers.from_file(args.flat_index)
    h = np.asarray(index._hashes)
    r = np.asarray(index._ref_offsets)
    keep = np.ones(len(h), dtype=bool)
    if len(h) > 1:
        keep[1:] = (h[1:] != h[:-1]) | (r[1:] != r[:-1])
    new = FlatKmers(h[keep], np.asarray(index._nodes)[keep], r[keep],
                    np.asarray(index._allele_frequencies)[keep])
    new.to_file(args.out_file_name)
    logging.info("Kept %d/%d rows", int(keep.sum()), len(keep))


def merge_flat_kmers(args):
    from . import FlatKmers
    new = FlatKmers.from_multiple_flat_kmers(
        [FlatKmers.from_file(f) for f in args.flat_kmers.split(",")])
    new.to_file(args.out_file_name)
    logging.info("Wrote merged index to %s", args.out_file_name)


def make_kmer_frequencies(args):
    from . import KmerFrequencyIndex, ReferenceKmerIndex
    ref_kmers = ReferenceKmerIndex.from_file(args.reference_kmers)
    index = KmerFrequencyIndex.from_kmers(ref_kmers.kmers)
    index.to_file(args.out_file_name)
    logging.info("Wrote to %s", args.out_file_name)


def set_frequencies_using_other_index(args):
    from .models.kmer_index import KmerIndex
    index = KmerIndex.from_file(args.kmer_index, device=args.device)
    other = KmerIndex.from_file(args.kmer_index_with_frequencies,
                                device=args.device)
    index.set_frequencies_using_other_index(other, args.multiplier)
    index.to_file(args.kmer_index)
    logging.info("Wrote index to %s", args.kmer_index)


def set_allele_frequencies(args):
    from .models.kmer_index import KmerIndex
    index = KmerIndex.from_file(args.kmer_index, device=args.device)
    frequencies = np.load(args.frequencies)
    index.set_allele_frequencies(frequencies)
    index.to_file(args.kmer_index)
    logging.info("Wrote index to %s", args.kmer_index)


def create_counter_index(args):
    from .models.kmer_index import CounterKmerIndex, KmerIndex
    from .utils.serialize import to_file
    kmer_index = KmerIndex.from_file(args.kmer_index, device=args.device)
    counter_index = CounterKmerIndex.from_kmer_index(kmer_index, args.modulo)
    to_file(counter_index, args.out_file_name)


def find_critical_paths(args):
    from . import CriticalGraphPaths, Graph
    from .utils.serialize import to_file
    graph = Graph.from_file(args.graph)
    critical_paths = CriticalGraphPaths.from_graph(graph, args.kmer_size)
    critical_paths._make_index()
    to_file(critical_paths, args.out_file_name)
    logging.info("Wrote to %s", args.out_file_name)


def add_reverse_complements(args):
    from . import FlatKmers
    flat = FlatKmers.from_file(args.flat_kmers)
    rev = flat.get_reverse_complement_flat_kmers(k=args.kmer_size)
    flat = FlatKmers.from_multiple_flat_kmers([flat, rev])
    flat.to_file(args.out_file_name)
    logging.info("Saved new flat kmers with reverse complements to %s",
                 args.out_file_name)


def count_kmers(args):
    from . import FlatKmers, KmerCounter
    from .utils.serialize import to_file
    counter = KmerCounter.from_flat_kmersv2(
        FlatKmers.from_file(args.flat_kmers), args.modulo,
        args.subsample_ratio)
    to_file(counter, args.out_file_name)
    logging.info("Wrote counter to %s", args.out_file_name)


# -- variant kmers ------------------------------------------------------------

def make_unique_variant_kmers(args):
    from . import (FlatKmers, Graph, PositionId, UniqueVariantKmersFinder,
                   VariantToNodes, VcfVariants)
    from .models.kmer_index import KmerIndex
    from .utils.serialize import from_file

    graph = Graph.from_file(args.graph)
    variant_to_nodes = VariantToNodes.from_file(args.variant_to_nodes)
    kmer_index = (KmerIndex.from_file(args.kmer_index, device=args.device)
                  if args.kmer_index else None)
    if kmer_index is None and args.kmer_counter:
        kmer_index = from_file(args.kmer_counter)
    position_id = (PositionId.from_graph(graph)
                   if args.use_dense_kmer_finder else None)

    logging.info("Reading all variants")
    variants = VcfVariants.from_vcf(args.vcf, skip_index=True,
                                    dont_encode_chromosomes=True)
    chunks = variants.get_chunks(chunk_size=args.chunk_size)

    def run_chunk(chunk):
        finder = UniqueVariantKmersFinder(
            graph, variant_to_nodes, chunk, args.kmer_size,
            args.max_variant_nodes,
            kmer_index_with_frequencies=kmer_index,
            do_not_choose_lowest_frequency_kmers=
            args.do_not_choose_lowest_frequency_kmers,
            use_dense_kmer_finder=args.use_dense_kmer_finder,
            position_id_index=position_id,
            use_simple=args.simple)
        if getattr(args, "_batched", False):
            return finder.find_unique_kmers_batched()
        return finder.find_unique_kmers()

    from .parallel.host_pool import map_over_chunks
    all_flat = map_over_chunks(run_chunk, chunks, args.n_threads)
    merged = FlatKmers.from_multiple_flat_kmers(all_flat, consume=True)
    merged.to_file(args.out_file_name)
    logging.info("Wrote to %s", args.out_file_name)


def make_unique_variant_kmers_batched(args):
    """Replacement for the reference's external C++ ``kivs`` path
    (make_unique_variant_kmers_kivs, cli:391-426): candidate windows for
    all variants built as dense arrays, one hashing kernel pass, one
    batched frequency lookup, argmin selection per variant
    (UniqueVariantKmersFinder.find_unique_kmers_batched)."""
    if getattr(args, "minimize_overlaps", False) or \
            getattr(args, "align_windows", False):
        # the reference forwards these to the external kivs C++ library
        # (command_line_interface.py:413-415); this implementation uses
        # the reference's own candidate scoring rule instead, which has
        # no overlap-minimization/window-alignment modes — accept the
        # flags for CLI compatibility but say so rather than silently
        # ignoring them
        logging.warning(
            "--minimize-overlaps/--align-windows are kivs-specific "
            "selection modes; this implementation selects signatures "
            "with the reference scoring rule and ignores them")
    args.use_dense_kmer_finder = False
    args.do_not_choose_lowest_frequency_kmers = False
    args.simple = False
    args._batched = True
    make_unique_variant_kmers(args)


def _process_group_args(args) -> dict:
    """start_process_group's arguments: the --dist-* flags, else a
    launcher's environment, else one rank on --device."""
    import os

    group = {"device": args.device}
    if args.dist_init_method is not None:
        group.update(init_method=args.dist_init_method,
                     world_size=args.dist_world_size, rank=args.dist_rank)
    elif {"RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"} <= set(
            os.environ):
        env = os.environ
        group.update(
            init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
            world_size=int(env["WORLD_SIZE"]), rank=int(env["RANK"]))
        if "LOCAL_RANK" in env:
            group["local_rank"] = int(env["LOCAL_RANK"])
    return group


def _map_reads_sharded(args) -> None:
    """map_reads against a SHARDED table checkpoint: the table never
    materializes whole. Each rank holds its bucket-range shard (read
    straight from its own checkpoint file onto its card), hashes the
    reads (K1), answers its data slice of the queries for the buckets it
    owns, and the node counts merge with one all_reduce."""
    import torch
    import torch.distributed as dist

    from .parallel.checkpoint import load_shards, manifest_info
    from .parallel.mesh import (build_mesh, coordinates, start_process_group,
                                stop_process_group)
    from .parallel.sharded import (KMER_PAD, make_count_step,
                                   make_count_step_packed)
    from .read_kmers import hash_fasta_file

    info = manifest_info(args.table_shards)
    n_table = info["n_table"]
    started = not dist.is_initialized()
    if started:
        start_process_group(**_process_group_args(args))
    try:
        world = dist.get_world_size()
        if world < n_table or world % n_table:
            raise SystemExit(
                f"{world} device(s) cannot host {n_table} table shards "
                "evenly; re-shard the checkpoint or change the device count")
        n_data = world // n_table
        mesh = build_mesh(n_data, n_table)
        shards = load_shards(args.table_shards, mesh=mesh)
        dev = shards.row_nodes.device
        kmers = hash_fasta_file(
            args.reads, args.kmer_size, device=dev,
            include_reverse_complements=args.include_reverse_complement)
        n_kmers = len(kmers)
        # n_nodes: explicit flag > manifest hint > the shards' max node
        n_nodes = args.n_nodes
        if not n_nodes and "max_node" in info:
            n_nodes = info["max_node"] + 1
        elif not n_nodes:
            top = shards.row_nodes.max().to(torch.int64)
            dist.all_reduce(top, op=dist.ReduceOp.MAX)
            n_nodes = int(top) + 1
        per = -(-max(1, n_kmers) // n_data)
        d, _ = coordinates(mesh)
        q = torch.full((per * n_data,), KMER_PAD, dtype=torch.int64,
                       device=dev)
        if n_kmers:
            q[:n_kmers] = torch.cat(kmers.segments)
        q = q[d * per:(d + 1) * per]
        if info["kind"] == "packed":
            step = make_count_step_packed(mesh, shards, n_nodes,
                                          args.kmer_size, from_kmers=True)
            counts = step(q, shards.records, shards.row_kmers,
                          shards.row_nodes)
        else:  # CSR layout (tables the packed records refuse, e.g. poly-A)
            step = make_count_step(mesh, shards, n_nodes, args.kmer_size,
                                   from_kmers=True)
            counts = step(q, shards.starts, shards.sizes, shards.row_kmers,
                          shards.row_nodes)
        if dist.get_rank() == 0:
            np.save(args.out_file_name, counts.cpu().numpy())
            logging.info("Wrote node counts (%d nodes, %d read kmers, %d "
                         "table shards x %d data shards) to %s", n_nodes,
                         n_kmers, n_table, n_data, args.out_file_name)
    finally:
        if started:
            stop_process_group()


def map_reads(args) -> None:
    """Extra subcommand (the reference delegates read mapping to the
    external kmer_mapper package): FASTA reads -> window kmers -> node
    hit counts. ``--backend device``: hashed and looked up on
    ``--device`` without the query batch leaving it; ``native``: looked
    up by the host C++ library. With ``--table-shards``, served from a
    shard checkpoint over a process group (:func:`_map_reads_sharded`)."""
    from .models.kmer_index import KmerIndex
    from .read_kmers import hash_fasta_file

    if args.table_shards:
        return _map_reads_sharded(args)
    if not args.kmer_index:
        raise SystemExit("map_reads needs --kmer-index or --table-shards")
    index = KmerIndex.from_file(args.kmer_index, device=args.device)
    kmers = hash_fasta_file(
        args.reads, args.kmer_size, device=args.device,
        include_reverse_complements=args.include_reverse_complement)
    n_nodes = args.n_nodes or (index.max_node_id() + 1)
    counts = index.map_kmers(kmers, n_nodes, backend=args.backend)
    np.save(args.out_file_name, counts)
    logging.info("Wrote node counts (%d nodes, %d read kmers) to %s",
                 n_nodes, len(kmers), args.out_file_name)


def shard_index(args):
    """Extra subcommand: split a whole index file into a shard checkpoint
    (per-shard npz + manifest) for multi-card serving: the build-once /
    serve-anywhere path. Host work: the index is read to the host."""
    from .models.kmer_index import KmerIndex
    from .parallel.checkpoint import save_shards
    from .parallel.sharded import PackedTableShards, TableShards

    index = KmerIndex.from_file(args.kmer_index, device="cpu")
    if args.layout == "packed":
        shards = PackedTableShards.from_index(index, args.n_shards)
    else:
        shards = TableShards.from_index(index, args.n_shards)
    paths = save_shards(shards, args.out_prefix)
    logging.info("Wrote %d files (%d %s shards) to %s*", len(paths),
                 args.n_shards, args.layout, args.out_prefix)


def make_index_out_of_core(args):
    """Extra subcommand: genome-scale find+build with bounded memory
    (bucket-range disk spills; parallel/oocbuild.py). The reference's
    pipeline holds every row in memory at once
    (command_line_interface.py:601-616), which cannot reach its own
    --genome-size default of 3e9 on a 128 GB host; this one streams.
    Produces a shard checkpoint servable by ``map_reads --table-shards``
    or reassembled with ``oocbuild.index_from_shard_checkpoint``. Host
    work (the find workers stay off the card)."""
    from . import CriticalGraphPaths, Graph
    from .parallel.oocbuild import find_and_build_out_of_core

    graph = Graph.from_file(args.graph)
    critical_paths = args.critical_graph_paths
    if critical_paths is None:
        logging.info("Making critical graph paths since not specified")
        critical_paths = CriticalGraphPaths.from_graph(graph,
                                                       args.kmer_size)
    res = find_and_build_out_of_core(
        graph, args.kmer_size, n_workers=args.n_threads,
        workdir=args.workdir, modulo=args.hash_modulo,
        n_ranges=args.n_ranges, critical_paths=critical_paths,
        skip_frequencies=args.skip_frequencies,
        delete_spills=not args.keep_spills,
        checkpoint_dir=args.checkpoint_dir,
        out_prefix=args.out_prefix, spill_cols=args.columns,
        n_spill_passes=args.spill_passes,
        max_variant_nodes=args.max_variant_nodes,
        only_save_one_node_per_kmer=args.only_save_one_node_per_kmer)
    logging.info("Out-of-core index done: %d rows in %d shards at %s*",
                 res["total_rows"], res["n_table"], res["prefix"])
    return res


def convert_shards_to_packed(args):
    """Extra subcommand: out-of-core CSR shard checkpoint -> out-of-core
    PACKED shard checkpoint (the one-record-per-query serving layout,
    ops/lookup.py) without ever materializing the whole table; see
    parallel/oocbuild.py:convert_checkpoint_to_packed."""
    from .parallel.oocbuild import convert_checkpoint_to_packed

    res = convert_checkpoint_to_packed(
        args.csr_prefix, args.workdir, out_prefix=args.out_prefix,
        n_table=args.n_shards, n_workers=args.n_threads,
        delete_spills=not args.keep_spills)
    logging.info("Packed checkpoint: %d rows in %d shards at %s* "
                 "(modulo2=%d)", res["total_rows"], res["n_table"],
                 res["prefix"], res["modulo2"])
    return res


def reshard_checkpoint_command(args):
    """Extra subcommand: merge adjacent bucket-range shards of a CSR
    checkpoint (build with many ranges for bounded memory, serve with
    one shard per card); parallel/oocbuild.py:reshard_checkpoint."""
    from .parallel.oocbuild import reshard_checkpoint

    res = reshard_checkpoint(args.in_prefix, args.out_prefix,
                             args.n_shards)
    logging.info("Resharded to %d shards (%d rows) at %s*",
                 res["n_table"], res["total_rows"], res["prefix"])
    return res


def make_graph(args):
    """Extra subcommand (not in the reference CLI — the reference relies
    on the external obgraph package for graph construction)."""
    from .graph_builder import build_graph_from_files
    graph, v2n = build_graph_from_files(args.reference_fasta, args.vcf)
    graph.to_file(args.out_file_name)
    if args.variant_to_nodes_out:
        v2n.to_file(args.variant_to_nodes_out)
    logging.info("Wrote graph (%d nodes) to %s", graph.n_nodes(),
                 args.out_file_name)


def sample_kmers_from_structural_variants_command(args):
    from . import Graph, VariantToNodes
    from .structural_variants import sample_kmers_from_structural_variants
    from .utils.serialize import from_file

    graph = Graph.from_file(args.graph)
    variant_to_nodes = VariantToNodes.from_file(args.variant_to_nodes)
    kmer_index = from_file(args.kmer_index) if args.kmer_index else None
    if kmer_index is None and args.kmer_counter:
        kmer_index = from_file(args.kmer_counter)
    kmers = sample_kmers_from_structural_variants(
        graph, variant_to_nodes, kmer_index, args.kmer_size)
    kmers.to_file(args.out_file_name)


# -- parser -------------------------------------------------------------------

def _load_pickled(file_name):
    from .utils.serialize import from_file
    return from_file(file_name)


def _add_device(subparser) -> None:
    subparser.add_argument("--device", default="cuda",
                           help="torch device to run on (default cuda)")


def build_argument_parser():
    """The full subcommand parser (separate from run_argument_parser so
    tools/tests can introspect the registered subcommands)."""
    parser = argparse.ArgumentParser(
        description="Graph Kmer Index on PyTorch/CUDA.",
        prog="graph_kmer_index_tpu_torch",
        formatter_class=lambda prog: argparse.HelpFormatter(
            prog, max_help_position=50, width=100))
    subparsers = parser.add_subparsers()

    s = subparsers.add_parser("make")
    s.add_argument("-g", "--graph_file_name", required=False)
    s.add_argument("-o", "--out_file_name", required=True)
    s.add_argument("-k", "--kmer_size", type=int, default=31)
    s.add_argument("-r", "--include-reverse-complement", type=strict_bool,
                   default=False)
    s.add_argument("-s", "--spacing", type=int, default=31)
    s.add_argument("-p", "--pruning", type=strict_bool, default=False)
    s.add_argument("-m", "--max-kmers-same-position", type=int,
                   default=100000)
    s.add_argument("-M", "--max-frequency", type=int, default=10000000)
    s.add_argument("-v", "--max-variant-nodes", type=int, default=100000)
    s.add_argument("-V", "--only-add-variant-kmers", type=strict_bool, default=False)
    s.add_argument("-N", "--only-save-variant-nodes", type=strict_bool,
                   default=False)
    s.add_argument("-O", "--only-save-one-node-per-kmer", type=strict_bool,
                   default=False)
    s.add_argument("-S", "--skip-kmers-with-nodes", required=False)
    s.add_argument("-w", "--whitelist", required=False)
    s.add_argument("-t", "--threads", type=int, default=1)
    s.add_argument("-G", "--genome-size", type=int, default=3000000000)
    s.add_argument("-R", "--reference-fasta", required=False)
    s.add_argument("-n", "--reference-name", required=False)
    _add_device(s)
    s.set_defaults(func=create_index)

    s = subparsers.add_parser("make_from_flat")
    s.add_argument("-o", "--out_file_name", required=True)
    s.add_argument("-f", "--flat-index", required=True)
    s.add_argument("-m", "--hash_modulo", type=int, default=452930477)
    s.add_argument("-S", "--skip-frequencies", type=strict_bool, default=False)
    s.add_argument("-s", "--skip-singletons", type=strict_bool, default=False)
    s.add_argument("-M", "--make-minimal", type=strict_bool, default=False)
    s.add_argument("-r", "--add-reverse-complements", type=strict_bool,
                   default=False)
    s.add_argument("-k", "--kmer-size", type=int, default=31)
    _add_device(s)
    s.set_defaults(func=make_from_flat)

    s = subparsers.add_parser("make_reverse")
    s.add_argument("-f", "--flat-index", required=True)
    s.add_argument("-o", "--out-file-name", required=True)
    s.set_defaults(func=make_reverse)

    s = subparsers.add_parser("make_unique_index")
    s.add_argument("-f", "--flat-index", required=True)
    s.add_argument("-g", "--graph", required=True)
    s.add_argument("-r", "--reverse", required=True)
    s.add_argument("-o", "--out-file-name", required=True)
    s.set_defaults(func=make_unique_index)

    s = subparsers.add_parser("make_reference_kmer_index")
    s.add_argument("-f", "--flat-index", required=False)
    s.add_argument("-r", "--reference-fasta", required=False)
    s.add_argument("-n", "--reference-name", required=False)
    s.add_argument("-k", "--kmer-size", type=int, default=16)
    s.add_argument("-o", "--out-file-name", required=True)
    s.add_argument("-O", "--only-store-kmers", type=strict_bool, default=False)
    s.set_defaults(func=make_reference_kmer_index)

    for name, func in (
            ("make_unique_variant_kmers", make_unique_variant_kmers),
            ("make_unique_variant_kmers_kivs",
             make_unique_variant_kmers_batched)):
        s = subparsers.add_parser(name)
        s.add_argument("-g", "--graph", required=True)
        s.add_argument("-V", "--variant_to_nodes", required=True)
        s.add_argument("-N", "--node-to-variants", required=False)
        s.add_argument("-H", "--haplotype-matrix", required=False)
        s.add_argument("-k", "--kmer-size", required=True, type=int)
        s.add_argument("-i", "--kmer-index", required=False)
        s.add_argument("-I", "--kmer-counter", required=False)
        s.add_argument("-p", "--position-id-index", required=False)
        s.add_argument("-D", "--use-dense-kmer-finder", type=strict_bool,
                       default=False)
        s.add_argument("-o", "--out-file-name", required=True)
        s.add_argument("-v", "--vcf", required=False)
        s.add_argument("-t", "--n-threads", type=int, default=1)
        s.add_argument("-c", "--chunk-size", type=int, default=10000)
        s.add_argument("-m", "--max-variant-nodes", type=int, default=6)
        s.add_argument("-d", "--do-not-choose-lowest-frequency-kmers",
                       type=strict_bool, default=False)
        s.add_argument("-O", "--minimize-overlaps", action="store_true")
        s.add_argument("-A", "--align-windows", action="store_true")
        s.add_argument("-S", "--simple", type=strict_bool, default=False)
        _add_device(s)
        s.set_defaults(func=func)

    s = subparsers.add_parser("map_reads")
    s.add_argument("-i", "--kmer-index", required=False, default=None)
    s.add_argument("-T", "--table-shards", required=False, default=None,
                   help="serve from a sharded checkpoint prefix "
                        "(parallel/checkpoint.py) instead of a whole "
                        "index file")
    s.add_argument("-r", "--reads", required=True)
    s.add_argument("-k", "--kmer-size", type=int, default=31)
    s.add_argument("-n", "--n-nodes", type=int, default=0)
    s.add_argument("-R", "--include-reverse-complement", type=strict_bool,
                   default=False)
    s.add_argument("-b", "--backend", default="device",
                   choices=["device", "native"])
    s.add_argument("-o", "--out-file-name", required=True)
    s.add_argument("--dist-init-method", default=None,
                   help="with -T: the process group's tcp://ADDRESS:PORT")
    s.add_argument("--dist-world-size", type=int, default=1)
    s.add_argument("--dist-rank", type=int, default=0)
    _add_device(s)
    s.set_defaults(func=map_reads)

    s = subparsers.add_parser("shard_index")
    s.add_argument("-i", "--kmer-index", required=True)
    s.add_argument("-n", "--n-shards", type=int, required=True)
    s.add_argument("-l", "--layout", default="packed",
                   choices=["packed", "csr"])
    s.add_argument("-o", "--out-prefix", required=True)
    s.set_defaults(func=shard_index)

    s = subparsers.add_parser("make_index_out_of_core")
    s.add_argument("-g", "--graph", required=True)
    s.add_argument("-c", "--critical_graph_paths", required=False,
                   type=_load_pickled)
    s.add_argument("-k", "--kmer-size", type=int, default=31)
    s.add_argument("-d", "--workdir", required=True,
                   help="spill + default output directory")
    s.add_argument("-o", "--out-prefix", required=False, default=None,
                   help="shard checkpoint prefix (default WORKDIR/index)")
    s.add_argument("-t", "--n-threads", type=int, default=1)
    s.add_argument("-m", "--hash-modulo", type=int, default=452930477)
    s.add_argument("-n", "--n-ranges", type=int, default=32,
                   help="bucket ranges == shards; peak memory ~rows/n")
    s.add_argument("-v", "--max-variant-nodes", type=int, default=5)
    s.add_argument("-O", "--only-save-one-node-per-kmer", type=strict_bool,
                   default=False)
    s.add_argument("--skip-frequencies", type=strict_bool, default=False)
    s.add_argument("--keep-spills", type=strict_bool, default=False)
    s.add_argument("--columns", default="full", choices=["full", "kn"],
                   help="'kn' spills/stores only the serving columns "
                        "(kmers+nodes): half the disk, counts/membership "
                        "serving only")
    s.add_argument("--spill-passes", type=int, default=1,
                   help="find the graph N times, each pass spilling + "
                        "building only 1/N of the bucket ranges: peak "
                        "disk ~spill/N + checkpoint")
    s.add_argument("--checkpoint-dir", required=False, default=None,
                   help="also persist per-chunk find results; a killed "
                        "run resumes without re-walking the graph")
    s.set_defaults(func=make_index_out_of_core)

    s = subparsers.add_parser("reshard_checkpoint")
    s.add_argument("-i", "--in-prefix", required=True)
    s.add_argument("-o", "--out-prefix", required=True)
    s.add_argument("-n", "--n-shards", type=int, required=True)
    s.set_defaults(func=reshard_checkpoint_command)

    s = subparsers.add_parser("convert_shards_to_packed")
    s.add_argument("-i", "--csr-prefix", required=True)
    s.add_argument("-d", "--workdir", required=True)
    s.add_argument("-o", "--out-prefix", required=False, default=None)
    s.add_argument("-n", "--n-shards", type=int, default=None,
                   help="packed shard count (default: same as CSR)")
    s.add_argument("-t", "--n-threads", type=int, default=1)
    s.add_argument("--keep-spills", type=strict_bool, default=False)
    s.set_defaults(func=convert_shards_to_packed)

    s = subparsers.add_parser("make_graph")
    s.add_argument("-R", "--reference-fasta", required=True)
    s.add_argument("-v", "--vcf", required=True)
    s.add_argument("-o", "--out-file-name", required=True)
    s.add_argument("-V", "--variant-to-nodes-out", required=False)
    s.set_defaults(func=make_graph)

    s = subparsers.add_parser("sample_kmers_from_structural_variants")
    s.add_argument("-g", "--graph", required=True)
    s.add_argument("-V", "--variant_to_nodes", required=True)
    s.add_argument("-k", "--kmer-size", required=True, type=int)
    s.add_argument("-i", "--kmer-index", required=False)
    s.add_argument("-I", "--kmer-counter", required=False)
    s.add_argument("-o", "--out-file-name", required=True)
    s.add_argument("-t", "--n-threads", type=int, default=1)
    s.set_defaults(func=sample_kmers_from_structural_variants_command)

    s = subparsers.add_parser("prune_flat_kmers")
    s.add_argument("-f", "--flat-index", required=True)
    s.add_argument("-o", "--out-file-name", required=True)
    s.set_defaults(func=prune_flat_kmers)

    s = subparsers.add_parser("merge_flat_kmers")
    s.add_argument("-f", "--flat-kmers", required=True)
    s.add_argument("-o", "--out-file-name", required=True)
    s.set_defaults(func=merge_flat_kmers)

    s = subparsers.add_parser("make_kmer_frequency_index")
    s.add_argument("-r", "--reference-kmers", required=True)
    s.add_argument("-o", "--out-file-name", required=True)
    s.set_defaults(func=make_kmer_frequencies)

    s = subparsers.add_parser("set_frequencies_using_other_index")
    s.add_argument("-i", "--kmer-index", required=True)
    s.add_argument("-f", "--kmer-index-with-frequencies", required=True)
    s.add_argument("-m", "--multiplier", type=int, default=1)
    _add_device(s)
    s.set_defaults(func=set_frequencies_using_other_index)

    s = subparsers.add_parser("set_allele_frequencies")
    s.add_argument("-i", "--kmer-index", required=True)
    s.add_argument("-f", "--frequencies", required=True)
    _add_device(s)
    s.set_defaults(func=set_allele_frequencies)

    s = subparsers.add_parser("create_counter_index")
    s.add_argument("-i", "--kmer-index", required=True)
    s.add_argument("-o", "--out-file-name", required=True)
    s.add_argument("-m", "--modulo", type=int, default=200000033)
    _add_device(s)
    s.set_defaults(func=create_counter_index)

    s = subparsers.add_parser("index")
    s.add_argument("-g", "--graph", required=True)
    s.add_argument("-c", "--critical_graph_paths", required=False,
                   type=_load_pickled)
    s.add_argument("-p", "--position_id", required=False)
    s.add_argument("-k", "--kmer-size", type=int, default=31)
    s.add_argument("-o", "--out-file-name", required=True)
    s.add_argument("-t", "--n-threads", type=int, default=1)
    s.add_argument("-w", "--whitelist", required=False)
    s.add_argument("-r", "--include-reverse-complement", type=strict_bool,
                   default=False)
    s.add_argument("-O", "--only-save-one-node-per-kmer", type=strict_bool,
                   default=False)
    s.add_argument("-v", "--max-variant-nodes", type=int, default=5)
    s.add_argument("--checkpoint-dir", required=False, default=None,
                   help="persist each finished critical-path chunk here; "
                        "an interrupted run resumes from completed chunks")
    _add_device(s)
    s.set_defaults(func=index_command)

    s = subparsers.add_parser("find_critical_paths")
    s.add_argument("-g", "--graph", required=True)
    s.add_argument("-k", "--kmer-size", type=int, default=31)
    s.add_argument("-o", "--out-file-name", required=True)
    s.set_defaults(func=find_critical_paths)

    s = subparsers.add_parser("add_reverse_complements")
    s.add_argument("-f", "--flat-kmers", required=True)
    s.add_argument("-o", "--out-file-name", required=True)
    s.add_argument("-k", "--kmer-size", type=int, required=True)
    s.set_defaults(func=add_reverse_complements)

    s = subparsers.add_parser("count_kmers")
    s.add_argument("-f", "--flat-kmers", required=True)
    s.add_argument("-o", "--out-file-name", required=True)
    s.add_argument("-m", "--modulo", type=int, default=0)
    s.add_argument("-s", "--subsample-ratio", type=int, default=1)
    s.set_defaults(func=count_kmers)
    return parser


def run_argument_parser(args):
    parser = build_argument_parser()
    if len(args) == 0:
        parser.print_help()
        sys.exit(1)

    parsed = parser.parse_args(args)
    if not hasattr(parsed, "func"):
        parser.print_help()
        sys.exit(1)
    parsed.func(parsed)


if __name__ == "__main__":
    main()
