"""Command-line interface of the port: ``map_reads`` only, with the
options of graph_kmer_index_tpu's ``map_reads`` (FASTA reads -> window
k-mers -> node hit counts, saved with ``np.save``).

    python -m graph_kmer_index_tpu_torch.cli map_reads -i INDEX -r READS \
        -k 31 -R true -o counts.npy [--device cuda]
"""
from __future__ import annotations

import argparse
import logging
import sys

import numpy as np


def strict_bool(text: str) -> bool:
    """'true'/'1' or 'false'/'0' (any case); argparse's ``type=bool``
    would read 'False' as True."""
    value = text.strip().lower()
    if value in ("true", "1"):
        return True
    if value in ("false", "0"):
        return False
    raise argparse.ArgumentTypeError(
        f"expected true/false/1/0, got {text!r}")


def map_reads(args) -> None:
    from .models.kmer_index import KmerIndex
    from .read_kmers import hash_fasta_file

    if args.table_shards:
        raise NotImplementedError(
            "map_reads --table-shards (sharded serving) is not ported yet; "
            "see ROADMAP.md")
    if args.backend != "device":
        raise NotImplementedError(
            f"map_reads --backend {args.backend} is not ported yet; "
            "see ROADMAP.md")
    if not args.kmer_index:
        raise SystemExit("map_reads needs --kmer-index")
    index = KmerIndex.from_file(args.kmer_index, device=args.device)
    kmers = hash_fasta_file(
        args.reads, args.kmer_size, device=args.device,
        include_reverse_complements=args.include_reverse_complement)
    n_nodes = args.n_nodes or (index.max_node_id() + 1)
    counts = index.map_kmers(kmers, n_nodes)
    np.save(args.out_file_name, counts)
    logging.info("Wrote node counts (%d nodes, %d read kmers) to %s",
                 n_nodes, len(kmers), args.out_file_name)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="graph_kmer_index_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    s = sub.add_parser("map_reads")
    s.add_argument("-i", "--kmer-index", required=False, default=None)
    s.add_argument("-T", "--table-shards", required=False, default=None)
    s.add_argument("-r", "--reads", required=True)
    s.add_argument("-k", "--kmer-size", type=int, default=31)
    s.add_argument("-n", "--n-nodes", type=int, default=0)
    s.add_argument("-R", "--include-reverse-complement", type=strict_bool,
                   default=False)
    s.add_argument("-b", "--backend", default="device",
                   choices=["device", "native"])
    s.add_argument("-o", "--out-file-name", required=True)
    s.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")
    s.set_defaults(func=map_reads)
    return parser


def run_argument_parser(argv) -> None:
    args = build_parser().parse_args(argv)
    args.func(args)


def main() -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s: %(message)s")
    run_argument_parser(sys.argv[1:])


if __name__ == "__main__":
    main()
