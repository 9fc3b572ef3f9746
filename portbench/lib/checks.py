"""The comparisons that decide ``correct``: the port's index, read hashes
and node counts against the plain reference. Every comparison is exact,
so every limit is 0: each number is a count of entries that differ."""
from __future__ import annotations

import numpy as np
import torch

from . import reference

LIMIT = 0


def port_columns(index, dev) -> dict:
    """The columns of the port's ``KmerIndex`` that the reference judges,
    as int64 tensors on ``dev``."""
    def col(value):
        if isinstance(value, torch.Tensor):
            return value.to(dev).to(torch.int64)
        return torch.from_numpy(np.asarray(value).astype(np.int64)).to(dev)

    return {name: col(getattr(index, name))
            for name in ("kmers", "nodes", "ref_offsets", "frequencies",
                         "hashes_to_index", "n_kmers")}


def index_checks(index, rows, modulo: int, dev) -> list:
    """(name, mismatches, limit) of the index against the reference's
    rows (k-mers, nodes, offsets)."""
    found = reference.compare_index(port_columns(index, dev), *rows, modulo)
    return [(name, value, LIMIT) for name, value in found.items()]


def mismatches(got: torch.Tensor, want: torch.Tensor) -> int:
    """Entries that differ, with every entry that one side lacks."""
    n = min(got.shape[0], want.shape[0])
    return (int((got[:n].to(want.device) != want[:n]).sum())
            + abs(got.shape[0] - want.shape[0]))


def count_checks(kept: dict, reads_of, table, n_nodes: int, dev) -> int:
    """Node counts that differ from the reference's, summed over the kept
    requests: ``kept`` {request number: (pool item, counts as numpy)},
    ``reads_of(item)`` the item's reads on ``dev``, ``table`` the
    reference's (k-mers, nodes) to join against."""
    want = {}
    total = 0
    for item, counts in kept.values():
        if item not in want:
            queries = reference.batch_hashes(reads_of(item))
            want[item] = reference.node_counts(*table, queries, n_nodes)
            del queries
        total += mismatches(torch.from_numpy(np.asarray(counts)), want[item])
    return total
