"""``checks.index_checks`` by blocks of buckets, for an index too large to
be judged whole beside itself on one card: the port's index against the
reference's rows, one range of buckets under the reference modulo at a
time. Every row of a k-mer lies in one bucket, so a block holds all the
rows that a frequency counts.

Each number is a count of entries that differ, summed over the blocks,
and every limit is 0, as in ``checks.py``:

- ``index_rows``: in each block, rows that differ once both sides are
  sorted by k-mer, node and offset, plus the difference in row count;
- ``index_frequencies``: frequencies that differ, in that order, plus
  the difference in row count;
- ``index_layout``: bucket starts and sizes that differ from the
  reference rows' own layout, and the port's rows out of bucket order.

The port's columns (tensors, as a build leaves them) are read where they
lie, in their own dtypes; a block takes copies of its own rows only.
"""
from __future__ import annotations

import torch

from . import reference
from .checks import LIMIT

# rows, of the larger side, that a block holds on average
BLOCK_ROWS = 1 << 26


def _buckets(kmers: torch.Tensor, modulo: int) -> torch.Tensor:
    """Each row's bucket under ``modulo``, int32 where it fits."""
    dtype = torch.int32 if modulo < 2 ** 31 else torch.int64
    out = torch.empty(kmers.shape[0], dtype=dtype, device=kmers.device)
    for lo in range(0, kmers.shape[0], BLOCK_ROWS):
        out[lo:lo + BLOCK_ROWS] = kmers[lo:lo + BLOCK_ROWS] % modulo
    return out


def _rows_and_frequencies(port, ref):
    """(rows that differ, frequencies that differ) of one block: ``port``
    (k-mers, nodes, offsets, frequencies) and ``ref`` (k-mers, nodes,
    offsets), int64."""
    n_port, n_ref = port[0].shape[0], ref[0].shape[0]
    diff = abs(n_port - n_ref)
    n = min(n_port, n_ref)
    if n == 0:
        return diff, diff
    freqs = reference.frequencies(ref[0], ref[2])
    r_order, r_key = reference.row_order(*ref)
    p_order, p_key = reference.row_order(*port[:3])
    r_order, p_order = r_order[:n], p_order[:n]
    rows = int(((port[0][p_order] != ref[0][r_order])
                | (p_key[p_order] != r_key[r_order])).sum())
    bad_freqs = int((port[3][p_order] != freqs[r_order]).sum())
    return rows + diff, bad_freqs + diff


def index_checks(index, rows, modulo: int, dev) -> list:
    """(name, mismatches, limit) of the port's ``KmerIndex`` against the
    reference's rows (k-mers, nodes, offsets), by blocks of buckets."""
    modulo = int(modulo)
    r_kmers, r_nodes, r_offsets = rows
    p_kmers, p_nodes, p_offsets, p_freqs, p_starts, p_sizes = (
        getattr(index, name).to(dev) for name in (
            "kmers", "nodes", "ref_offsets", "frequencies",
            "hashes_to_index", "n_kmers"))
    p_bucket = _buckets(p_kmers, modulo)
    r_bucket = _buckets(r_kmers, modulo)
    n_blocks = max(1, -(-max(p_kmers.shape[0], r_kmers.shape[0])
                        // BLOCK_ROWS))
    bounds = [modulo * i // n_blocks for i in range(n_blocks + 1)]
    bad_rows = bad_freqs = layout = 0
    before = 0  # reference rows in the blocks before this one
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        p_at = torch.nonzero((p_bucket >= lo) & (p_bucket < hi)).flatten()
        r_at = torch.nonzero((r_bucket >= lo) & (r_bucket < hi)).flatten()
        port = [c[p_at].to(torch.int64)
                for c in (p_kmers, p_nodes, p_offsets, p_freqs)]
        ref = [c[r_at].to(torch.int64)
               for c in (r_kmers, r_nodes, r_offsets)]
        r, f = _rows_and_frequencies(port, ref)
        bad_rows += r
        bad_freqs += f
        sizes = torch.bincount((r_bucket[r_at] - lo).to(torch.int64),
                               minlength=hi - lo)
        starts = torch.where(sizes > 0,
                             before + torch.cumsum(sizes, 0) - sizes, 0)
        before += r_at.shape[0]
        layout += int((p_sizes[lo:hi].to(torch.int64) != sizes).sum())
        layout += int((p_starts[lo:hi].to(torch.int64) != starts).sum())
        del port, ref, p_at, r_at, sizes, starts
    for lo in range(0, max(0, p_bucket.shape[0] - 1), BLOCK_ROWS):
        a = p_bucket[lo:lo + BLOCK_ROWS + 1]
        layout += int((a[1:] < a[:-1]).sum())
    return [("index_rows", bad_rows, LIMIT),
            ("index_frequencies", bad_freqs, LIMIT),
            ("index_layout", layout, LIMIT)]
