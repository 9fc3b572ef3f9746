"""The plain reference: what the port's index, read hashes and node counts
must be, worked out again from the generated reference, variants and
reads.

Plain torch on whatever device the tensors are on, in blocks where a
whole-size tensor would be large. It imports nothing of the port (the
package ``graph_kmer_index_tpu_torch``) and takes nothing that the port
made: no rows, tables or hashes. The port's outputs come in only as the
things it judges (``compare_*``).

Hashes: a k-mer's first base is its least significant 2-bit digit,
``hash = sum(base[j] << 2j)`` (the hash of KAGE and graph_kmer_index).
"""
from __future__ import annotations

import torch

from .genome import K
from .roofline import internal_modulo

# the port's frequencies are 16-bit (a uint16 column)
FREQ_MASK = 0xFFFF


# -- hashes -------------------------------------------------------------------

def read_hashes(reads: torch.Tensor, k: int = K):
    """(forward, reverse complement) hashes of every window of every read
    of a (n_reads, length) 2-bit matrix, read-major: the order of
    ``hash_fasta_file``'s two halves. The reverse complement is hashed
    from the complemented bases read backwards, not from the forward
    hash."""
    n, length = reads.shape
    w = length - k + 1
    fw = torch.zeros((n, w), dtype=torch.int64, device=reads.device)
    rc = torch.zeros((n, w), dtype=torch.int64, device=reads.device)
    for j in range(k):
        b = reads[:, j:j + w].to(torch.int64)
        fw |= b << (2 * j)
        rc |= (3 - b) << (2 * (k - 1 - j))
    return fw.reshape(-1), rc.reshape(-1)


def batch_hashes(reads: torch.Tensor, block: int = 1 << 18) -> torch.Tensor:
    """Forward then reverse-complement hashes of a batch of reads, in
    blocks of reads."""
    fws, rcs = [], []
    for lo in range(0, reads.shape[0], block):
        fw, rc = read_hashes(reads[lo:lo + block])
        fws.append(fw)
        rcs.append(rc)
    return torch.cat(fws + rcs)


# -- index rows -----------------------------------------------------------------

def signature_rows(windows: torch.Tensor, ref_offsets: torch.Tensor):
    """(k-mers, nodes, reference offsets) of the signature index: one row
    an allele node (ids 3i + 2 and 3i + 3), its window's hash; both
    alleles of a variant at the variant's coordinate."""
    n = windows.shape[0]
    dev = windows.device
    kmers = torch.empty(n, dtype=torch.int64, device=dev)
    for lo in range(0, n, 1 << 22):
        block = windows[lo:lo + (1 << 22)].to(torch.int64)
        h = torch.zeros(block.shape[0], dtype=torch.int64, device=dev)
        for j in range(K):
            h |= block[:, j] << (2 * j)
        kmers[lo:lo + block.shape[0]] = h
    row = torch.arange(n, device=dev)
    nodes = (row // 2) * 3 + 2 + row % 2
    return kmers, nodes, ref_offsets.repeat_interleave(2)


def row_order(kmers: torch.Tensor, nodes: torch.Tensor,
              ref_offsets: torch.Tensor):
    """(order sorting rows by k-mer, node, offset; the node and offset
    packed in one int64 key)."""
    if int(ref_offsets.max()) >= 1 << 32 or int(nodes.max()) >= 1 << 31:
        raise ValueError("offsets or nodes too large for the packed key")
    key = (nodes.to(torch.int64) << 32) | ref_offsets.to(torch.int64)
    order = torch.sort(key, stable=True).indices
    order = order[torch.sort(kmers[order], stable=True).indices]
    return order, key


def frequencies(kmers: torch.Tensor, ref_offsets: torch.Tensor,
                distinct: bool = True) -> torch.Tensor:
    """Each row's k-mer's frequency, in 16 bits: the number of distinct
    reference offsets among the k-mer's rows (``distinct=False``: the
    number of its rows, the control)."""
    n = kmers.shape[0]
    order = torch.sort(ref_offsets, stable=True).indices
    order = order[torch.sort(kmers[order], stable=True).indices]
    km, ro = kmers[order], ref_offsets[order]
    new_kmer = torch.ones(n, dtype=torch.bool, device=kmers.device)
    new_kmer[1:] = km[1:] != km[:-1]
    counted = new_kmer.clone()
    if distinct:
        counted[1:] |= ro[1:] != ro[:-1]
    else:
        counted[:] = True
    group = torch.cumsum(new_kmer.to(torch.int64), 0) - 1
    per = torch.zeros(int(group[-1]) + 1 if n else 0, dtype=torch.int64,
                      device=kmers.device)
    per.index_add_(0, group, counted.to(torch.int64))
    out = torch.empty(n, dtype=torch.int64, device=kmers.device)
    out[order] = per[group] & FREQ_MASK
    return out


# -- judging the port's outputs ------------------------------------------------

def compare_index(port: dict, kmers, nodes, ref_offsets, modulo: int,
                  distinct: bool = True) -> dict:
    """Mismatch counts between the port's index (``port``: tensors
    ``kmers``, ``nodes``, ``ref_offsets``, ``frequencies``,
    ``hashes_to_index``, ``n_kmers``) and the reference's rows:

    - ``index_rows``: rows that differ once both sides are sorted by
      k-mer, node and offset (plus the difference in row count);
    - ``index_frequencies``: frequencies that differ, in that order;
    - ``index_layout``: bucket starts and sizes that differ from the
      rows' own layout at ``modulo``, and rows out of bucket order.

    ``distinct=False`` judges against the control's frequencies."""
    out = {}
    n_ref, n_port = kmers.shape[0], port["kmers"].shape[0]
    freqs = frequencies(kmers, ref_offsets, distinct)
    r_order, r_key = row_order(kmers, nodes, ref_offsets)
    p_order, p_key = row_order(port["kmers"], port["nodes"],
                               port["ref_offsets"])
    n = min(n_ref, n_port)
    diff = abs(n_ref - n_port)
    rows = (port["kmers"][p_order[:n]] != kmers[r_order[:n]]) | (
        p_key[p_order[:n]] != r_key[r_order[:n]])
    out["index_rows"] = int(rows.sum()) + diff
    p_freq = port["frequencies"].to(torch.int64)
    out["index_frequencies"] = int(
        (p_freq[p_order[:n]] != freqs[r_order[:n]]).sum()) + diff
    del r_order, r_key, p_order, p_key, rows, freqs, p_freq
    bucket = kmers % modulo
    sizes = torch.bincount(bucket, minlength=modulo)
    del bucket
    starts = torch.where(sizes > 0, torch.cumsum(sizes, 0) - sizes, 0)
    layout = int((port["n_kmers"].to(torch.int64) != sizes).sum())
    del sizes
    layout += int((port["hashes_to_index"].to(torch.int64) != starts).sum())
    del starts
    p_bucket = port["kmers"] % modulo
    layout += int((p_bucket[1:] < p_bucket[:-1]).sum())
    out["index_layout"] = layout
    return out


def kmer_table(kmers: torch.Tensor, nodes: torch.Tensor,
               control: bool = False):
    """The rows that node counts are joined against: all of them, or for
    the control only those in buckets of at most two rows at the packed
    table's internal modulo (a lookup that answers from the two record
    slots and never scans a deeper bucket)."""
    if control:
        b = kmers % internal_modulo(kmers.shape[0])
        _, inverse, size = torch.unique(b, return_inverse=True,
                                        return_counts=True)
        keep = size[inverse] <= 2
        kmers, nodes = kmers[keep], nodes[keep]
    return kmers, nodes


def node_counts(table_kmers: torch.Tensor, table_nodes: torch.Tensor,
                queries: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Hits per node: every row adds the number of queries equal to its
    k-mer (nodes >= n_nodes dropped), by a join on the unique queries."""
    uq, qc = torch.unique(queries, return_counts=True)
    counts = torch.zeros(n_nodes, dtype=torch.int64, device=queries.device)
    if uq.shape[0] == 0:
        return counts
    for lo in range(0, table_kmers.shape[0], 1 << 26):
        km = table_kmers[lo:lo + (1 << 26)]
        nd = table_nodes[lo:lo + (1 << 26)].to(torch.int64)
        pos = torch.searchsorted(uq, km).clamp(max=uq.shape[0] - 1)
        match = (uq[pos] == km) & (nd < n_nodes)
        counts.index_add_(0, nd[match], qc[pos[match]])
    return counts
