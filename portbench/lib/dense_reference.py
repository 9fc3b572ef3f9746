"""The plain reference of the dense index: every k-base window of every
path through the variants of a generated genome, worked out again from
the genome's tensors, with the rules of the dense finder (the reference
``kmer_finder.py``, as ``graph_kmer_index index`` runs it: one node a
k-mer, ``get_flat_kmers(v="1")``).

Plain torch on the genome's device, in blocks of window starts. It
imports nothing of the port and never reads the port's ``Graph``: the
variant graph is the one that ``genome.py``'s node numbering describes,
a chain of bubbles. Segment ``i`` (node ``3i + 1``) is the reference
between variant ``i - 1`` and variant ``i``; its reference allele
(``3i + 2``) and alternative allele (``3i + 3``) both lead to segment
``i + 1``, and an allele of no bases (the reference allele of an
insertion, the alternative of a deletion) is a node all the same.

The finder's rules, and what they come to on such a graph:

- a window's node set is the nodes of its path from the node of its first
  base through the node of its last, alleles of no bases between them
  included; a window is kept once per distinct node set, and with one
  node a k-mer its row keeps the smallest node, which is the node of the
  window's first base, since ids grow along every path;
- at ``max_variant_nodes`` distinct variant nodes (alternative alleles)
  in the window that ends at a segment's last base, the search follows
  only the reference allele. Every path may take the reference allele
  before a window starts, so a window is found exactly when its own node
  set holds at most ``max_variant_nodes`` alternative alleles;
- a search starts at a critical position, and the node set of its first
  full window includes everything from the search's start. A search
  starts at the first base of a segment of at least k bases, whose
  first window lies inside the segment, so this adds no node here;
- the allele frequency of a row is the least over its window's raw node
  list: every allele frequency is 1.0 here;
- a row's reference offset is the position id of its window's last base
  (``get_flat_kmers(v="1")``): node ``v`` starts at id ``sum over u < v
  of (size(u) + 1)``, so alleles of no bases still take an id.

``dense_rows`` returns (k-mers, nodes, reference offsets), int64, as the
checks of ``checks.py`` take them; ``max_variant_nodes=1`` is the
control (``dense_control.py``).
"""
from __future__ import annotations

import torch

from .genome import K, Genome

# window starts expanded at once
START_BLOCK = 1 << 24


class Layout:
    """The genome's nodes in id order: ``sizes`` (bases a node), ``first``
    (where a node's bases start in ``tape``, which holds every node's
    bases one node after another) and ``ids`` (the position id of a
    node's first base)."""

    def __init__(self, genome: Genome):
        ref, pos = genome.ref, genome.pos
        dev = ref.device
        rl = genome.ref_len.to(torch.int64)
        al = genome.alt_len.to(torch.int64)
        n_var = genome.n_variants
        n = genome.n_nodes
        seg_lo = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                            pos + rl])
        seg_hi = torch.cat([pos, torch.tensor([ref.shape[0]], device=dev)])
        sizes = torch.zeros(n, dtype=torch.int64, device=dev)
        sizes[1::3] = seg_hi - seg_lo
        sizes[2::3] = rl
        sizes[3::3] = al
        first = torch.cumsum(sizes, 0) - sizes
        tape = torch.empty(int(sizes.sum()), dtype=torch.int8, device=dev)
        # the reference's bases in order, each after the alternative
        # alleles of the variants whose reference allele ends at or
        # before it
        alt_before = torch.cat([torch.zeros(1, dtype=torch.int64,
                                            device=dev), torch.cumsum(al, 0)])
        ends = pos + rl
        for lo in range(0, ref.shape[0], START_BLOCK):
            x = torch.arange(lo, min(ref.shape[0], lo + START_BLOCK),
                             device=dev)
            shift = alt_before[torch.searchsorted(ends, x, right=True)]
            tape[x + shift] = ref[lo:lo + x.shape[0]]
        alt_first = first[3 * torch.arange(n_var, device=dev) + 3]
        for j in range(genome.alt_bases.shape[1]):
            m = al > j
            tape[alt_first[m] + j] = genome.alt_bases[m, j]
        self.sizes = sizes
        self.first = first
        self.ids = first + torch.arange(n, device=dev)
        self.tape = tape
        self.n_nodes = n


def forward_hashes(tape: torch.Tensor, k: int = K) -> torch.Tensor:
    """At every tape position, the hash of the k bases from it on (bases
    past the tape's end read as 0); a shorter prefix is taken by a
    mask."""
    n = tape.shape[0]
    out = torch.zeros(n, dtype=torch.int64, device=tape.device)
    for lo in range(0, n, START_BLOCK):
        hi = min(n, lo + START_BLOCK)
        block = torch.zeros(hi - lo + k - 1, dtype=torch.int64,
                            device=tape.device)
        block[:min(n, hi + k - 1) - lo] = tape[lo:hi + k - 1].to(torch.int64)
        h = torch.zeros(hi - lo, dtype=torch.int64, device=tape.device)
        for j in range(k):
            h |= block[j:j + hi - lo] << (2 * j)
        out[lo:hi] = h
    return out


def dense_rows(genome: Genome, max_variant_nodes: int = 5, k: int = K):
    """(k-mers, nodes, reference offsets) of the dense index, one row a
    window, in no particular order."""
    lay = Layout(genome)
    dev = lay.tape.device
    fwd = forward_hashes(lay.tape, k)
    node_of = torch.repeat_interleave(
        torch.arange(lay.n_nodes, device=dev), lay.sizes,
        output_size=lay.tape.shape[0])
    last_segment = lay.n_nodes - 1
    out = ([], [], [])
    for lo in range(0, lay.tape.shape[0], START_BLOCK):
        x = torch.arange(lo, min(lay.tape.shape[0], lo + START_BLOCK),
                         device=dev)
        v = node_of[x]
        state = {
            "v": v, "o": x - lay.first[v],
            "c": torch.zeros_like(x), "h": torch.zeros_like(x),
            "a": (v % 3 == 0).to(torch.int64), "s": v,
        }
        del x, v
        while state["v"].numel():
            state = _advance(state, lay, fwd, k, max_variant_nodes,
                             last_segment, out)
    return tuple(torch.cat(col) for col in out)


def _advance(st, lay, fwd, k, max_variant_nodes, last_segment, out):
    """One step of every open window: take the bases it still needs from
    its node; a finished window is a row, an open one moves on to each
    successor of its node that the rules allow."""
    v, o, c = st["v"], st["o"], st["c"]
    t = torch.minimum(k - c, lay.sizes[v] - o)
    bases = fwd[lay.first[v] + o] & ((1 << (2 * t)) - 1)
    h = st["h"] | (bases << (2 * c))
    c = c + t
    o = o + t
    done = c == k
    out[0].append(h[done])
    out[1].append(st["s"][done])
    out[2].append(lay.ids[v[done]] + o[done] - 1)
    go = ~done & (v != last_segment)
    v, h, c, a, s = v[go], h[go], c[go], st["a"][go], st["s"][go]
    segment = v % 3 == 1
    # a segment leads to its reference allele (v + 1) and, while the
    # window holds fewer than max_variant_nodes alternative alleles, to
    # its alternative (v + 2); a reference allele (3i + 2) and an
    # alternative (3i + 3) lead to the next segment (3i + 4)
    alt = segment & (a < max_variant_nodes)
    step = torch.where(segment, 1, torch.where(v % 3 == 2, 2, 1))
    nxt = torch.cat([v + step, v[alt] + 2])
    keep = torch.cat([torch.arange(v.shape[0], device=v.device),
                      torch.nonzero(alt).flatten()])
    a = torch.cat([a, a[alt] + 1])
    return {"v": nxt, "o": torch.zeros_like(nxt), "c": c[keep],
            "h": h[keep], "a": a, "s": s[keep]}
