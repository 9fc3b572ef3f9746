"""FlatKmers — the interchange format between finders and indexes.

Parallel arrays of (hash, node, ref_offset, allele_frequency); one row per
(kmer occurrence, touched node). File format is npz with the same keys as
the reference (flat_kmers.py:55-68), so indexes round-trip byte-compatibly.

The port's copy of graph_kmer_index_tpu/flat_kmers.py. Its columns are
numpy arrays, or torch tensors where a device finalize made them
(parallel.host_pool.find_kmers_parallel_device): hashes and ref offsets
int64 (every hash is < 2^62, torch has no uint64 arithmetic), nodes
int32, allele frequencies float32. On disk both kinds are the JAX
package's npz: ``to_file`` writes tensor columns as uint64 hashes and
ref offsets.
"""
from __future__ import annotations

import sys

import numpy as np

from .utils.hugepages import hp_empty
from .hashing import kmer_hashes_to_reverse_complement_hash


def is_tensor(a) -> bool:
    """True for a torch tensor. This module does not import torch (the
    pooled find's workers never need it): a tensor can only come from a
    process that has."""
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(a, torch.Tensor)


def host_column(a, unsigned=False) -> np.ndarray:
    """A column as a numpy array; a tensor is copied from its device, and
    with ``unsigned`` its int64 bits are read as the uint64 of the file
    format."""
    if is_tensor(a):
        a = a.detach().cpu().numpy()
        if unsigned and a.dtype == np.int64:
            a = a.view(np.uint64)
        return a
    return np.asarray(a)


class FlatKmers2:
    """FlatKmers with (start_node, start_offset) positions instead of a
    linearized ref_offset (reference flat_kmers.py:7-29). "start" is the
    graph position of the window's LAST base (end-position semantics,
    pinned by tests/test_kmer_finder.py:test_two_long_nodes*)."""

    def __init__(self, hashes, start_nodes, start_offsets, nodes,
                 allele_frequencies=None):
        assert len(hashes) == len(nodes)
        assert len(start_nodes) == len(nodes)
        assert len(start_offsets) == len(start_nodes)
        self._hashes = hashes
        self._nodes = nodes
        self._start_nodes = start_nodes
        self._start_offsets = start_offsets
        if allele_frequencies is None:
            allele_frequencies = np.ones(len(hashes), dtype=np.single)
        self._allele_frequencies = allele_frequencies

    def __str__(self):
        return "\n".join(str(a) for a in [self._hashes, self._nodes])

    __repr__ = __str__


class FlatKmers:
    def __init__(self, hashes, nodes, ref_offsets=None, allele_frequencies=None):
        assert len(hashes) == len(nodes)
        self._hashes = hashes
        self._nodes = nodes
        if ref_offsets is None:
            ref_offsets = np.zeros(len(nodes))
        self._ref_offsets = ref_offsets
        if allele_frequencies is None:
            allele_frequencies = np.zeros(len(hashes), dtype=np.single) + 1.0
        self._allele_frequencies = allele_frequencies

    def __len__(self):
        return len(self._hashes)

    def describtion(self):  # (sic) reference API, flat_kmers.py:48-52
        return "".join("%d: %d\n" % (int(k), int(n))
                       for k, n in zip(self._hashes, self._nodes))

    # -- I/O ------------------------------------------------------------

    def to_file(self, file_name):
        np.savez(file_name, hashes=host_column(self._hashes, unsigned=True),
                 nodes=host_column(self._nodes),
                 ref_offsets=host_column(self._ref_offsets, unsigned=True),
                 allele_frequencies=host_column(self._allele_frequencies))

    @classmethod
    def from_file(cls, file_name):
        try:
            data = np.load(file_name)
        except FileNotFoundError:
            data = np.load(str(file_name) + ".npz")
        return cls(data["hashes"], data["nodes"], data["ref_offsets"],
                   data["allele_frequencies"])

    # -- transforms -------------------------------------------------------

    @classmethod
    def from_multiple_flat_kmers(cls, flat_kmers_list, consume=False):
        """Concatenate shards (the merge collective of the build pipeline;
        reference flat_kmers.py:71-90). Concatenates+casts in one pass
        into hugepage-advised buffers. With ``consume=True`` each shard's
        field is released right after it is copied, so that the
        destination can reuse the pages its sources held
        (utils/hugepages.py)."""
        def concat_field(attr, dtype, skip_none=False):
            srcs = [f for f in flat_kmers_list
                    if not (skip_none and getattr(f, attr) is None)]
            if skip_none and not srcs:
                return None
            out = hp_empty(sum(len(getattr(f, attr)) for f in srcs), dtype)
            o = 0
            for f in srcs:
                a = host_column(getattr(f, attr))
                np.copyto(out[o:o + len(a)], a, casting="unsafe")
                o += len(a)
                if consume:
                    setattr(f, attr, None)
            return out

        hashes = concat_field("_hashes", np.uint64)
        nodes = concat_field("_nodes", np.uint32)
        ref_offsets = concat_field("_ref_offsets", np.uint64, skip_none=True)
        af = concat_field("_allele_frequencies", np.single)
        return cls(hashes, nodes, ref_offsets, af)

    def get_new_without_singletons(self):
        """Drop the FIRST occurrence of every hash, keep the rest in order
        (yes, firsts — not singletons-only; same semantics as the reference
        loop at flat_kmers.py:98-125, vectorized)."""
        if is_tensor(self._hashes):
            import torch
            # on the columns' device: the first row of every run of a
            # stable sort is that hash's first occurrence
            hs, order = torch.sort(self._hashes, stable=True)
            first = torch.ones_like(hs, dtype=torch.bool)
            first[1:] = hs[1:] != hs[:-1]
            keep = torch.ones_like(first)
            keep[order[first]] = False
            return FlatKmers(self._hashes[keep], self._nodes[keep],
                             self._ref_offsets[keep],
                             self._allele_frequencies[keep])
        _, first_idx = np.unique(self._hashes, return_index=True)
        keep = np.ones(len(self._hashes), dtype=bool)
        keep[first_idx] = False
        return FlatKmers(self._hashes[keep], self._nodes[keep],
                         self._ref_offsets[keep],
                         self._allele_frequencies[keep])

    def get_reverse_complement_flat_kmers(self, k):
        if is_tensor(self._hashes):
            from .ops.encode import revcomp_hashes
            return FlatKmers(revcomp_hashes(self._hashes, k), self._nodes,
                             self._ref_offsets, self._allele_frequencies)
        return FlatKmers(
            kmer_hashes_to_reverse_complement_hash(self._hashes, k),
            self._nodes, self._ref_offsets, self._allele_frequencies)

    # -- frequency scoring (used by UniqueVariantKmersFinder) -------------

    def sum_of_kmer_frequencies(self, kmer_index_with_frequencies):
        freqs = kmer_index_with_frequencies.get_frequencies(
            host_column(self._hashes, unsigned=True).astype(np.uint64))
        return int(np.maximum(1, freqs).sum()) if len(freqs) else 0

    def maximum_kmer_frequency(self, kmer_index_with_frequencies):
        freqs = kmer_index_with_frequencies.get_frequencies(
            host_column(self._hashes, unsigned=True).astype(np.uint64))
        return int(np.max(freqs)) if len(freqs) else 0
