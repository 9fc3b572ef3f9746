"""Counting structures: exact counter, count-min sketch, frequency index
(the port's copy of graph_kmer_index_tpu/models/counters.py; host numpy).

- KmerCounter (reference kmer_counter.py:19-83): exact counts via unique +
  HashTable; auto modulo ladder.
- CountMinSketchKmerCounter (reference count_min_sketch_kmer_counter.py:
  5-29): rows = different modulos in one flat array; counting is a
  bincount/scatter-add per row, so sketches of disjoint k-mer sets
  merge by addition.
- KmerFrequencyIndex (reference kmer_frequency_index.py:5-36): sorted
  unique kmers + counts, searchsorted lookup. NOTE: the reference's
  ``get`` uses side="right" and then compares self._kmers[index], which
  misses every kmer (latent off-by-one, kmer_frequency_index.py:11-16);
  we implement the evident intent (side="left").
"""
from __future__ import annotations

import logging

import numpy as np

from ..containers import Counter, HashTable


def choose_modulo(n_elements):
    if n_elements < 1000000:
        return 2000003
    elif n_elements < 10000000:
        return 19999999
    return 200000003


class KmerCounter:
    def __init__(self, counter):
        self.counter = counter

    @classmethod
    def from_flat_kmersv2(cls, flat, modulo, subsample_ratio=1):
        kmers = np.asarray(flat._hashes)[::subsample_ratio]
        return cls.from_kmers(kmers, modulo)

    @classmethod
    def from_kmers(cls, kmers, modulo):
        unique_kmers, counts = np.unique(kmers, return_counts=True)
        if modulo == 0:
            modulo = choose_modulo(len(unique_kmers))
        counter = HashTable(unique_kmers, counts, mod=modulo)
        return cls(counter)

    @classmethod
    def from_flat_kmers(cls, flat, modulo, chunk_size=50000000):
        kmers = np.asarray(flat._hashes)
        unique_kmers = np.unique(kmers)
        counter = Counter(unique_kmers, mod=modulo)
        for chunk in np.array_split(kmers, 1 + len(kmers) // chunk_size):
            counter.count(chunk)
        return cls(counter)

    def get_frequency(self, kmer):
        hit = self.counter[int(kmer)]
        if np.ndim(hit) == 0:
            return int(hit)
        return int(hit[0]) if len(hit) else 0

    def get_frequencies(self, kmers):
        """Vectorized get_frequency over a kmer batch (missing -> 0).

        Both backing containers (HashTable from from_kmers, Counter from
        from_flat_kmers) build over unique keys, so their vectorized
        one-value-per-key lookup applies."""
        return np.asarray(self.counter[np.asarray(kmers, dtype=np.uint64)])

    def score_kmers(self, kmers):
        hits = [self.counter[int(k)] for k in kmers]
        hits = [h[0] for h in hits if len(h) > 0]
        if len(hits) == 0:
            return 1
        return -np.max(hits)


class CountMinSketchKmerCounter:
    def __init__(self, data, modulos):
        self._data = data
        # uint64 throughout: an int64 modulo promotes uint64 kmers to
        # FLOAT64 under NumPy 2 — kmers >= 2^53 (most real 62-bit
        # 31-mers) would round to the wrong bucket on count, and uint64
        # fancy indexing would crash on the signed/unsigned mix
        self._modulos = np.asarray(modulos, dtype=np.uint64)
        self._array_positions = np.concatenate(
            [[0], np.cumsum(self._modulos)[:-1]]).astype(np.uint64)

    def _indexes(self, kmer):
        return (np.uint64(kmer) % self._modulos) + self._array_positions

    def get_count(self, kmer):
        return np.min(self._data[self._indexes(kmer)])

    def get_counts(self, kmers):
        """Vectorized min-over-rows for a batch."""
        kmers = np.asarray(kmers, dtype=np.uint64)
        per_row = [
            self._data[(kmers % mod) + off]
            for mod, off in zip(self._modulos, self._array_positions)]
        return np.min(np.stack(per_row), axis=0)

    # duck-typed frequency protocol (sketch counts ARE the frequency
    # estimates when a CMS stands in for an exact counter)
    get_frequency = get_count
    get_frequencies = get_counts

    @classmethod
    def create_empty(cls, modulos, dtype=np.uint16):
        data = np.zeros(int(np.sum(modulos)), dtype=dtype)
        return cls(data, np.asanyarray(modulos))

    def count_kmers(self, kmers):
        kmers = np.asarray(kmers, dtype=np.uint64)
        for mod, offset in zip(self._modulos, self._array_positions):
            indexes = (kmers % mod) + offset
            counts = np.bincount(indexes.astype(np.int64)).astype(
                self._data.dtype)
            self._data[0:len(counts)] += counts

    def to_file(self, file_name):
        np.savez(file_name, data=self._data, modulos=self._modulos)

    @classmethod
    def from_file(cls, file_name):
        try:
            data = np.load(file_name)
        except FileNotFoundError:
            data = np.load(str(file_name) + ".npz")
        return cls(data["data"], data["modulos"])


class KmerFrequencyIndex:
    def __init__(self, kmers, frequencies):
        self._kmers = kmers
        self._frequencies = frequencies

    def get(self, kmer):
        index = np.searchsorted(self._kmers, kmer, side="left")
        if index < len(self._kmers) and self._kmers[index] == kmer:
            return self._frequencies[index]
        logging.warning("No hit for kmer %d", kmer)
        return 0

    get_frequency = get

    def get_frequencies(self, kmers):
        """Vectorized get (missing -> 0, without the per-miss warning)."""
        kmers = np.asarray(kmers, dtype=np.uint64)
        if len(self._kmers) == 0:
            return np.zeros(len(kmers), dtype=np.int64)
        i = np.clip(np.searchsorted(self._kmers, kmers, side="left"),
                    0, len(self._kmers) - 1)
        return np.where(self._kmers[i] == kmers, self._frequencies[i], 0)

    @classmethod
    def from_kmers(cls, kmers):
        unique, frequencies = np.unique(kmers, return_counts=True)
        return cls(unique, frequencies)

    def to_file(self, file_name):
        np.savez(file_name, kmers=self._kmers, frequencies=self._frequencies)

    @classmethod
    def from_file(cls, file_name):
        try:
            data = np.load(file_name)
        except FileNotFoundError:
            data = np.load(str(file_name) + ".npz")
        return cls(data["kmers"], data["frequencies"])
