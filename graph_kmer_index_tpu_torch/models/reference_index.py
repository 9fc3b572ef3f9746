"""ReferenceKmerIndex: reference-position range -> kmers, CSR by ref
position (reference reference_kmer_index.py:24-148). Used for streaming
windowed lookups along the linear reference during read mapping. The
port's copy of graph_kmer_index_tpu/models/reference_index.py.
"""
from __future__ import annotations

import logging

import numpy as np

from ..hashing import sliding_window_hashes, letter_sequence_to_numeric


def fill_zeros_from_end(array):
    """Gap-fill zeros with the next nonzero to the right (reversed
    cumulative-max trick, reference reference_kmer_index.py:16-21)."""
    array = array[::-1]
    prev = np.arange(len(array))
    prev[array == 0] = 0
    prev = np.maximum.accumulate(prev)
    return array[prev][::-1]


class ReferenceKmerIndex:
    properties = {"ref_position_to_index", "kmers", "ref_positions", "nodes"}

    def __init__(self, ref_position_to_index=None, kmers=None,
                 ref_positions=None, nodes=None):
        self.ref_position_to_index = ref_position_to_index
        self.kmers = kmers
        self.ref_positions = ref_positions
        self.nodes = nodes

    def get_between(self, ref_start, ref_end):
        return self.kmers[
            self.ref_position_to_index[ref_start]:
            self.ref_position_to_index[
                min(len(self.ref_position_to_index) - 1, ref_end)]]

    def get_between_except(self, ref_start, ref_end, except_position):
        assert self.ref_positions is None
        indexes = [i for i in np.arange(ref_start, ref_end)
                   if i != except_position]
        return self.kmers[indexes]

    def get_all_between(self, ref_start, ref_end):
        if self.ref_positions is None:
            raise Exception(
                "This index is missing reference positions and cannot be "
                "used to get all between. Use get_between() instead")
        start = self.ref_position_to_index[ref_start]
        end = self.ref_position_to_index[ref_end]
        return (self.kmers[start:end], self.ref_positions[start:end],
                self.nodes[start:end])

    @classmethod
    def from_sequence(cls, genome_sequence, k, only_store_kmers=False):
        numeric = letter_sequence_to_numeric(genome_sequence)
        kmers = sliding_window_hashes(numeric, k)
        ref_position_to_index = None
        if not only_store_kmers:
            ref_position_to_index = np.arange(len(genome_sequence),
                                              dtype=np.uint32)
        if k <= 16:
            kmers = kmers.astype(np.uint32)
        else:
            kmers = kmers.astype(np.uint64)
        return cls(ref_position_to_index, kmers)

    @classmethod
    def from_linear_reference(cls, fasta_file_name, reference_name="ref",
                              k=15, only_store_kmers=False):
        from ..utils.fasta import read_fasta_sequence
        genome_sequence = read_fasta_sequence(fasta_file_name, reference_name)
        return cls.from_sequence(genome_sequence, k, only_store_kmers)

    @classmethod
    def from_flat_kmers(cls, flat_kmers):
        ref_positions = np.asarray(flat_kmers._ref_offsets)
        sorting = np.argsort(ref_positions, kind="stable")
        ref_positions = ref_positions[sorting]
        kmers = np.asarray(flat_kmers._hashes)[sorting]
        if len(kmers) and np.max(kmers) < 2 ** 32:
            kmers = kmers.astype(np.uint32)
        nodes = np.asarray(flat_kmers._nodes)[sorting]
        assert len(kmers) < 4294967295, "Too many kmers (32 bit row limit)"

        if len(kmers) == 0:
            return cls(np.zeros(1, np.uint32), kmers, ref_positions, nodes)
        new_pos = np.where(np.ediff1d(ref_positions, to_begin=ref_positions.dtype.type(0)))[0]
        ref_position_to_index = np.zeros(int(ref_positions[-1]) + 1,
                                         dtype=np.uint32)
        ref_position_to_index[
            ref_positions[new_pos].astype(np.int64)] = new_pos
        ref_position_to_index = fill_zeros_from_end(ref_position_to_index)
        return cls(ref_position_to_index, kmers, ref_positions, nodes)

    def to_file(self, file_name):
        if self.ref_position_to_index is None:
            np.savez(file_name, kmers=self.kmers)
        elif self.ref_positions is None and self.nodes is None:
            np.savez(file_name,
                     ref_position_to_index=self.ref_position_to_index,
                     kmers=self.kmers)
        else:
            np.savez(file_name,
                     ref_position_to_index=self.ref_position_to_index,
                     kmers=self.kmers, ref_positions=self.ref_positions,
                     nodes=self.nodes)

    @classmethod
    def from_file(cls, file_name):
        try:
            data = np.load(str(file_name) + ".npz")
        except FileNotFoundError:
            data = np.load(file_name)
        nodes = data["nodes"] if "nodes" in data else None
        ref_positions = data["ref_positions"] if "ref_positions" in data else None
        rpi = (data["ref_position_to_index"]
               if "ref_position_to_index" in data else None)
        return cls(rpi, data["kmers"], ref_positions, nodes)
