"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, everything else as in a run, on the
CPU at a test's size. One test a fault that the cell can have; the
cells run on one card, so no exchange between cards can be left out."""
import pytest
import torch

import graph_kmer_index_tpu_torch.ops.encode as encode
import graph_kmer_index_tpu_torch.ops.lookup as lookup
import graph_kmer_index_tpu_torch.models.kmer_index as kmer_index
from graph_kmer_index_tpu_torch.read_kmers import DeviceReadKmers

from portbench.tests import tiny

MAP_CELLS = tiny.CELLS


def wrong(result, *names):
    res, checks = result
    assert res["correct"] is False
    bad = {n for n, v, limit in checks if v > limit}
    assert bad & set(names), checks


def test_sound_runs_are_correct():
    for cell in MAP_CELLS:
        res, _ = tiny.run(cell)
        assert res["correct"], (cell, res)


@pytest.mark.parametrize("cell", MAP_CELLS)
def test_half_of_the_batch_left_out(cell, monkeypatch):
    real = kmer_index.KmerIndex.map_kmers

    def half(self, kmers, n_nodes, backend="device"):
        if isinstance(kmers, DeviceReadKmers):
            kmers = DeviceReadKmers([s[:s.shape[0] // 2]
                                     for s in kmers.segments], kmers.k)
        else:
            kmers = kmers[:kmers.shape[0] // 2]
        return real(self, kmers, n_nodes, backend)

    monkeypatch.setattr(kmer_index.KmerIndex, "map_kmers", half)
    wrong(tiny.run(cell), "node_counts")


@pytest.mark.parametrize("cell", MAP_CELLS)
def test_an_answer_altered_where_it_is_produced(cell, monkeypatch):
    real = lookup.packed_lookup

    def altered(tables, queries, n_valid, n_nodes=None, *a, **kw):
        out = real(tables, queries, n_valid, n_nodes, *a, **kw)
        if n_nodes:
            out[n_nodes // 2] += 1
        return out

    monkeypatch.setattr(lookup, "packed_lookup", altered)
    wrong(tiny.run(cell), "node_counts")


@pytest.mark.parametrize("cell", MAP_CELLS)
def test_a_step_that_returns_its_state_unchanged(cell, monkeypatch):
    import numpy as np

    def unchanged(self, kmers, n_nodes, backend="device"):
        return np.zeros(n_nodes, dtype=np.int64)

    monkeypatch.setattr(kmer_index.KmerIndex, "map_kmers", unchanged)
    wrong(tiny.run(cell), "node_counts")


def test_a_hash_altered_where_it_is_produced(monkeypatch):
    real = encode.sliding_hashes

    def altered(seq, k):
        out = real(seq, k)
        out[0] ^= 1
        return out

    monkeypatch.setattr(encode, "sliding_hashes", altered)
    wrong(tiny.run(tiny.FASTA_CELL), "read_hashes")


@pytest.mark.parametrize("cell", MAP_CELLS)
def test_a_frequency_altered_where_it_is_produced(cell, monkeypatch):
    real = kmer_index.frequencies_by_distinct_ref_offsets

    def altered(kmers, ref_offsets):
        out = real(kmers, ref_offsets)
        out[0] += 1
        return out

    monkeypatch.setattr(kmer_index, "frequencies_by_distinct_ref_offsets",
                        altered)
    wrong(tiny.run(cell), "index_frequencies")


@pytest.mark.parametrize("cell", MAP_CELLS)
def test_a_packed_record_altered(cell, monkeypatch):
    real = lookup.build_packed

    def altered(kmers, nodes, modulo2):
        t = real(kmers, nodes, modulo2)
        rec = t.records.clone()
        hit = torch.nonzero(rec[:, 2] >= 0).flatten()[::7]
        rec[hit, 2] += 1  # the first stored node of every 7th bucket
        return t._replace(records=rec)

    monkeypatch.setattr(lookup, "build_packed", altered)
    wrong(tiny.run(cell), "node_counts")
