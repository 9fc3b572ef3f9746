"""The query views of the port's KmerIndex (ops.lookup.DeviceKmerIndex and
models.native_index.NativeKmerIndex) take the index's columns when they
are made and keep no reference to the index. So a dropped index, or a
view the index replaced, frees its memory when its last reference goes,
with the garbage collector off; and every mutator makes the views anew
after it assigns its column, so the next query reads the new column.

The test marked ``card`` holds the same of the device memory of an index
on a CUDA card, and skips without one. This file imports no JAX:
``python -m pytest --noconftest -p no:cacheprovider -m card
tests/test_torch_index_views.py`` runs it on the card."""
import gc
import weakref

import numpy as np
import pytest
import torch

from graph_kmer_index_tpu_torch.flat_kmers import FlatKmers
from graph_kmer_index_tpu_torch.models.kmer_index import KmerIndex

torch.set_num_threads(2)

N_NODES = 300
MODULO = 1009


def _rows(seed=0, n=3000, n_distinct=800):
    """Rows whose k-mers repeat, a few ref offsets each (every frequency
    stays under get_batched's default cap of 20)."""
    rng = np.random.default_rng(seed)
    distinct = rng.integers(0, 1 << 26, n_distinct).astype(np.uint64)
    return (distinct[rng.integers(0, n_distinct, n)],
            rng.integers(1, N_NODES, n).astype(np.uint32),
            rng.integers(0, 60, n).astype(np.uint64),
            rng.random(n).astype(np.float32))


@pytest.mark.parametrize("case", ["index_dropped",
                                  "index_dropped_after_native",
                                  "view_replaced_by_set_frequencies",
                                  "device_index_set_to_none"])
def test_views_free_their_memory_without_the_collector(case):
    rows = _rows()
    q = rows[0][:500]
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        index = KmerIndex.from_rows(*rows, MODULO, device="cpu")
        index.map_kmers(q, N_NODES)
        gone = [weakref.ref(index.device_index.packed().records)]
        if case == "index_dropped_after_native":
            index.get_frequencies(q, backend="native")
            gone.append(weakref.ref(index._native_index.table_frequencies))
        if case.startswith("index_dropped"):
            gone.append(weakref.ref(index.kmers))
            del index
        elif case == "view_replaced_by_set_frequencies":
            index.set_frequencies()
        else:
            # what the benchmark's finish() does before its check
            index.device_index = None
        assert [ref() is None for ref in gone] == [True] * len(gone)
    finally:
        if was_enabled:
            gc.enable()


@pytest.mark.parametrize("mutation, row, value", [
    ("remove_frequencies", 3, 0),
    ("remove_ref_offsets", 1, 0),
    ("set_frequencies_skip", 3, 0),
    ("skip_singletons", 3, 1),
])
def test_the_next_query_reads_a_mutators_new_column(mutation, row, value):
    """get_batched's rows [node, ref_offset, query index, frequency,
    1000 * allele_frequency] after a mutation: the mutated row holds the
    new column's value, the others are as before."""
    rows = _rows(seed=1)
    q = rows[0][:500]
    index = KmerIndex.from_rows(*rows, MODULO, device="cpu")
    before = index.get_batched(q)
    assert before.shape[1] and (before[row] != value).any()
    if mutation == "skip_singletons":
        # frequencies skipped (zeros) and then one added to each
        index = KmerIndex.from_flat_kmers(FlatKmers(*rows), MODULO,
                                          skip_frequencies=True,
                                          skip_singletons=True, device="cpu")
        got = index.get_batched(q)
    else:
        if mutation == "set_frequencies_skip":
            index.set_frequencies(skip=True)
        else:
            getattr(index, mutation)()
        got = index.get_batched(q)
        assert np.array_equal(np.delete(got, row, 0),
                              np.delete(before, row, 0))
    assert got.shape[1] and (got[row] == value).all()


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the memory freed is the card's")
    return torch.device("cuda:0")


@pytest.mark.card
def test_a_dropped_index_frees_its_card_memory_at_once(card):
    """Every byte an index and its packed table hold on the card is free
    again as soon as the index is dropped, with the collector off."""
    rows = _rows()
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        torch.cuda.synchronize(card)
        before = torch.cuda.memory_allocated(card)
        index = KmerIndex.from_rows(*rows, MODULO, device=card)
        index.map_kmers(rows[0][:500], N_NODES)
        assert index.device_index.packed() is not None
        torch.cuda.synchronize(card)
        assert torch.cuda.memory_allocated(card) > before
        del index
        assert torch.cuda.memory_allocated(card) == before
    finally:
        if was_enabled:
            gc.enable()
