"""The pool of host blocks that the node counts come back in
(graph_kmer_index_tpu_torch/ops/host_buffers.py): blocks lent until the
last array or view over them is gone, at most two kept free, another
size evicted first, and its two counters, counted only while a profiler
session records. On the CPU the pool runs with pinning off.

The tests marked ``card`` hold ``KmerIndex.map_kmers`` on a CUDA index
against a plain copy of the same launch's counts, and its memory as
pinned; they skip without a CUDA card. This file imports no JAX:
``python -m pytest --noconftest -p no:cacheprovider -m card
tests/test_torch_host_buffers.py``."""
import gc
import os
import sys
import threading

import numpy as np
import pytest
import torch

from graph_kmer_index_tpu_torch.models.kmer_index import KmerIndex
from graph_kmer_index_tpu_torch.ops import host_buffers
from graph_kmer_index_tpu_torch.ops.lookup import DeviceKmerIndex
from graph_kmer_index_tpu_torch.read_kmers import hash_fasta_file
from graph_kmer_index_tpu_torch.utils import profiling

N = 1000


@pytest.fixture
def pool():
    return host_buffers.HostBlockPool(pin=False)


@pytest.fixture
def counting(monkeypatch):
    """The counters zeroed, and counted as under a profiler session."""
    profiling.reset_counters()
    monkeypatch.setattr(profiling, "active", lambda: True)
    yield
    profiling.reset_counters()


def _result(pool, n=N, value=0, dtype=torch.int64):
    """What map_kmers returns: a block filled by a copy, as numpy."""
    block = pool.take(n, dtype)
    block.copy_(torch.full((n,), value, dtype=dtype))
    return block.numpy()


def _host_counts():
    c = profiling.counters()
    return c["host_counts.reused"], c["host_counts.allocated"]


# -- lending ------------------------------------------------------------------

@pytest.mark.parametrize("n_held", [2, 3, 5])
def test_results_held_at_once_get_distinct_blocks(pool, n_held):
    """Results held together never share memory, also where they come
    from freed blocks, and keep their values across later takes of the
    same size."""
    freed = [_result(pool) for _ in range(2)]
    del freed
    held = [_result(pool, value=v + 1) for v in range(n_held)]
    addresses = {a.ctypes.data for a in held}
    assert len(addresses) == n_held
    for v in range(4):
        _result(pool, value=-v - 1)
    for v, a in enumerate(held):
        assert a.dtype == np.int64 and a.shape == (N,)
        assert a.flags.c_contiguous and a.flags.writeable
        assert (a == v + 1).all()


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32, torch.uint8])
def test_take_is_exactly_the_size_asked(pool, dtype):
    block = pool.take(N + 3, dtype)
    assert block.dtype == dtype and block.shape == (N + 3,)
    assert block.is_contiguous()


@pytest.mark.parametrize("n, mapped", [
    (host_buffers.HUGE_PAGE // 8, host_buffers.HUGE_PAGE),
    (host_buffers.HUGE_PAGE // 8 + 3, 2 * host_buffers.HUGE_PAGE),
    (3 * host_buffers.HUGE_PAGE // 8 - 1, 3 * host_buffers.HUGE_PAGE)])
def test_a_large_block_maps_whole_huge_pages(pool, n, mapped):
    """From one huge page on, a block maps whole huge pages (what CUDA
    pins fastest); the tensor lent is still exactly ``n`` long."""
    a = _result(pool, n=n, value=5)
    assert a.shape == (n,) and (a == 5).all()
    del a
    [block] = pool._free
    assert block.nbytes == n * 8 and len(block.memory) == mapped


@pytest.mark.parametrize("drop", ["array", "tensor_and_array"])
def test_a_dropped_result_is_reused_and_counted(pool, counting, drop):
    """The block of a result whose last reference is gone answers the
    next take of its size, counted as reused."""
    block = pool.take(N, torch.int64)
    a = block.numpy()
    address = a.ctypes.data
    del a
    if drop == "tensor_and_array":
        del block
        assert pool.free_nbytes() == [N * 8]
        assert _host_counts() == (0, 1)
        assert pool.take(N, torch.int64).data_ptr() == address
        assert _host_counts() == (1, 1)
    else:
        # the tensor still holds the block
        assert pool.free_nbytes() == []
        assert pool.take(N, torch.int64).data_ptr() != address
        assert _host_counts() == (0, 2)


@pytest.mark.parametrize("keep", ["numpy_slice", "numpy_view_of_a_slice",
                                  "torch_view", "astype_view"])
def test_a_view_that_outlives_its_array_keeps_the_block(pool, keep):
    """``a[10:]`` kept and ``a`` dropped: the block stays lent, and the
    view's values stay what they were, until the view goes too."""
    a = _result(pool, value=7)
    address = a.ctypes.data
    view = {"numpy_slice": lambda: a[10:],
            "numpy_view_of_a_slice": lambda: a[10:][::2],
            "torch_view": lambda: torch.from_numpy(a)[10:],
            "astype_view": lambda: a.view(np.uint64)[10:]}[keep]()
    del a
    gc.collect()
    assert pool.free_nbytes() == []
    for v in range(3):
        assert _result(pool, value=v).ctypes.data != address
    assert (np.asarray(view) == 7).all()
    del view
    gc.collect()
    assert len(pool.free_nbytes()) == 2


@pytest.mark.parametrize("old_value", [-1, 1 << 40])
def test_a_block_handed_out_again_is_overwritten_whole(pool, old_value):
    """The next copy into a reused block leaves nothing of the last."""
    a = _result(pool, value=old_value)
    address = a.ctypes.data
    del a
    b = _result(pool, value=3)
    assert b.ctypes.data == address
    assert (b == 3).all()


# -- the free list ------------------------------------------------------------

@pytest.mark.parametrize("n_dropped", [1, 2, 3, 6])
def test_the_free_list_holds_at_most_two(pool, n_dropped, monkeypatch):
    released = []
    monkeypatch.setattr(host_buffers._Block, "release",
                        lambda self: released.append(self.nbytes))
    held = [_result(pool) for _ in range(n_dropped)]
    del held
    assert pool.free_nbytes() == [N * 8] * min(n_dropped, 2)
    assert released == [N * 8] * max(n_dropped - 2, 0)


@pytest.mark.parametrize("sizes, kept", [
    # a block of another size goes first, the oldest of them
    ([1, 2, 2], [2, 2]),
    ([2, 1, 2], [2, 2]),
    ([1, 3, 2], [3, 2]),
    # all of one size: the oldest goes
    ([2, 2, 2], [2, 2]),
    # the newest is the odd one: the oldest of the others goes
    ([2, 2, 1], [2, 1]),
])
def test_another_size_is_evicted_first(pool, sizes, kept, monkeypatch):
    released = []
    monkeypatch.setattr(host_buffers._Block, "release",
                        lambda self: released.append(self.nbytes // (N * 8)))
    held = [_result(pool, n=s * N) for s in sizes]
    while held:
        held.pop(0)
    assert [b // (N * 8) for b in pool.free_nbytes()] == kept
    assert sorted(released + kept) == sorted(sizes)


def test_a_block_given_back_under_the_lock_is_settled_after(pool):
    """A finalizer that runs while the pool's lock is held (the garbage
    collector inside ``take``) queues its block without waiting; the
    next caller moves it to the free list."""
    a = _result(pool)
    with pool._lock:
        del a
        assert len(pool._returned) == 1 and pool._free == []
    assert pool.free_nbytes() == [N * 8]


def test_threads_never_share_a_lent_block(pool, counting):
    """More threads than cores take, fill, hold and drop blocks of two
    sizes, with the interpreter switching threads as often as it can: no
    block is lent twice at once (each thread's values survive the others'
    copies), at most two stay free, and every take is counted once."""
    n_threads = (os.cpu_count() or 2) + 2
    rounds = 60
    errors = []

    def work(t):
        try:
            held = []
            for r in range(rounds):
                n = N if (t + r) % 3 else 2 * N
                a = _result(pool, n=n, value=t * rounds + r)
                held.append((a, t * rounds + r))
                if len(held) > 2:
                    b, v = held.pop(0)
                    if not (b == v).all():
                        errors.append((t, r))
            for b, v in held:
                if not (b == v).all():
                    errors.append((t, "end"))
        except Exception as e:  # reported below, with the thread's number
            errors.append((t, repr(e)))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(th.is_alive() for th in threads)
    assert errors == []
    gc.collect()
    assert len(pool.free_nbytes()) <= 2
    assert sum(_host_counts()) == n_threads * rounds


def test_an_empty_take(pool):
    block = pool.take(0, torch.int64)
    assert block.shape == (0,) and block.numpy().shape == (0,)


# -- the counters -------------------------------------------------------------

@pytest.mark.parametrize("session", ["none", "profiler"])
def test_counters_count_only_while_a_session_records(pool, session):
    profiling.reset_counters()
    first = _result(pool)
    del first
    if session == "profiler":
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            kept = _result(pool)     # the freed block
            _result(pool, n=2 * N)   # a new one
        assert _host_counts() == (1, 1)
    else:
        kept = _result(pool)
        _result(pool, n=2 * N)
        assert _host_counts() == (0, 0)
    del kept
    profiling.reset_counters()
    assert _host_counts() == (0, 0)


def test_counters_are_returned_beside_k2s(counting, pool):
    _result(pool)
    c = profiling.counters(torch.device("cpu"))
    assert set(c) == set(profiling.K2_COUNTERS) | set(
        profiling.HOST_COUNTERS)
    assert c["host_counts.allocated"] == 1


# -- map_kmers ----------------------------------------------------------------

def _index(kmers, device="cpu", seed=5):
    """(KmerIndex of ``kmers`` on random nodes, n_nodes)."""
    rng = np.random.default_rng(seed)
    n_rows = len(kmers)
    index = KmerIndex.from_rows(kmers, rng.integers(0, 700, n_rows),
                                np.zeros(n_rows, np.uint64),
                                np.ones(n_rows, np.float32), 1009,
                                device=device)
    return index, 700


def _kmers(n_rows=4000, seed=5):
    rng = np.random.default_rng(seed)
    return rng.choice(1 << 40, n_rows, replace=False).astype(np.uint64)


def _queries(kmers, seed):
    """Half of them the index's k-mers, half uniform."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.choice(kmers, 2000),
                           rng.integers(0, 1 << 40, 2000, dtype=np.uint64)])


@pytest.mark.parametrize("queries_as", ["numpy", "tensor"])
def test_map_kmers_on_a_cpu_index_takes_no_block(monkeypatch, queries_as):
    """On the CPU the counts are host memory already: no block is taken,
    and the answer is the device lookup's own."""
    kmers = _kmers()
    index, n_nodes = _index(kmers)
    queries = _queries(kmers, 1)
    if queries_as == "tensor":
        queries = torch.from_numpy(queries.view(np.int64))

    def _boom(*args, **kwargs):
        raise AssertionError("the pool was used on the CPU")

    monkeypatch.setattr(host_buffers, "take", _boom)
    got = index.map_kmers(queries, n_nodes)
    want = index.device_index.map_kmers(index._queries(queries), n_nodes)
    assert got.dtype == np.int64 and got.shape == (n_nodes,)
    assert np.array_equal(got, want.numpy())


# -- the card -----------------------------------------------------------------

@pytest.fixture
def card():
    """The CUDA device, or a skip: decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the pool pins only for a card")
    return torch.device("cuda:0")


def _fasta(path, seed, n_reads=200, length=90):
    """Random reads, another set for each seed."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n_reads):
            f.write(f">r{i}\n{''.join(rng.choice(list('ACGT'), length))}\n")
    return str(path)


def _capture(monkeypatch):
    """Each launch's counts, copied on the card before map_kmers' copy."""
    launches = []
    for name in ("map_kmers", "map_read_kmers"):
        plain = getattr(DeviceKmerIndex, name)

        def wrapped(self, *args, _plain=plain, **kwargs):
            counts = _plain(self, *args, **kwargs)
            launches.append(counts.clone())
            return counts

        monkeypatch.setattr(DeviceKmerIndex, name, wrapped)
    return launches


@pytest.mark.card
@pytest.mark.parametrize("queries_as", ["numpy", "device_read_kmers"])
def test_map_kmers_on_the_card_returns_pinned_plain_copies(
        card, monkeypatch, tmp_path, queries_as):
    """int64 of length n_nodes, pinned, equal bit for bit to
    ``counts.cpu().numpy()`` of the same launch; three results held
    across further calls on other queries stay equal to their own plain
    copies."""
    if queries_as == "numpy":
        kmers = _kmers()
        batches = [_queries(kmers, seed) for seed in range(5)]
    else:
        paths = [_fasta(tmp_path / f"r{seed}.fa", seed) for seed in range(5)]
        hashes = np.unique(np.concatenate([
            hash_fasta_file(p, 31, device="cpu",
                            include_reverse_complements=True).to_numpy()
            for p in paths]))
        kmers = np.random.default_rng(9).choice(hashes, 4000, replace=False)
        batches = [hash_fasta_file(p, 31, device=card,
                                   include_reverse_complements=True)
                   for p in paths]
    index, n_nodes = _index(kmers, device=card)
    launches = _capture(monkeypatch)
    held, plain = [], []
    for queries in batches[:3]:
        got = index.map_kmers(queries, n_nodes)
        want = launches[-1].cpu().numpy()
        assert got.dtype == np.int64 and got.shape == (n_nodes,)
        assert got.flags.c_contiguous
        assert torch.from_numpy(got).is_pinned()
        assert np.array_equal(got, want)
        held.append(got)
        plain.append(want)
    assert len({a.ctypes.data for a in held}) == 3
    for queries in batches[3:] * 2:
        got = index.map_kmers(queries, n_nodes)
        assert np.array_equal(got, launches[-1].cpu().numpy())
    for got, want in zip(held, plain):
        assert np.array_equal(got, want)
    assert all(int(a.sum()) > 0 for a in held)


@pytest.mark.card
def test_pinned_blocks_are_reused_and_unpinned(card, monkeypatch):
    """A pinned pool on the card: a dropped block comes back pinned to
    the next take, and an evicted block is unpinned."""
    released = []
    release = host_buffers._Block.release

    def watched(self):
        release(self)
        released.append(torch.from_numpy(
            np.frombuffer(self.memory, np.uint8)).is_pinned())

    monkeypatch.setattr(host_buffers._Block, "release", watched)
    pool = host_buffers.HostBlockPool()
    a = pool.take(N, torch.int64)
    a.copy_(torch.arange(N, dtype=torch.int64, device=card))
    address = a.data_ptr()
    assert a.is_pinned() and np.array_equal(a.numpy(), np.arange(N))
    del a
    b = pool.take(N, torch.int64)
    assert b.data_ptr() == address and b.is_pinned()
    held = [pool.take(N, torch.int64) for _ in range(3)]
    assert all(t.is_pinned() for t in held)
    del held
    assert pool.free_nbytes() == [N * 8] * 2
    assert released == [False]
