"""The staging ring of host-to-card uploads
(graph_kmer_index_tpu_torch/ops/host_buffers.py: ``StagingRing``,
``upload``) and ``KmerIndex._queries``' use of it. On the CPU a ring of
small pageable blocks runs the same loop against a CPU destination, held
bit for bit to ``as_device_tensor``; its events are stand-ins that tell
whether a block was refilled before its copy had completed.

The tests marked ``card`` hold the pinned ring against the plain upload
on a CUDA card, ``map_kmers`` through both, and the count pool as
untouched by the ring; they skip without a CUDA card. This file imports
no JAX: ``python -m pytest --noconftest -p no:cacheprovider -m card
tests/test_torch_staged_upload.py``."""
import numpy as np
import pytest
import torch

from graph_kmer_index_tpu_torch.models.kmer_index import KmerIndex
from graph_kmer_index_tpu_torch.ops import host_buffers
from graph_kmer_index_tpu_torch.ops.lookup import as_device_tensor
from graph_kmer_index_tpu_torch.utils import profiling

CPU = torch.device("cpu")
# int64 elements a block of the CPU tests' rings holds
C = 64
UPLOAD_COUNTERS = ("upload.staged_bytes", "upload.ring_waits")


@pytest.fixture
def counting(monkeypatch):
    """The counters zeroed, and counted as under a profiler session."""
    profiling.reset_counters()
    monkeypatch.setattr(profiling, "active", lambda: True)
    yield
    profiling.reset_counters()


def _ring():
    """A CPU ring of 3 pageable blocks of ``C`` elements."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(host_buffers, "STAGE_BLOCKS", 3)
        mp.setattr(host_buffers, "STAGE_BYTES", C * 8)
        return host_buffers.StagingRing(CPU)


def _uploads():
    c = profiling.counters()
    return tuple(c[name] for name in UPLOAD_COUNTERS)


def _hashes(n, seed=3):
    """uint64 hashes over the whole range, 2^63 and 2^64 - 1 among them."""
    a = np.random.default_rng(seed).integers(
        0, np.iinfo(np.uint64).max, n, dtype=np.uint64, endpoint=True)
    a[:2] = [1 << 63, (1 << 64) - 1][:n]
    return a


def _as(kind, a):
    """The hashes ``a`` in the form a caller may hand them over."""
    if kind == "uint64":
        return a
    if kind == "int64":
        return a.view(np.int64)
    if kind == "strided":
        return np.repeat(a, 2)[::2]
    if kind == "reversed":
        return a[::-1]
    if kind == "list":
        return [int(x) for x in a]
    if kind == "field":
        # a field of a record array: a stride of 9 bytes
        records = np.zeros(len(a), [("hash", np.uint64), ("tag", np.uint8)])
        records["hash"] = a
        return records["hash"]
    return torch.from_numpy(a.view(np.int64))


# -- the ring against a CPU destination ---------------------------------------

@pytest.mark.parametrize("n", [0, 1, C - 1, C, C + 1, 7 * C // 2])
@pytest.mark.parametrize("kind", ["uint64", "int64", "strided", "reversed",
                                  "field", "list", "tensor"])
def test_an_upload_is_bit_equal_to_the_plain_one(n, kind):
    queries = _as(kind, _hashes(n))
    # as_device_tensor takes no list, nor a reversed array or a record
    # field of one element
    plain = {"list": lambda: np.asarray(queries, dtype=np.uint64),
             "reversed": lambda: queries.copy(),
             "field": lambda: queries.copy()}.get(kind, lambda: queries)()
    got = _ring().upload(queries)
    want = as_device_tensor(plain, torch.int64, CPU)
    assert got.dtype == torch.int64 and got.shape == (n,)
    assert torch.equal(got, want)
    order = slice(None, None, -1 if kind == "reversed" else 1)
    assert np.array_equal(got.numpy().view(np.uint64), _hashes(n)[order])


@pytest.mark.parametrize("n, chunks", [
    (0, 0), (1, 1), (C - 1, 1), (C, 1), (C + 1, 2), (7 * C // 2, 4)])
def test_every_upload_goes_through_the_ring_in_chunks_of_a_block(
        counting, n, chunks):
    """Whatever its size: chunks of a block through the ring in turn, every
    byte counted as staged; the blocks are made at the first upload."""
    ring = _ring()
    ring.upload(_hashes(n))
    assert len(ring._blocks) == 3
    assert ring._next == chunks % 3
    assert _uploads() == (n * 8, 0)


def test_an_upload_keeps_the_shape_of_its_array():
    """A 2-D array (a strided view of one, here) comes back in its shape,
    its elements in order, through the ring's chunks."""
    a = _hashes(6 * C).reshape(2 * C, 3)[:, ::2]
    got = _ring().upload(a)
    assert got.shape == a.shape
    assert torch.equal(got, as_device_tensor(a, torch.int64, CPU))


def test_the_ring_takes_its_blocks_in_turn_across_calls():
    ring = _ring()
    for calls, n in enumerate([C + 1, 2 * C, C], start=1):
        ring.upload(_hashes(n, seed=calls))
    assert ring._next == (2 + 2 + 1) % 3
    assert len(ring._blocks) == 3 and len(ring._staging) == 3


class _InFlight:
    """A stand-in for a block's CUDA event whose copy completes only when
    waited on. Recording it keeps what the block holds then, which the
    copy would read; the wait fails if the block was written since."""

    def __init__(self, block):
        self.block = block
        self.sent = None

    def record(self, stream=None):
        self.sent = self.block.clone()

    def query(self):
        return self.sent is None

    def synchronize(self):
        assert torch.equal(self.block, self.sent), \
            "a block was refilled before its copy completed"
        self.sent = None


def test_a_block_is_refilled_only_after_its_copy_completes(monkeypatch,
                                                           counting):
    """Two uploads back to back, no wait between them: every reuse of a
    block, within a call and across the two, waits for that block's last
    copy before the block is written, and is counted as a wait."""
    ring = _ring()
    made = []

    def in_flight(self):
        made.append(_InFlight(None))
        return made[-1]

    monkeypatch.setattr(host_buffers.StagingRing, "_event", in_flight)
    ring._make_blocks()
    for event, block in zip(made, ring._staging):
        event.block = block
    first, second = _hashes(7 * C // 2, seed=1), _hashes(7 * C // 2, seed=2)
    got = [ring.upload(first), ring.upload(second)]
    assert torch.equal(got[0], torch.from_numpy(first.view(np.int64)))
    assert torch.equal(got[1], torch.from_numpy(second.view(np.int64)))
    # 8 chunks over 3 blocks: the first 3 find fresh blocks
    assert _uploads() == (2 * len(first) * 8, 8 - 3)


# -- the counters -------------------------------------------------------------

@pytest.mark.parametrize("session", ["none", "profiler"])
def test_upload_counters_count_only_while_a_session_records(session):
    profiling.reset_counters()
    ring = _ring()
    if session == "profiler":
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            ring.upload(_hashes(2 * C))
            ring.upload(_hashes(5))
        assert _uploads() == ((2 * C + 5) * 8, 0)
    else:
        ring.upload(_hashes(2 * C))
        ring.upload(_hashes(5))
        assert _uploads() == (0, 0)
    profiling.reset_counters()
    assert _uploads() == (0, 0)


# -- KmerIndex._queries -------------------------------------------------------

def _index(device="cpu", n_rows=4000, seed=5):
    """(KmerIndex of random k-mers on random nodes, its k-mers, n_nodes)."""
    rng = np.random.default_rng(seed)
    kmers = rng.choice(1 << 40, n_rows, replace=False).astype(np.uint64)
    index = KmerIndex.from_rows(kmers, rng.integers(0, 700, n_rows),
                                np.zeros(n_rows, np.uint64),
                                np.ones(n_rows, np.float32), 1009,
                                device=device)
    return index, kmers, 700


def _map_queries(kmers, n, seed):
    """Half of them the index's k-mers, half uniform."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.choice(kmers, n // 2),
                           rng.integers(0, 1 << 40, n - n // 2,
                                        dtype=np.uint64)])


@pytest.mark.parametrize("queries_as", ["uint64", "tensor"])
def test_a_cpu_index_reads_host_queries_in_place(monkeypatch, queries_as):
    index, kmers, _ = _index()
    queries = _map_queries(kmers, host_buffers.STAGE_BYTES // 8 + 1, 1)
    if queries_as == "tensor":
        queries = torch.from_numpy(queries.view(np.int64))

    def _boom(*args, **kwargs):
        raise AssertionError("the staging ring was used on the CPU")

    monkeypatch.setattr(host_buffers, "upload", _boom)
    q = index._queries(queries)
    address = (queries.data_ptr() if queries_as == "tensor"
               else queries.ctypes.data)
    assert q.dtype == torch.int64 and q.data_ptr() == address


@pytest.mark.parametrize("n", [5, 1000])
def test_a_cuda_index_stages_its_host_queries(monkeypatch, counting, n):
    """A host query set bound for a CUDA device goes through the device's
    ring, under one block as over it (here a CPU ring in the CUDA
    device's place)."""
    index, kmers, _ = _index()
    queries = _map_queries(kmers, n, 2)
    index.device = torch.device("cuda", 0)
    ring = _ring()
    monkeypatch.setattr(host_buffers, "_RINGS",
                        {torch.device("cuda", 0): ring})
    q = index._queries(queries)
    assert np.array_equal(q.numpy().view(np.uint64), queries)
    assert ring._next == -(-n // C) % 3
    assert _uploads() == (n * 8, 0)


# -- the card -----------------------------------------------------------------

@pytest.fixture
def card():
    """The CUDA device, or a skip: decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the staging ring pins only for a card")
    return torch.device("cuda:0")


@pytest.mark.card
def test_a_staged_upload_of_2_27_hashes_equals_the_plain_one(card,
                                                            counting):
    a = _hashes((1 << 27) + 12_345, seed=11)
    got = host_buffers.upload(a, card)
    want = as_device_tensor(a, torch.int64, card)
    torch.cuda.synchronize(card)
    assert got.device == want.device and torch.equal(got, want)
    ring = host_buffers._RINGS[card]
    assert all(t.is_pinned() for t in ring._staging)
    assert _uploads()[0] == a.nbytes


@pytest.mark.card
def test_back_to_back_uploads_come_out_intact(card):
    """Two staged uploads of different arrays with no synchronise between
    them: the second refills blocks whose copies the first issued."""
    n = 5 * host_buffers.STAGE_BLOCKS * host_buffers.STAGE_BYTES // 8 + 7
    first, second = _hashes(n, seed=21), _hashes(n, seed=22)
    got = [host_buffers.upload(first, card), host_buffers.upload(second, card)]
    torch.cuda.synchronize(card)
    for g, a in zip(got, (first, second)):
        assert torch.equal(g, as_device_tensor(a, torch.int64, card))


@pytest.mark.card
@pytest.mark.parametrize("queries_as", ["uint64", "int64", "strided",
                                        "field"])
def test_map_kmers_through_the_ring_equals_the_plain_path(card, queries_as):
    index, kmers, n_nodes = _index(device=card)
    queries = _as(queries_as, _map_queries(
        kmers, 3 * host_buffers.STAGE_BYTES // 8 + 5, 3))
    got = index.map_kmers(queries, n_nodes)
    plain = index.device_index.map_kmers(
        as_device_tensor(np.asarray(queries).view(np.uint64), torch.int64,
                         card), n_nodes).cpu().numpy()
    assert got.dtype == np.int64 and np.array_equal(got, plain)
    assert int(got.sum()) > 0


@pytest.mark.card
def test_staged_uploads_leave_the_count_pool_alone(card, counting):
    index, kmers, n_nodes = _index(device=card)
    queries = _map_queries(kmers, 2 * host_buffers.STAGE_BYTES // 8, 4)
    index.map_kmers(queries, n_nodes)
    free = host_buffers._POOL.free_nbytes()
    before = {k: v for k, v in profiling.counters().items()
              if k.startswith("host_counts.")}
    for _ in range(3):
        host_buffers.upload(queries, card)
    torch.cuda.synchronize(card)
    assert host_buffers._POOL.free_nbytes() == free
    assert {k: v for k, v in profiling.counters().items()
            if k.startswith("host_counts.")} == before
