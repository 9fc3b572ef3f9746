"""The rolled upload of read k-mer queries
(graph_kmer_index_tpu_torch/ops/rolled.py, csrc/host/rolled.cpp,
csrc/rolled_decode.cu, and the staging ring's use of them in
ops/host_buffers.py). On the CPU the native encoder's form is decoded by
a plain numpy twin here, which rolls each run from its anchor one digit at
a time, and by the module's own plain twin of the kernel; the ring runs
against a CPU destination. Every result is held bit for bit to the input.

The tests marked ``card`` hold the decode kernel, the ring and
``map_kmers`` against the plain upload on a CUDA card; they skip without
one. This file imports no JAX: ``python -m pytest --noconftest -p
no:cacheprovider -m card tests/test_torch_rolled_upload.py``."""
import numpy as np
import pytest
import torch

from graph_kmer_index_tpu_torch import native
from graph_kmer_index_tpu_torch.models.kmer_index import KmerIndex
from graph_kmer_index_tpu_torch.ops import host_buffers, rolled
from graph_kmer_index_tpu_torch.ops.lookup import as_device_tensor
from graph_kmer_index_tpu_torch.utils import profiling

CPU = torch.device("cpu")
ROLL_COUNTERS = ("upload.rolled", "upload.anchors", "upload.rolled_bytes",
                 "upload.staged_bytes")
# queries a task of the encoder scans: csrc/host/rolled.cpp kSlice
SLICE = 64 * rolled.TILE
READ = 150


@pytest.fixture(autouse=True)
def _native_library():
    if not native.available():
        pytest.fail(f"the native library did not build: "
                    f"{native.build_error()}")


@pytest.fixture
def counting(monkeypatch):
    """The counters zeroed, and counted as under a profiler session."""
    profiling.reset_counters()
    monkeypatch.setattr(profiling, "active", lambda: True)
    yield
    profiling.reset_counters()


def _counters():
    c = profiling.counters()
    return tuple(c[name] for name in ROLL_COUNTERS)


# -- inputs -------------------------------------------------------------------

def _reads(n_reads, seed, poly_a=False):
    reads = np.random.default_rng(seed).integers(0, 4, (n_reads, READ),
                                                 dtype=np.int8)
    if poly_a:
        # a stretch of As inside every third read, and one read all As
        reads[::3, 20:110] = 0
        reads[1] = 0
    return reads


def _read_hashes(reads, k, strand="both"):
    """The k-mers of each read, read by read, forward half then reverse
    complement half, as hash_fasta_file lays them out (first base lowest)."""
    n, length = reads.shape
    w = length - k + 1
    fw = np.zeros((n, w), np.uint64)
    rc = np.zeros((n, w), np.uint64)
    for j in range(k):
        b = reads[:, j:j + w].astype(np.uint64)
        fw |= b << np.uint64(2 * j)
        rc |= (np.uint64(3) - b) << np.uint64(2 * (k - 1 - j))
    halves = {"forward": [fw], "reverse": [rc], "both": [fw, rc]}[strand]
    return np.concatenate([h.reshape(-1) for h in halves])


def _random(n, seed):
    return np.random.default_rng(seed).integers(
        0, np.iinfo(np.uint64).max, n, dtype=np.uint64, endpoint=True)


def _form_buffer(nbytes=host_buffers.ROLL_BYTES):
    return torch.empty(nbytes, dtype=torch.uint8)


def _encode(h, nbytes=host_buffers.ROLL_BYTES):
    out = _form_buffer(nbytes)
    form = rolled.encode(torch.from_numpy(np.ascontiguousarray(h)
                                          .view(np.int64)), out)
    return form, out.numpy()


# -- the tests' twin ----------------------------------------------------------

def _decode_numpy(form, buf):
    """The queries of a rolled form, rolled from each anchor one digit at a
    time, all runs side by side."""
    n, w = form.n, form.w
    words = buf[:8 * (-(-n // 32))].view(np.uint64)
    i = np.arange(n)
    digits = (words[i // 32] >> (2 * (i % 32)).astype(np.uint64)) \
        & np.uint64(3)
    records = buf[form.anchors:form.anchors + 16 * form.n_anchors]
    keys = records.view(np.int32).reshape(-1, 4)[:, 2]
    values = records.view(np.uint64).reshape(-1, 2)[:, 0]
    assert not records.view(np.int32).reshape(-1, 4)[:, 3].any()
    at, reverse = keys >> 1, (keys & 1).astype(bool)
    assert at[0] == 0 and np.all(np.diff(at) > 0)
    ends = np.append(at[1:], n)
    mask = np.uint64((1 << (2 * w)) - 1 if w < 32 else (1 << 64) - 1)
    top = np.uint64(2 * w - 2)
    two = np.uint64(2)
    out = np.empty(n, np.uint64)
    out[at] = values
    h = values.copy()
    for step in range(1, int((ends - at).max())):
        live = at + step < ends
        q = at[live] + step
        d = digits[q]
        hv, rv = h[live], reverse[live]
        hv = np.where(rv, ((hv << two) & mask) | d, (hv >> two) | (d << top))
        h[live] = hv
        out[q] = hv
    return out


# -- the encoder and the twins ----------------------------------------------

@pytest.mark.parametrize("k", [1, 15, 21, 31])
@pytest.mark.parametrize("strand", ["forward", "reverse", "both"])
def test_read_kmers_come_back_bit_for_bit(k, strand):
    """Both halves of read k-mers roll: one anchor a read strand, one at
    each task's first query, and nothing else sent whole."""
    h = _read_hashes(_reads(400, seed=k), k, strand)
    form, buf = _encode(h)
    assert form is not None and form.w == k
    assert np.array_equal(_decode_numpy(form, buf), h)
    strands = len(h) // (READ - k + 1)
    slices = -(-len(h) // SLICE)
    # k = 1: every query rolls both ways, so only the tasks' first anchor
    assert form.n_anchors <= (slices if k == 1 else strands + slices)
    assert form.nbytes < len(h) * 8 / (4 if k == 1 else 12)


def test_poly_a_runs_roll_both_ways():
    """Stretches of As (hash 0 rolls forward and reverse alike), a read of
    As alone, and a chunk of zeros come back exactly."""
    h = _read_hashes(_reads(300, seed=4, poly_a=True), 31)
    form, buf = _encode(h)
    assert form is not None
    assert np.array_equal(_decode_numpy(form, buf), h)
    zeros = np.zeros(5 * SLICE // 2 + 3, np.uint64)
    form, buf = _encode(zeros)
    assert form is not None and form.w == 1 and form.n_anchors == 3
    assert np.array_equal(_decode_numpy(form, buf), zeros)


@pytest.mark.parametrize("order", ["shuffled", "sorted", "random"])
def test_queries_in_no_read_order_take_the_plain_copy(order):
    h = {"shuffled": lambda: np.random.default_rng(1).permutation(
            _read_hashes(_reads(100, seed=2), 31)),
         "sorted": lambda: np.sort(_read_hashes(_reads(100, seed=2), 31)),
         "random": lambda: _random(30_000, 5)}[order]()
    assert _encode(h)[0] is None


@pytest.mark.parametrize("k, bit", [(31, 62), (31, 63), (21, 42), (21, 43),
                                    (21, 63)])
def test_high_bits_cost_anchors_never_an_answer(k, bit):
    """Hashes with a bit at or above 2k set: in the probe such a hash sets
    a wider width and the read k-mers no longer roll (the plain copy);
    after it, each is sent whole, and so is the query after it, in both
    halves."""
    h = _read_hashes(_reads(200, seed=6), k)
    first = h.copy()
    first[100] |= np.uint64(1 << bit) | np.uint64(1 << 63)
    assert _encode(first)[0] is None
    later = h.copy()
    marked = np.arange(5000, len(h), 997)
    later[marked] |= np.uint64(1 << bit)
    form, buf = _encode(later)
    assert form is not None and form.w == k
    assert np.array_equal(_decode_numpy(form, buf), later)
    plain, _ = _encode(h)
    assert form.n_anchors >= plain.n_anchors + len(marked)


def _rolls(k, n, seed):
    """A forward roll of n steps, then a reverse one, of k digits: with
    k = 32 every one of the 64 bits."""
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 4, n).astype(np.uint64)
    mask = np.uint64((1 << (2 * k)) - 1 if k < 32 else (1 << 64) - 1)
    fw = np.empty(n, np.uint64)
    rv = np.empty(n, np.uint64)
    f = r = np.uint64(rng.integers(0, 1 << 62)) & mask
    f |= np.uint64(3 << (2 * k - 2))
    for i, b in enumerate(bases):
        f = (f >> np.uint64(2)) | (b << np.uint64(2 * k - 2))
        r = ((r << np.uint64(2)) & mask) | b
        fw[i], rv[i] = f, r
    return np.concatenate([fw, rv])


@pytest.mark.parametrize("k", [15, 32])
def test_the_widest_rolls(k):
    """A roll of 32 digits uses all 64 bits, in both directions."""
    h = _rolls(k, 4000, seed=k)
    form, buf = _encode(h)
    assert form is not None and form.w == k and form.n_anchors == 2
    assert np.array_equal(_decode_numpy(form, buf), h)
    got = torch.empty(len(h), dtype=torch.int64)
    rolled.decode(form, torch.from_numpy(buf), got)
    assert np.array_equal(got.numpy().view(np.uint64), h)


@pytest.mark.parametrize("case", ["reads", "poly_a", "sparse_breaks"])
def test_the_kernels_plain_twin_equals_the_tests_twin(case):
    h = _read_hashes(_reads(250, seed=9, poly_a=case == "poly_a"), 21)
    if case == "sparse_breaks":
        # one query in 50 replaced: runs of every length below w
        h[::50] = _random(len(h[::50]), 3) >> np.uint64(22)
    form, buf = _encode(h)
    assert form is not None
    got = torch.empty(len(h), dtype=torch.int64)
    rolled.decode_plain(form, torch.from_numpy(buf), got)
    got = got.numpy().view(np.uint64)
    assert np.array_equal(got, _decode_numpy(form, buf))
    assert np.array_equal(got, h)


@pytest.mark.parametrize("threads", [1, 3])
def test_the_form_does_not_depend_on_the_threads(threads):
    h = _read_hashes(_reads(1500, seed=8), 31)
    before = torch.get_num_threads()
    try:
        torch.set_num_threads(threads)
        form, buf = _encode(h)
    finally:
        torch.set_num_threads(before)
    want, want_buf = _encode(h)
    assert form == want
    assert np.array_equal(buf[:form.nbytes], want_buf[:want.nbytes])


def test_short_reads_fill_a_whole_chunk_within_its_room():
    """Reads of 50 bp (one anchor in 20 at k = 31, near the probe's one in
    16): a chunk of the ring's size keeps its anchors within the form's
    room and rolls."""
    h = _read_hashes(_reads(-(-host_buffers.ROLL_QUERIES // 40), seed=19)[
        :, :50], 31)[:host_buffers.ROLL_QUERIES]
    form, buf = _encode(h)
    assert form is not None and form.n_anchors >= len(h) // 20
    assert np.array_equal(_decode_numpy(form, buf), h)


def test_anchors_past_the_room_leave_the_chunk_to_the_plain_copy():
    """The probe sees read k-mers, the rest is random: more anchors than
    the form has room for."""
    h = _read_hashes(_reads(100, seed=10), 31)
    h[8192:] = _random(len(h) - 8192, 11)
    assert _encode(h, nbytes=1 << 16)[0] is None
    form, buf = _encode(h)
    assert form is not None
    assert np.array_equal(_decode_numpy(form, buf), h)


def test_the_tile_table_counts_the_anchors_before_each_tile():
    h = _read_hashes(_reads(200, seed=12), 31)
    form, buf = _encode(h)
    tiles = buf[form.tiles:form.tiles + 4 * (-(-len(h) // rolled.TILE) + 1)
                ].view(np.int32)
    at = buf[form.anchors:form.anchors + 16 * form.n_anchors].view(
        np.int32).reshape(-1, 4)[:, 2] >> 1
    starts = np.arange(len(tiles) - 1) * rolled.TILE
    assert np.array_equal(tiles[:-1], np.searchsorted(at, starts))
    assert tiles[-1] == form.n_anchors


# -- the ring -----------------------------------------------------------------

def _ring(roll_queries=host_buffers.ROLL_QUERIES, blocks=3,
          stage_bytes=host_buffers.STAGE_BYTES):
    """A CPU ring: the rolled form decoded by the kernel's plain twin."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(host_buffers, "STAGE_BLOCKS", blocks)
        mp.setattr(host_buffers, "STAGE_BYTES", stage_bytes)
        mp.setattr(host_buffers, "ROLL_QUERIES", roll_queries)
        return host_buffers.StagingRing(CPU)


@pytest.mark.parametrize("roll_queries", [50_003, SLICE, 1 << 22])
def test_runs_across_chunk_and_slice_edges_come_back_intact(counting,
                                                            roll_queries):
    """Read strands cut by the ring's chunks and by the encoder's slices;
    every chunk rolled, each edge one anchor more."""
    h = _read_hashes(_reads(1200, seed=13), 31)
    got = _ring(roll_queries).upload(h)
    assert np.array_equal(got.numpy().view(np.uint64), h)
    n_rolled, anchors, nbytes, staged = _counters()
    assert staged == 0 and n_rolled + anchors == len(h)
    strands = len(h) // (READ - 30)
    assert strands <= anchors <= strands + len(h) // roll_queries \
        + len(h) // SLICE + 2
    assert 0 < nbytes < len(h) * 8 / 12


@pytest.mark.parametrize("kind", ["empty", "one", "strided", "int32",
                                  "two_dims"])
def test_the_ring_keeps_every_array_whole(counting, kind):
    """Empty and length-1 arrays, a strided view of read k-mers and a
    tensor of another dtype take the plain copy; a 2-D array of read
    k-mers comes back in its shape, rolled."""
    h = _read_hashes(_reads(40, seed=14), 31)
    queries = {"empty": h[:0], "one": h[:1],
               "strided": np.repeat(h, 2)[::2],
               "int32": torch.from_numpy(
                   (h & np.uint64(0x7FFFFFFF)).astype(np.int32)),
               "two_dims": h.reshape(-1, 80)}[kind]
    got = _ring().upload(queries)
    want = as_device_tensor(queries, torch.int64, CPU)
    assert got.shape == want.shape and torch.equal(got, want)
    n = len(h) if kind not in ("empty", "one") else len(queries)
    rolls = kind == "two_dims"
    assert _counters()[3] == (0 if rolls else n * 8)
    assert (_counters()[0] > 0) == rolls


@pytest.mark.parametrize("order", ["shuffled", "mixed"])
def test_chunks_that_do_not_roll_go_plain_beside_those_that_do(counting,
                                                               order):
    """A shuffled array goes plain, chunk by chunk; reads then random
    hashes go rolled, then plain."""
    reads = _read_hashes(_reads(100, seed=15), 31)
    h = (np.random.default_rng(2).permutation(reads) if order == "shuffled"
         else np.concatenate([reads, _random(len(reads), 16)]))
    ring = _ring(roll_queries=len(reads), stage_bytes=4096 * 8)
    got = ring.upload(h)
    assert np.array_equal(got.numpy().view(np.uint64), h)
    n_rolled, anchors, _, staged = _counters()
    want_rolled = 0 if order == "shuffled" else len(reads)
    assert n_rolled + anchors == want_rolled
    assert staged == (len(h) - want_rolled) * 8


@pytest.mark.parametrize("session", ["none", "profiler"])
def test_rolled_counters_count_only_while_a_session_records(session):
    profiling.reset_counters()
    h = _read_hashes(_reads(60, seed=17), 31)
    ring = _ring()
    if session == "profiler":
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            ring.upload(h)
            ring.upload(_random(50, 18))
        n_rolled, anchors, nbytes, staged = _counters()
        assert n_rolled + anchors == len(h) and anchors >= 120
        assert 0 < nbytes < len(h) and staged == 50 * 8
    else:
        ring.upload(h)
        ring.upload(_random(50, 18))
        assert _counters() == (0, 0, 0, 0)
    profiling.reset_counters()
    assert _counters() == (0, 0, 0, 0)


# -- the card -----------------------------------------------------------------

@pytest.fixture
def card():
    """The CUDA device, or a skip: decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the decode kernel runs only on a card")
    return torch.device("cuda:0")


def _big_read_hashes(n, seed):
    """n read k-mers (k = 31), read by read: tiled from 2^16 reads."""
    base = _read_hashes(_reads(1 << 16, seed), 31)
    return np.resize(base, n)


@pytest.mark.card
@pytest.mark.parametrize("order", ["reads", "shuffled"])
def test_a_card_upload_of_2_27_hashes_equals_the_input(card, counting, order):
    h = _big_read_hashes((1 << 27) + 12_345, seed=21)
    if order == "shuffled":
        h = np.random.default_rng(22).permutation(h)
    got = host_buffers.upload(h, card)
    torch.cuda.synchronize(card)
    assert torch.equal(got.cpu(), torch.from_numpy(h.view(np.int64)))
    n_rolled, anchors, _, staged = _counters()
    if order == "reads":
        assert n_rolled + anchors == len(h) and staged == 0
        assert anchors < len(h) // 100
    else:
        assert n_rolled == 0 and anchors == 0 and staged == h.nbytes


@pytest.mark.card
@pytest.mark.parametrize("case", ["k1", "k15", "k21", "k32",
                                  "sparse_breaks", "poly_a"])
def test_the_decode_kernel_equals_its_plain_twin(card, case):
    k = {"k1": 1, "k15": 15, "k21": 21}.get(case, 31)
    h = (_rolls(32, 100_000, seed=23) if case == "k32" else
         _read_hashes(_reads(2000, seed=23, poly_a=case == "poly_a"), k))
    if case == "sparse_breaks":
        h[::50] = _random(len(h[::50]), 24) >> np.uint64(2)
    form, buf = _encode(h)
    assert form is not None
    device_form = torch.from_numpy(buf).to(card)
    got = torch.empty(len(h), dtype=torch.int64, device=card)
    rolled.decode(form, device_form, got)
    want = torch.empty(len(h), dtype=torch.int64)
    rolled.decode_plain(form, torch.from_numpy(buf), want)
    assert torch.equal(got.cpu(), want)
    assert np.array_equal(want.numpy().view(np.uint64), h)


@pytest.mark.card
def test_back_to_back_rolled_uploads_come_out_intact(card):
    n = 3 * host_buffers.ROLL_QUERIES + 7
    first, second = _big_read_hashes(n, 25), _big_read_hashes(n, 26)
    got = [host_buffers.upload(first, card), host_buffers.upload(second, card)]
    torch.cuda.synchronize(card)
    for g, a in zip(got, (first, second)):
        assert torch.equal(g.cpu(), torch.from_numpy(a.view(np.int64)))


@pytest.mark.card
@pytest.mark.parametrize("strand", ["forward", "reverse", "both"])
def test_map_kmers_through_the_rolled_form_equals_the_plain_path(
        card, counting, strand):
    reads = _reads(20_000, seed=27)
    h = _read_hashes(reads, 31, strand)
    rng = np.random.default_rng(28)
    rows = rng.choice(h, 50_000, replace=False)
    index = KmerIndex.from_rows(rows, rng.integers(0, 700, len(rows)),
                                np.zeros(len(rows), np.uint64),
                                np.ones(len(rows), np.float32), 1009,
                                device=card)
    got = index.map_kmers(h, 700)
    plain = index.device_index.map_kmers(
        as_device_tensor(h, torch.int64, card), 700).cpu().numpy()
    assert np.array_equal(got, plain) and int(got.sum()) >= len(rows)
    assert _counters()[0] > 0 and _counters()[3] == 0


@pytest.mark.card
def test_shuffled_queries_leave_the_rolled_counters_at_zero(card, counting):
    h = np.random.default_rng(29).permutation(
        _big_read_hashes(3 * host_buffers.STAGE_BYTES // 8, 30))
    got = host_buffers.upload(h, card)
    torch.cuda.synchronize(card)
    assert torch.equal(got.cpu(), torch.from_numpy(h.view(np.int64)))
    assert _counters() == (0, 0, 0, h.nbytes)
