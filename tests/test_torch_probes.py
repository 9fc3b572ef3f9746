"""The port's lookup probes (graph_kmer_index_tpu_torch.ops.primitives:
gather_loop K6, rmw_loop K7, bcast_cmp K8) against the Pallas kernels of
benchmarks/bench_primitives.py, on the CPU, where the wrappers run their
plain twins.

The benchmark is loaded as it is, with its module switches set to
interpret mode and its small sizes, and its ``_chain_rate`` replaced by a
function that keeps the jitted chain step ``run`` and its inputs. One
call of ``run`` then executes the Pallas kernel; the step it returns is
computed again from the port's twin and must be equal, bit for bit: on
the benchmark's own seeded inputs and on planted inputs of the same
shapes (table values near 2^30 that make the int32 sums wrap, skewed
indices, planted key matches and repeated table keys). Each twin is also
held against a numpy oracle."""
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from graph_kmer_index_tpu_torch.ops import primitives

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _jax_default_types():
    """The benchmark runs with JAX's default 32-bit types. Importing the
    JAX package turns 64-bit types on for the process (another test file
    may have done so in this worker), and the rmw probe's loop carry
    (an int32 start, a Python 0 returned) does not trace under them."""
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def bench():
    spec = importlib.util.spec_from_file_location(
        "bench_primitives_under_test",
        ROOT / "benchmarks" / "bench_primitives.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._INTERPRET = True
    mod._SMALL = True
    return mod


def _capture(bench, name):
    """(run, x0, consts) of one rate function, without timing anything."""
    kept = {}

    def keep(apply, x0, n_items, consts=(), reps=None):
        kept.update(run=apply, x0=x0, consts=tuple(consts))
        return 0.0

    real = bench._chain_rate
    bench._chain_rate = keep
    try:
        getattr(bench, name)()
    finally:
        bench._chain_rate = real
    return kept["run"], kept["x0"], kept["consts"]


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


# -- K6 gather_loop -------------------------------------------------------------

def _gather_step(idx, table, block_q):
    out = primitives.gather_loop(_t(idx), _t(table), block_q)
    n_blocks = idx.shape[0] // block_q
    i = _t(idx)
    return ((i + out[i % n_blocks]) % table.shape[0]).numpy()


def _offset_slice(a, offset):
    """A tensor equal to ``a`` that starts ``offset`` int32 into a larger
    one: contiguous, its base 4 * offset bytes off the allocation's."""
    base = torch.full((a.shape[0] + offset + 5,), -7, dtype=torch.int32)
    base[offset:offset + a.shape[0]] = _t(a)
    view = base[offset:offset + a.shape[0]]
    assert view.is_contiguous()
    if a.shape[0]:  # an empty tensor has no base
        assert view.data_ptr() == base.data_ptr() + 4 * offset
    return view


def _half_one_value(idx, value):
    out = idx.copy()
    out[::2] = value
    return out


@pytest.mark.parametrize("inputs", ["seeded", "planted", "skewed", "offset"])
def test_gather_loop_matches_pallas(bench, inputs):
    run, idx, (table,) = _capture(bench, "k_pallas_gather_loop")
    idx, table = np.asarray(idx), np.asarray(table)
    block_q = 1 << 10  # the benchmark's small block
    if inputs == "skewed":
        idx = _half_one_value(idx, table.shape[0] // 3)
    if inputs == "offset":
        want = np.asarray(run(idx, table))
        out = primitives.gather_loop(_offset_slice(idx, 3), _t(table),
                                     block_q)
        i = _t(idx)
        got = (i + out[i % (idx.shape[0] // block_q)]) % table.shape[0]
        assert np.array_equal(got.numpy(), want)
        return
    if inputs == "planted":
        rng = np.random.default_rng(5)
        # values near 2^30: a block of 1024 sums past 2^31 and wraps
        table = rng.integers((1 << 30) - 1000, 1 << 30, table.shape
                             ).astype(np.int32)
        idx = np.where(rng.random(idx.shape) < 0.9, 7,
                       rng.integers(0, table.shape[0], idx.shape)
                       ).astype(np.int32)
        assert table[idx, 0].astype(np.int64).reshape(-1, block_q).sum(
            1).max() >= 1 << 31
    want = np.asarray(run(idx, table))
    assert np.array_equal(_gather_step(idx, table, block_q), want)


def _gather_oracle(idx, table, block_q):
    out = []
    for blk in idx.reshape(-1, block_q):
        acc = 0
        for j in blk.tolist():
            if 0 <= j < table.shape[0]:
                acc = (acc + int(table[j, 0])) & 0xFFFFFFFF
        out.append(acc - (1 << 32) if acc >= 1 << 31 else acc)
    return np.array(out, dtype=np.int32)


def test_gather_loop_plain_matches_numpy():
    rng = np.random.default_rng(1)
    table = rng.integers(-(1 << 31), 1 << 31, (300, 3)).astype(np.int32)
    idx = rng.integers(-20, 320, 2048).astype(np.int32)  # some outside
    got = primitives.gather_loop_plain(_t(idx), _t(table), 256)
    assert got.dtype == torch.int32 and got.shape == (8,)
    assert np.array_equal(got.numpy(), _gather_oracle(idx, table, 256))


@pytest.mark.parametrize("n_blocks,block_q,offset", [
    (7, 1021, 1), (5, 3, 3), (9, 1, 0), (2, 8190, 2), (3, 4, 1), (1, 4099, 0)])
def test_gather_loop_takes_ragged_blocks_and_offset_slices(n_blocks, block_q,
                                                           offset):
    """Blocks that are no whole 16-byte vectors, from a base that is not
    16-byte aligned: nothing is refused, and the sums equal numpy's."""
    rng = np.random.default_rng(block_q)
    table = rng.integers(-(1 << 31), 1 << 31, (300, 3)).astype(np.int32)
    idx = rng.integers(-20, 320, n_blocks * block_q).astype(np.int32)
    got = primitives.gather_loop(_offset_slice(idx, offset), _t(table),
                                 block_q)
    assert got.shape == (n_blocks,)
    assert np.array_equal(got.numpy(), _gather_oracle(idx, table, block_q))


# -- K7 rmw_loop ------------------------------------------------------------------

def _rmw_step(idx, n_c):
    counts = primitives.rmw_loop(_t(idx), n_c, primitives.PROBE_COLS)
    assert not counts[:, 1:].any()
    i = _t(idx)
    return ((i + counts[i % n_c, 0]) % n_c).numpy()


@pytest.mark.parametrize("inputs", ["seeded", "planted", "skewed", "offset",
                                    "twice"])
def test_rmw_loop_matches_pallas(bench, inputs):
    run, idx, _ = _capture(bench, "k_pallas_rmw_loop")
    idx = np.asarray(idx)
    n_c = primitives.PROBE_ROWS
    if inputs == "skewed":
        idx = _half_one_value(idx, n_c // 3)
    if inputs == "offset":
        counts = primitives.rmw_loop(_offset_slice(idx, 1), n_c,
                                     primitives.PROBE_COLS)
        i = _t(idx)
        got = ((i + counts[i % n_c, 0]) % n_c).numpy()
        assert np.array_equal(got, np.asarray(run(idx)))
        return
    if inputs == "twice":
        # another input in between: the second table owes it nothing
        first = primitives.rmw_loop(_t(idx), n_c, primitives.PROBE_COLS)
        primitives.rmw_loop(_t(_half_one_value(idx, 5)), n_c,
                            primitives.PROBE_COLS)
        again = primitives.rmw_loop(_t(idx), n_c, primitives.PROBE_COLS)
        assert torch.equal(first, again)
    if inputs == "planted":
        rng = np.random.default_rng(6)
        idx = np.where(rng.random(idx.shape) < 0.8, n_c - 1,
                       rng.integers(0, 3, idx.shape)).astype(np.int32)
    want = np.asarray(run(idx))
    assert np.array_equal(_rmw_step(idx, n_c), want)


def test_rmw_loop_plain_matches_numpy():
    rng = np.random.default_rng(2)
    idx = rng.integers(-5, 70, 5000).astype(np.int32)
    got = primitives.rmw_loop_plain(_t(idx), 64, 3).numpy()
    want = np.zeros((64, 3), np.int32)
    for j in idx.tolist():
        if 0 <= j < 64:
            want[j, 0] += 1
    assert got.dtype == np.int32 and np.array_equal(got, want)


@pytest.mark.parametrize("n_q,n_c,cols,offset", [
    (5003, 64, 3, 1), (3, 300, 1, 2), (1, 1, 1, 0), (4097, 131, 2, 3),
    (1 << 12, 12288, 1, 0), (0, 8, 4, 0)])
def test_rmw_loop_takes_ragged_lengths_and_offset_slices(n_q, n_c, cols,
                                                         offset):
    """Lengths that are no whole 16-byte vectors, from a base that is not
    16-byte aligned, into tables of any shape: nothing is refused, and the
    counts equal numpy's."""
    rng = np.random.default_rng(n_q)
    idx = rng.integers(-5, n_c + 6, n_q).astype(np.int32)
    got = primitives.rmw_loop(_offset_slice(idx, offset), n_c, cols).numpy()
    want = np.zeros((n_c, cols), np.int32)
    np.add.at(want[:, 0], idx[(idx >= 0) & (idx < n_c)], 1)
    assert got.dtype == np.int32 and np.array_equal(got, want)


class _RecordingLibrary:
    """Stands in for the kernel library: keeps each call's arguments."""

    def __init__(self):
        self.calls = []

    def gki_gather_loop(self, *args):
        self.calls.append(("gather_loop", args))
        return 0

    def gki_rmw_loop(self, *args):
        self.calls.append(("rmw_loop", args))
        return 7  # a refused launch


def test_probe_launchers_size_their_outputs_and_scratch(monkeypatch):
    """What the launchers hand to the kernels, on CPU tensors with the CUDA
    calls stood in for: K6 gets a scratch of the table's rows in whole
    16-byte vectors, K7 an output it need not zero and a scratch row per
    thread block (one an SM); an empty batch launches nothing; a launch
    that the card refuses raises."""
    import contextlib

    from graph_kmer_index_tpu_torch.ops import _kernels

    monkeypatch.setattr(_kernels, "device_guard",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(_kernels, "stream_handle", lambda device: 11)
    monkeypatch.setattr(primitives, "_sm_count", lambda device: 6)
    lib = _RecordingLibrary()
    idx = torch.zeros(2048, dtype=torch.int32)
    table = torch.zeros((301, 3), dtype=torch.int32)
    before = dict(_kernels.launch_counts)
    monkeypatch.setattr(_kernels, "launch_counts", dict(before))
    out = primitives.launch_gather_loop(lib, idx, table, 512)
    assert out.shape == (4,) and out.dtype == torch.int32
    (name, args), = lib.calls
    assert name == "gather_loop"
    assert args[:2] == (idx.data_ptr(), table.data_ptr())
    assert args[2:7] == (2048, 301, 3, 512, out.data_ptr())
    assert args[8] == 11 and args[7] not in (0, out.data_ptr())
    with pytest.raises(RuntimeError, match="rmw_loop launch failed: CUDA "
                       "error 7"):
        primitives.launch_rmw_loop(lib, idx, 64, 5)
    name, args = lib.calls[-1]
    assert name == "rmw_loop" and args[:4] == (idx.data_ptr(), 2048, 64, 5)
    assert args[6:] == (6, 11) and args[4] != args[5]
    empty = idx[:0]
    assert primitives.launch_gather_loop(lib, empty, table, 512).shape == (0,)
    counts = primitives.launch_rmw_loop(lib, empty, 64, 5)
    assert counts.shape == (64, 5) and not counts.any()
    assert len(lib.calls) == 2
    # one launch counted; the refused one and the empty ones are not
    after = _kernels.launch_counts
    assert after["gather_loop"] == before["gather_loop"] + 1
    assert after["rmw_loop"] == before["rmw_loop"]


# -- K8 bcast_cmp -----------------------------------------------------------------

def _planted_cmp(qlo, qhi, tlo, thi, tnode, seed):
    """Repeated table keys (with other nodes) and queries planted on table
    keys, so that counts above 1 and the first-match rule are exercised."""
    rng = np.random.default_rng(seed)
    tlo, thi, tnode = tlo.copy(), thi.copy(), tnode.copy()
    n_t = tlo.shape[0]
    for a, b in ((3, 20), (3, n_t - 1), (7, 8)):
        tlo[b], thi[b] = tlo[a], thi[a]
    tlo[11] = tlo[12]  # same lo, other hi: no match
    qlo, qhi = qlo.copy().reshape(-1), qhi.copy().reshape(-1)
    at = rng.choice(qlo.shape[0], qlo.shape[0] // 4, replace=False)
    pick = rng.integers(0, n_t, at.shape[0])
    pick[:4] = (3, 7, 11, 12)
    qlo[at], qhi[at] = tlo[pick], thi[pick]
    return qlo.reshape(-1, 128), qhi.reshape(-1, 128), tlo, thi, tnode


def _cmp_oracle(qlo, qhi, tlo, thi, tnode):
    node = np.zeros(qlo.size, np.int32)
    cnt = np.zeros(qlo.size, np.int32)
    for i, (a, b) in enumerate(zip(qlo.reshape(-1).tolist(),
                                   qhi.reshape(-1).tolist())):
        hits = np.nonzero((tlo == a) & (thi == b))[0]
        cnt[i] = len(hits)
        node[i] = tnode[hits[0]] if len(hits) else 0
    return node.reshape(qlo.shape), cnt.reshape(qlo.shape)


@pytest.mark.parametrize("inputs", ["seeded", "planted"])
def test_bcast_cmp_matches_pallas(bench, inputs):
    run, qlo, consts = _capture(bench, "k_pallas_bcast_cmp")
    arrays = [np.asarray(a) for a in (qlo, *consts)]
    if inputs == "planted":
        arrays = list(_planted_cmp(*arrays, seed=7))
    qlo, qhi, tlo, thi, tnode = arrays
    want = np.asarray(run(qlo, qhi, tlo, thi, tnode))
    node, cnt = primitives.bcast_cmp(*map(_t, arrays))
    if inputs == "planted":
        assert cnt.max() == 3 and (cnt == 2).any()
    assert np.array_equal((_t(qlo) ^ node ^ cnt).numpy(), want)
    onode, ocnt = _cmp_oracle(qlo, qhi, tlo, thi, tnode)
    assert np.array_equal(node.numpy(), onode)
    assert np.array_equal(cnt.numpy(), ocnt)


def test_bcast_cmp_plain_chunks_match_numpy(monkeypatch):
    rng = np.random.default_rng(3)
    qlo = rng.integers(0, 4, (6, 128)).astype(np.int32)
    qhi = rng.integers(0, 2, (6, 128)).astype(np.int32)
    tlo = rng.integers(0, 4, 40).astype(np.int32)
    thi = rng.integers(0, 2, 40).astype(np.int32)
    tnode = rng.integers(1, 1 << 20, 40).astype(np.int32)
    monkeypatch.setattr(primitives, "_CMP_CHUNK", 100)  # ragged chunks
    node, cnt = primitives.bcast_cmp_plain(
        *map(_t, (qlo, qhi, tlo, thi, tnode)))
    onode, ocnt = _cmp_oracle(qlo, qhi, tlo, thi, tnode)
    assert np.array_equal(node.numpy(), onode)
    assert np.array_equal(cnt.numpy(), ocnt)
    empty = torch.zeros(0, dtype=torch.int32)
    node, cnt = primitives.bcast_cmp_plain(_t(qlo), _t(qhi), empty, empty,
                                           empty)
    assert not node.any() and not cnt.any()


# -- the wrappers' refusals -------------------------------------------------------

def test_probe_wrappers_refuse_what_the_kernels_do_not_take():
    idx = torch.zeros(2048, dtype=torch.int32)
    table = torch.zeros((64, 4), dtype=torch.int32)
    q = torch.zeros((4, 128), dtype=torch.int32)
    t = torch.zeros(16, dtype=torch.int32)
    # dtype
    with pytest.raises(TypeError):
        primitives.gather_loop(idx.long(), table, 1024)
    with pytest.raises(TypeError):
        primitives.rmw_loop(idx.long(), 64, 4)
    with pytest.raises(TypeError):
        primitives.bcast_cmp(q, q, t, t, t.long())
    # rank
    with pytest.raises(ValueError, match="dims"):
        primitives.gather_loop(idx.view(2, -1), table, 1024)
    with pytest.raises(ValueError, match="dims"):
        primitives.gather_loop(idx, table.flatten(), 1024)
    with pytest.raises(ValueError, match="dims"):
        primitives.rmw_loop(idx.view(2, -1), 64, 4)
    with pytest.raises(ValueError, match="dims"):
        primitives.bcast_cmp(q.flatten(), q.flatten(), t, t, t)
    # n_q % block_q, shapes
    with pytest.raises(ValueError, match="does not divide"):
        primitives.gather_loop(idx, table, 1000)
    with pytest.raises(ValueError, match="does not divide"):
        primitives.gather_loop(idx, table, 0)
    with pytest.raises(ValueError, match="qhi"):
        primitives.bcast_cmp(q, q[:2], t, t, t)
    with pytest.raises(ValueError, match="one length"):
        primitives.bcast_cmp(q, q, t, t[:3], t)
    with pytest.raises(ValueError, match="at least"):
        primitives.rmw_loop(idx, 0, 4)
    # tables that do not fit the shared memory the kernels stage them in
    big = torch.zeros((primitives.SHARED_BYTES // 4 + 1, 1),
                      dtype=torch.int32)
    with pytest.raises(ValueError, match="shared memory"):
        primitives.gather_loop(idx, big, 1024)
    with pytest.raises(ValueError, match="shared memory"):
        primitives.rmw_loop(idx, primitives.SHARED_BYTES // 4 + 1, 1)
    wide = torch.zeros(primitives.SHARED_BYTES // 12 + 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="shared memory"):
        primitives.bcast_cmp(q, q, wide, wide, wide)
    # device: a tensor on neither the CPU nor a CUDA device gets no twin,
    # and every input must lie on the first one's device
    with pytest.raises(ValueError, match="CUDA"):
        primitives.gather_loop(idx.to("meta"), table.to("meta"), 1024)
    with pytest.raises(ValueError, match="CUDA"):
        primitives.rmw_loop(idx.to("meta"), 64, 4)
    with pytest.raises(ValueError, match="CUDA"):
        primitives.bcast_cmp(*(x.to("meta") for x in (q, q, t, t, t)))
    with pytest.raises(ValueError, match="must be on"):
        primitives.gather_loop(idx, table.to("meta"), 1024)
    with pytest.raises(ValueError, match="must be on"):
        primitives.bcast_cmp(q, q, t, t.to("meta"), t)


def test_probe_sizes_are_the_benchmarks():
    """The full sizes the chip run uses: K6/K7 2^22 indices in blocks of
    8192 into (4096, 128); K8 2^21 queries against 512 entries; every
    staged table fits the shared memory."""
    assert primitives.PROBE_QUERIES % primitives.PROBE_BLOCK == 0
    assert primitives.PROBE_ROWS * 4 <= primitives.SHARED_BYTES
    assert 3 * primitives.CMP_ENTRIES * 4 <= primitives.SHARED_BYTES
    assert primitives.CMP_QUERIES % (primitives.CMP_TILE_ROWS * 128) == 0
