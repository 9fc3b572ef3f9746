"""Port parity: graph_kmer_index_tpu_torch.ops.finalize (the device span
expansion; its tape hash is K1's plain twin on a CPU tensor) against the
JAX package's ops.finalize on spans that the JAX finder made. Exact
equality on all four columns."""
import jax  # noqa: F401  (same process set-up as the other port tests)
import numpy as np
import pytest
import torch

from graph_kmer_index_tpu import DenseKmerFinder, PositionId
from graph_kmer_index_tpu.finder import _dedup_span_nodes
from graph_kmer_index_tpu.ops import finalize as jax_finalize
from graph_kmer_index_tpu.utils.synthetic import random_snp_graph

from graph_kmer_index_tpu_torch.ops import _kernels, finalize

torch.set_num_threads(2)


def _spans(seed, k, n_bases=2500, n_variants=40, **filters):
    """The expansion's inputs for a random graph, from the JAX finder."""
    graph, _ = random_snp_graph(n_bases, n_variants, seed=seed,
                                indel_fraction=0.3)
    finder = DenseKmerFinder(graph, k=k)
    finder.find()
    nl, _, span_nodes, s_af = _dedup_span_nodes(
        finder._span_nodes_len.get_nparray(),
        finder._span_nodes.get_nparray(), graph.allele_frequencies,
        filters.get("only_save_one", False), filters.get("only_store_nodes"))
    return (finder._tape.get_nparray(),
            finder._span_n_windows.get_nparray(),
            finder._span_node.get_nparray(),
            finder._span_first_offset.get_nparray(), nl, span_nodes, s_af,
            PositionId.from_graph(graph)._start_ids, k)


def _assert_columns(got, want, n=None):
    """Port tensors against JAX arrays: hashes and ref offsets are the
    uint64 bits as int64."""
    dtypes = (torch.int64, torch.int32, torch.int64, torch.float32)
    views = (np.uint64, np.int32, np.uint64, np.float32)
    for g, w, dtype, view in zip(got, want, dtypes, views, strict=True):
        assert g.dtype == dtype
        w = np.asarray(w)[:n]
        assert w.dtype == view
        assert np.array_equal(g.numpy().view(view), w)


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 1001])
def test_pack_tape(n):
    rng = np.random.default_rng(n)
    tape = rng.integers(-1, 6, n).astype(np.int8)  # incl. out-of-contract
    got = finalize._pack_tape(tape)
    assert got.dtype == np.uint8
    assert np.array_equal(got, jax_finalize._pack_tape(tape))
    codes = finalize._unpack_tape(torch.from_numpy(got), n)
    want = np.where((tape < 0) | (tape > 3), 0, tape)
    assert codes.dtype == torch.int8 and np.array_equal(codes.numpy(), want)


@pytest.mark.parametrize("filters", [
    {}, {"only_save_one": True}, {"only_store_nodes": set(range(1, 80, 2))}],
    ids=["all_nodes", "save_one", "store_nodes"])
@pytest.mark.parametrize("seed,k", [(0, 5), (7, 12), (21, 31)])
def test_expand_spans_device_matches_jax(seed, k, filters):
    args = _spans(seed, k, **filters)
    want = jax_finalize.expand_spans_device(*args)
    got = finalize.expand_spans_device(*args, device="cpu")
    assert got[0].shape[0] > 1000 or filters
    _assert_columns(got, want)


def test_expand_is_the_internal_program_too():
    """_expand on uploaded tensors, as expand_spans_device calls it."""
    tape, nw, s_node, s_off, nl, span_nodes, s_af, start_ids, k = _spans(
        3, 9)
    nw64, nl64 = nw.astype(np.int64), np.asarray(nl, np.int64)
    got = finalize._expand(
        k, len(tape), int(nw64.sum()), int((nw64 * nl64).sum()),
        torch.from_numpy(finalize._pack_tape(tape)),
        torch.from_numpy(nw.astype(np.int32)),
        torch.from_numpy(s_node.astype(np.int32)),
        torch.from_numpy(s_off.astype(np.int32)),
        torch.from_numpy(nl64.astype(np.int32)),
        torch.from_numpy(span_nodes.astype(np.int32)),
        torch.from_numpy(s_af.astype(np.float32)),
        torch.from_numpy(np.asarray(start_ids, np.int64)))
    want = jax_finalize.expand_spans_device(tape, nw, s_node, s_off, nl,
                                            span_nodes, s_af, start_ids, k)
    _assert_columns(got, want)


def test_expand_empty():
    empty = np.zeros(0, np.int32)
    got = finalize.expand_spans_device(
        np.zeros(0, np.int8), empty, empty, empty, empty, empty,
        np.zeros(0), np.zeros(4, np.int64), 5, device="cpu")
    want = jax_finalize.expand_spans_device(
        np.zeros(0, np.int8), empty, empty, empty, empty, empty,
        np.zeros(0), np.zeros(4, np.int64), 5)
    _assert_columns(got, want)
    assert all(col.shape == (0,) for col in got)


@pytest.mark.parametrize("seed", [2, 9])
def test_padded_groups_assemble_to_the_jax_columns(seed):
    """Span groups expanded one by one and joined equal the JAX package's
    ladder-padded groups after its assemble, and one expansion of the
    whole."""
    k = 7
    tape, nw, s_node, s_off, nl, span_nodes, s_af, start_ids, _ = _spans(
        seed, k, n_bases=4000, n_variants=60)
    tlen = nw.astype(np.int64) + k - 1
    t_end, n_end = np.cumsum(tlen), np.cumsum(nl)
    cuts = [0, len(nw) // 5, len(nw) // 5 + 1, len(nw) // 2, len(nw)]
    groups, jax_groups = [], []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        t0 = int(t_end[lo - 1]) if lo else 0
        n0 = int(n_end[lo - 1]) if lo else 0
        part = (tape[t0:int(t_end[hi - 1])], nw[lo:hi], s_node[lo:hi],
                s_off[lo:hi], nl[lo:hi], span_nodes[n0:int(n_end[hi - 1])],
                s_af[lo:hi], start_ids, k)
        groups.append(finalize.expand_spans_device_padded(*part,
                                                          device="cpu"))
        jax_groups.append(jax_finalize.expand_spans_device_padded(*part))
        # the port's groups are exact-shaped: n_real is their length
        assert groups[-1][4] == groups[-1][0].shape[0] == jax_groups[-1][4]
        _assert_columns(groups[-1][:4], jax_groups[-1][:4], n=groups[-1][4])
    got = finalize.assemble_group_columns(groups)
    _assert_columns(got, jax_finalize.assemble_group_columns(jax_groups))
    whole = finalize.expand_spans_device(tape, nw, s_node, s_off, nl,
                                         span_nodes, s_af, start_ids, k,
                                         device="cpu")
    for a, b in zip(got, whole, strict=True):
        assert torch.equal(a, b)


def test_expand_hashes_the_tape_through_the_k1_wrapper(monkeypatch):
    """The tape's hash is ops.encode.sliding_hashes: K1 for a CUDA tensor,
    its plain twin (and no launch) for a CPU tensor."""
    calls = []
    real = finalize.sliding_hashes

    def spy(seq, k):
        calls.append((seq.dtype, seq.shape[0], k))
        return real(seq, k)

    monkeypatch.setattr(finalize, "sliding_hashes", spy)
    args = _spans(4, 6)
    before = dict(_kernels.launch_counts)
    finalize.expand_spans_device(*args, device="cpu")
    assert calls == [(torch.int8, len(args[0]), 6)]
    assert _kernels.launch_counts == before
    with pytest.raises(ValueError, match="explicit device"):
        finalize.expand_spans_device(*args, device=None)
