"""Port parity: the P16/P8 hashing route of graph_kmer_index_tpu_torch
(kernel K3's plain twin, the lane derivations and combine_lanes) against
the JAX package's sliding_p16_pallas/sliding_p8_pallas (Pallas in
interpret mode), p16_to_lanes/p8_to_lanes, combine_u32_pair and
sliding_hashes, on the CPU. Every comparison is exact: the port's int32 /
int16 tensors hold the JAX package's uint32 / uint16 bits."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_kmer_index_tpu.ops import encode as jax_encode
from graph_kmer_index_tpu_torch.ops import encode as torch_encode

torch.set_num_threads(2)

KS = (1, 5, 8, 9, 12, 15, 16, 17, 21, 31)
MODES = {  # m_cap: (port packing, JAX kernel, JAX lanes, port lanes, view)
    16: (torch_encode.sliding_p16, jax_encode.sliding_p16_pallas,
         jax_encode.p16_to_lanes, torch_encode.p16_to_lanes, np.uint32),
    8: (torch_encode.sliding_p8, jax_encode.sliding_p8_pallas,
        jax_encode.p8_to_lanes, torch_encode.p8_to_lanes, np.uint16),
}


def _lengths(k):
    return sorted({1, max(1, k - 1), 4099})


def _seq(k, n):
    return np.random.default_rng(1000 * k + n).integers(0, 4, n).astype(
        np.int8)


@pytest.mark.parametrize("m_cap", (16, 8))
@pytest.mark.parametrize("k", KS)
def test_sliding_pack_matches_pallas(k, m_cap):
    port_fn, jax_fn, _, _, view = MODES[m_cap]
    for n in _lengths(k):
        seq = _seq(k, n)
        port = port_fn(torch.from_numpy(seq), k)
        assert port.dtype == (torch.int32 if m_cap == 16 else torch.int16)
        want = np.asarray(jax_fn(jnp.asarray(seq), k, interpret=True))
        assert want.dtype == view
        assert np.array_equal(port.numpy().view(view), want), (k, n)


@pytest.mark.parametrize("m_cap", (16, 8))
@pytest.mark.parametrize("k", KS)
def test_lanes_and_hashes_match_jax(k, m_cap):
    _, jax_fn, jax_lanes, port_lanes, _ = MODES[m_cap]
    port_route = (torch_encode.sliding_hashes_p16 if m_cap == 16
                  else torch_encode.sliding_hashes_p8)
    for n in _lengths(k):
        seq = _seq(k, n)
        packed = np.asarray(jax_fn(jnp.asarray(seq), k, interpret=True))
        # the port's lanes of the JAX packing, against JAX's own lanes
        lo, hi = port_lanes(torch.from_numpy(packed.view(
            np.int32 if m_cap == 16 else np.int16).copy()), k)
        want_lo, want_hi = (np.asarray(x) for x in jax_lanes(
            jnp.asarray(packed), k))
        assert np.array_equal(lo.numpy().view(np.uint32), want_lo), (k, n)
        assert np.array_equal(hi.numpy().view(np.uint32), want_hi), (k, n)
        combined = torch_encode.combine_lanes(lo, hi).numpy().view(np.uint64)
        assert np.array_equal(combined, np.asarray(jax_encode.combine_u32_pair(
            jnp.asarray(want_lo), jnp.asarray(want_hi)))), (k, n)
        # the whole route from the tape, against the full-hash references
        route = torch_encode.combine_lanes(*port_route(
            torch.from_numpy(seq), k)).numpy().view(np.uint64)
        assert np.array_equal(route, np.asarray(jax_encode.sliding_hashes(
            jnp.asarray(seq), k))), (k, n)
        assert np.array_equal(route, torch_encode.sliding_hashes(
            torch.from_numpy(seq), k).numpy().view(np.uint64)), (k, n)


def test_combine_lanes_keeps_every_bit():
    rng = np.random.default_rng(7)
    lo = rng.integers(0, 1 << 32, 1000, dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(0, 1 << 32, 1000, dtype=np.uint64).astype(np.uint32)
    lo[:2], hi[:2] = [0, 0xFFFFFFFF], [0xFFFFFFFF, 0]
    port = torch_encode.combine_lanes(torch.from_numpy(lo.view(np.int32)),
                                      torch.from_numpy(hi.view(np.int32)))
    want = np.asarray(jax_encode.combine_u32_pair(jnp.asarray(lo),
                                                  jnp.asarray(hi)))
    assert np.array_equal(port.numpy().view(np.uint64), want)


@pytest.mark.parametrize("m_cap", (16, 8))
def test_sliding_pack_empty_and_bad_args(m_cap):
    empty = torch.zeros(0, dtype=torch.int8)
    out = torch_encode.sliding_pack(empty, 31, m_cap)
    assert out.shape == (0,)
    lo, hi = (torch_encode.sliding_hashes_p16 if m_cap == 16
              else torch_encode.sliding_hashes_p8)(empty, 31)
    assert lo.shape == hi.shape == (0,)
    assert torch_encode.combine_lanes(lo, hi).shape == (0,)
    seq = torch.zeros(4, dtype=torch.int8)
    for k in (0, 32):
        with pytest.raises(ValueError):
            torch_encode.sliding_pack(seq, k, m_cap)
        with pytest.raises(ValueError):
            torch_encode.sliding_pack_plain(seq, k, m_cap)
    with pytest.raises(ValueError, match="m_cap"):
        torch_encode.sliding_pack(seq, 5, 4)
    with pytest.raises(ValueError, match="CUDA"):  # no fallback off the CPU
        torch_encode.sliding_pack(seq.to("meta"), 5, m_cap)
