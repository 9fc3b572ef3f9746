"""Device k-mer hashing: the port of graph_kmer_index_tpu/ops/encode.py.

Every public function of the JAX module has a counterpart here:

    JAX ops/encode.py                        this module
    encode_ascii                             encode_ascii
    sliding_hashes, sliding_hashes_u32,      sliding_hashes (K1)
      sliding_hashes_pallas
    combine_u32_pair                         combine_lanes
    sliding_p16_pallas, sliding_p8_pallas    sliding_p16, sliding_p8 (K3)
    p16_to_lanes, p8_to_lanes                p16_to_lanes, p8_to_lanes
    sliding_hashes_pallas_p16, _p8           sliding_hashes_p16, _p8
    revcomp_hashes                           revcomp_hashes
    read_tape_hashes                         read_tape_hashes

Hashes are int64: k <= 31 keeps every hash below 2^62, and torch has no
uint64 arithmetic. ``sliding_hashes`` is kernel K1 (csrc/sliding_hash.cu)
on a CUDA tensor and its plain twin on a CPU tensor; it serves the
contracts of the JAX package's sliding_hashes, sliding_hashes_u32 +
combine_u32_pair and sliding_hashes_pallas in one function.

``sliding_p16``/``sliding_p8`` are kernel K3 (csrc/sliding_pack.cu): the
packing of min(k, 16) or min(k, 8) bases per position, the stream that
the JAX package's P16/P8 hashing route writes instead of full hashes.
torch has no shifts on uint32/uint16, so the packings and the (lo, hi)
hash lanes are int32 (P16, lanes) and int16 (P8) tensors holding the JAX
package's uint bit patterns; ``.numpy().view(np.uint32)`` reads them back.
The lane derivation and ``combine_lanes`` are plain torch, as they are
XLA outside the Pallas kernel in the JAX package. The TPU tiling knobs
(``chunk``, ``rows_per_block``, ``interpret``) have no counterpart.
"""
from __future__ import annotations

import torch

from . import _kernels

# torch's >> on int64 is arithmetic: every right shift below is masked
# (or lands in a field the next mask clears) so the bits behave as uint64
_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F
_M8 = 0x00FF00FF00FF00FF
_M16 = 0x0000FFFF0000FFFF
_M32 = 0x00000000FFFFFFFF


def _check_k(k: int) -> None:
    if not 1 <= k <= 31:
        raise ValueError(f"k must be in 1..31, got {k}")


def encode_ascii(raw: torch.Tensor) -> torch.Tensor:
    """uint8 ASCII bytes -> int8 2-bit codes (a/A=0, c/C=1, g/G=2, t/T=3,
    anything else 0)."""
    x = raw.to(torch.int32) | 32  # lowercase
    return ((x == ord("c")) * 1 + (x == ord("g")) * 2
            + (x == ord("t")) * 3).to(torch.int8)


def sliding_hashes_plain(seq: torch.Tensor, k: int) -> torch.Tensor:
    """Plain twin of K1: ``out[i] = sum_{j<k} seq[i+j] << 2j`` for every
    position, windows past the end reading zeros."""
    _check_k(k)
    n = seq.shape[0]
    x = torch.cat([seq.to(torch.int64),
                   torch.zeros(k, dtype=torch.int64, device=seq.device)])
    out = torch.zeros(n, dtype=torch.int64, device=seq.device)
    for j in range(k):
        out |= x[j:j + n] << (2 * j)
    return out


def sliding_hashes(seq: torch.Tensor, k: int) -> torch.Tensor:
    """int64 hash of the window at EVERY position of a 2-bit int8 tape
    (the k-1 tail windows read zero padding; callers keep the complete
    ones). Kernel K1 on CUDA, the plain twin on CPU."""
    _check_k(k)
    if seq.device.type == "cpu":
        return sliding_hashes_plain(seq, k)
    _kernels.check_cuda_tensor(seq, "seq", torch.int8, 1)
    n = seq.shape[0]
    out = torch.empty(n, dtype=torch.int64, device=seq.device)
    if n == 0:
        return out
    lib = _kernels.library()
    with torch.cuda.device(seq.device):
        err = lib.gki_sliding_hash(seq.data_ptr(), out.data_ptr(), n, k,
                                   _kernels.stream_handle(seq.device))
    _kernels.check_launch("sliding_hash", err)
    _kernels.launch_counts["sliding_hash"] += 1
    return out


def revcomp_hashes(hashes: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement in hash space (XOR with the all-ones base mask,
    then a 2-bit-group bit reversal), on int64 with a mask after every
    arithmetic right shift."""
    _check_k(k)
    x = hashes ^ ((1 << (2 * k)) - 1)
    x = ((x >> 2) & _M2) | ((x & _M2) << 2)
    x = ((x >> 4) & _M4) | ((x & _M4) << 4)
    x = ((x >> 8) & _M8) | ((x & _M8) << 8)
    x = ((x >> 16) & _M16) | ((x & _M16) << 16)
    x = ((x >> 32) & _M32) | (x << 32)
    return (x >> (64 - 2 * k)) & ((1 << (2 * k)) - 1)


def read_tape_hashes(flat: torch.Tensor, starts: torch.Tensor,
                     lens: torch.Tensor, n_real: int, k: int):
    """Hashes of the windows that lie fully inside one read of a
    concatenated read tape, in read order, and their count.

    ``flat`` is the int8 2-bit tape of all reads back to back;
    ``starts``/``lens`` the per-read extents (rows with start = len(flat)
    and len 0 are padding). Windows at or past ``n_real`` are padding.
    The invalid mask comes from two n_reads-sized scatters plus a cumsum;
    out-of-range scatter targets are dropped explicitly. Returns
    (int64 hashes of length n_valid, n_valid)."""
    n = flat.shape[0]
    dev = flat.device
    hashes = sliding_hashes(flat, k)
    starts = starts.to(torch.int64)
    ends = starts + lens.to(torch.int64)
    inv_start = torch.maximum(starts, ends - (k - 1))
    d = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    for idx, step in ((inv_start, 1), (ends, -1)):
        idx = idx[(idx >= 0) & (idx <= n)]
        d.index_add_(0, idx, torch.full(idx.shape, step, dtype=torch.int32,
                                        device=dev))
    if 0 <= n_real <= n:
        d[n_real] += 1  # everything past the real tape end is padding
    invalid = torch.cumsum(d[:n], 0, dtype=torch.int32) > 0
    valid = hashes[~invalid]
    return valid, int(valid.shape[0])


# -- kernel K3 (P16 / P8 packing), its plain twin and the lane derivation ---

_PACK_DTYPES = {16: torch.int32, 8: torch.int16}


def _check_m_cap(m_cap: int) -> None:
    if m_cap not in _PACK_DTYPES:
        raise ValueError(f"m_cap must be 16 (P16) or 8 (P8), got {m_cap}")


def sliding_pack_plain(seq: torch.Tensor, k: int, m_cap: int) -> torch.Tensor:
    """Plain twin of K3: ``out[i] = sum_{t<m} seq[i+t] << 2t`` with
    ``m = min(k, m_cap)`` for every position, windows past the end reading
    zeros. m_cap 16: int32 holding the uint32 P16 bits; m_cap 8: int16
    holding the uint16 P8 bits (torch's << on them wraps like the uints)."""
    _check_k(k)
    _check_m_cap(m_cap)
    dtype, m, n = _PACK_DTYPES[m_cap], min(k, m_cap), seq.shape[0]
    x = torch.cat([seq.to(dtype), torch.zeros(m, dtype=dtype,
                                              device=seq.device)])
    out = torch.zeros(n, dtype=dtype, device=seq.device)
    for t in range(m):
        out |= x[t:t + n] << (2 * t)
    return out


def sliding_pack(seq: torch.Tensor, k: int, m_cap: int) -> torch.Tensor:
    """P_min(k, m_cap) at every position of a 2-bit int8 tape: kernel K3 on
    CUDA, the plain twin on CPU; same contract as
    :func:`sliding_pack_plain`."""
    _check_k(k)
    _check_m_cap(m_cap)
    if seq.device.type == "cpu":
        return sliding_pack_plain(seq, k, m_cap)
    _kernels.check_cuda_tensor(seq, "seq", torch.int8, 1)
    n = seq.shape[0]
    out = torch.empty(n, dtype=_PACK_DTYPES[m_cap], device=seq.device)
    if n == 0:
        return out
    lib = _kernels.library()
    with torch.cuda.device(seq.device):
        err = lib.gki_sliding_pack(seq.data_ptr(), out.data_ptr(), n,
                                   min(k, m_cap), m_cap // 4,
                                   _kernels.stream_handle(seq.device))
    name = f"sliding_pack_p{m_cap}"
    _kernels.check_launch(name, err)
    _kernels.launch_counts[name] += 1
    return out


def sliding_p16(seq: torch.Tensor, k: int) -> torch.Tensor:
    """P_min(k,16) at every position, as int32 holding the uint32 bits."""
    return sliding_pack(seq, k, 16)


def sliding_p8(seq: torch.Tensor, k: int) -> torch.Tensor:
    """P_min(k,8) at every position, as int16 holding the uint16 bits."""
    return sliding_pack(seq, k, 8)


def p16_to_lanes(p16: torch.Tensor, k: int):
    """(lo, hi) int32 hash lanes (uint32 bits) from the P16 stream:
    lo = P16[i], hi = P16[i+16] masked to k-16 bases."""
    _check_k(k)
    n = p16.shape[0]
    if k <= 16:
        return p16, torch.zeros(n, dtype=torch.int32, device=p16.device)
    ext = torch.cat([p16, torch.zeros(16, dtype=torch.int32,
                                      device=p16.device)])
    return p16, ext[16:16 + n] & ((1 << 2 * (k - 16)) - 1)


def p8_to_lanes(p8: torch.Tensor, k: int):
    """(lo, hi) int32 hash lanes (uint32 bits) from the P8 stream, equal to
    ``p16_to_lanes(sliding_p16(seq, k), k)``: lo = P8[i] | P8[i+8] << 16
    and hi = P8[i+16] | P8[i+24] << 16, each masked to the bases it
    holds."""
    _check_k(k)
    n = p8.shape[0]
    zeros = torch.zeros(n, dtype=torch.int32, device=p8.device)
    if k <= 8:
        return p8.to(torch.int32) & 0xFFFF, zeros
    ext = torch.cat([p8.to(torch.int32) & 0xFFFF,
                     torch.zeros(24, dtype=torch.int32, device=p8.device)])
    lo = ext[:n] | (ext[8:8 + n] << 16)
    if k < 16:
        # P16 packs only k bases when k < 16
        return lo & ((1 << 2 * k) - 1), zeros
    if k == 16:
        return lo, zeros
    hi = (ext[16:16 + n] | (ext[24:24 + n] << 16)) & ((1 << 2 * (k - 16)) - 1)
    return lo, hi


def combine_lanes(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(lo, hi) int32 lanes (uint32 bits) -> int64 hash lo | hi << 32, the
    bits of the JAX package's combine_u32_pair."""
    return (lo.to(torch.int64) & 0xFFFFFFFF) | (hi.to(torch.int64) << 32)


def sliding_hashes_p16(seq: torch.Tensor, k: int):
    """(lo, hi) hash lanes of every window through K3's P16 stream."""
    return p16_to_lanes(sliding_p16(seq, k), k)


def sliding_hashes_p8(seq: torch.Tensor, k: int):
    """(lo, hi) hash lanes of every window through K3's P8 stream."""
    return p8_to_lanes(sliding_p8(seq, k), k)
