"""Device k-mer hashing: the port of graph_kmer_index_tpu/ops/encode.py.

Hashes are int64: k <= 31 keeps every hash below 2^62, and torch has no
uint64 arithmetic. ``sliding_hashes`` is kernel K1 (csrc/sliding_hash.cu)
on a CUDA tensor and its plain twin on a CPU tensor; it serves the
contracts of the JAX package's sliding_hashes, sliding_hashes_u32 +
combine_u32_pair and sliding_hashes_pallas in one function.
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
