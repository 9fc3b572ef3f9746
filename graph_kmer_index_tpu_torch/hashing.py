"""Encoding and k-mer hash primitives (layer L1): the port's copy of
graph_kmer_index_tpu/hashing.py, kept here because importing anything from
the JAX package imports jax.

Behavioral contract (bit-exact with the reference implementation's
kmer_hashing.py and its tests/test_kmer_hashing.py):

- 2-bit base encoding: a/A->0, c/C->1, g/G->2, t/T->3; n->0, m->0
  (reference flat_kmers.py:134-145).
- A k-mer's FIRST base is the least-significant 2-bit digit:
  ``hash = sum(base[i] * 4**i)`` (reference kmer_hashing.py:8-9,
  snp_kmer_finder.py:24-26).  Equivalently the hash is the k bases packed
  little-endian, 2 bits per base: ``hash = sum(base[i] << (2*i))``.
  This identity is what makes the device kernels pure shift/or bit-packing.
- All hashes are uint64; k <= 31 (62 bits), so each also fits the signed
  int64 that the device side uses.

Everything here is host-side numpy; the device-side (torch / CUDA)
equivalents live in :mod:`graph_kmer_index_tpu_torch.ops.encode`.
"""
from __future__ import annotations

import numpy as np

_U64 = np.uint64

# ASCII -> 2-bit lookup (256 entries). Unknown characters (incl. 'n', 'm')
# map to 0, matching reference flat_kmers.py:138-144.
ASCII_TO_2BIT = np.zeros(256, dtype=np.uint8)
for _chars, _code in (("aA", 0), ("cC", 1), ("gG", 2), ("tT", 3)):
    for _c in _chars:
        ASCII_TO_2BIT[ord(_c)] = _code
_2BIT_TO_ASCII = np.frombuffer(b"acgt", dtype=np.uint8)

# complement in 2-bit space: 0<->3, 1<->2 (reference kmer_hashing.py:40-49)
COMPLEMENT_LOOKUP = np.array([3, 2, 1, 0], dtype=np.uint64)


def power_array(k: int) -> np.ndarray:
    """``[4^(k-1), ..., 4^0]`` as uint64 (reference kmer_hashing.py:4-5)."""
    return np.power(_U64(4), np.arange(k - 1, -1, -1, dtype=np.int64).astype(_U64))


def reverse_power_array(k: int) -> np.ndarray:
    """``[4^0, ..., 4^(k-1)]`` as uint64 (reference kmer_hashing.py:8-9)."""
    return np.power(_U64(4), np.arange(k, dtype=np.int64).astype(_U64))


def letter_sequence_to_numeric(sequence) -> np.ndarray:
    """Vectorized char -> 2-bit encode; returns uint64 like the reference
    (flat_kmers.py:134-145). Accepts str, bytes or an array of single chars.
    """
    if isinstance(sequence, str):
        raw = np.frombuffer(sequence.encode("ascii"), dtype=np.uint8)
    elif isinstance(sequence, (bytes, bytearray)):
        raw = np.frombuffer(bytes(sequence), dtype=np.uint8)
    elif isinstance(sequence, np.ndarray) and sequence.dtype.kind in "US":
        raw = np.frombuffer(
            "".join(sequence.tolist()).encode("ascii"), dtype=np.uint8
        )
    else:
        # already numeric
        return np.asarray(sequence, dtype=_U64)
    return ASCII_TO_2BIT[raw].astype(_U64)


def numeric_to_letter_sequence(sequence) -> np.ndarray:
    """2-bit codes -> array of 'acgt' chars (reference flat_kmers.py:147-154)."""
    seq = np.asarray(sequence, dtype=np.int64)
    chars = _2BIT_TO_ASCII[seq]
    return chars.view("S1").astype("U1")


def update_hash(current_base, current_hash, first_base, k, only_add=False):
    """Scalar rolling-hash update rule (reference kmer_finder.py:15-34).

    Build-up phase — ``only_add`` is an int n (the 0-based position of
    the incoming base, fewer than k bases seen so far):
    ``hash' = hash + 4^n * base``. Window full (``only_add`` is False):
    drop ``first_base`` from the LSB end and push the new base at the
    MSB end, ``hash' = (hash - first_base) // 4 + base * 4^(k-1)``.
    Computed in Python ints: 4^31 overflows float64-safe arithmetic.
    """
    current_base = int(current_base)
    current_hash = int(current_hash)
    if not isinstance(only_add, bool):
        return current_hash + 4 ** int(only_add) * current_base
    return (current_hash - int(first_base)) // 4 + current_base * 4 ** (k - 1)


def kmer_to_hash_fast(kmer: np.ndarray, k: int) -> int:
    """dot(bases, 4^i) -> int (reference snp_kmer_finder.py:24-26)."""
    assert kmer.dtype == np.uint64
    return int(np.sum(kmer * reverse_power_array(k)))


def sequence_to_kmer_hash(sequence: str) -> int:
    """Hash a letter sequence (reference snp_kmer_finder.py:19-20)."""
    return kmer_to_hash_fast(letter_sequence_to_numeric(sequence), len(sequence))


def kmer_hash_to_sequence(hash_, k: int) -> str:
    """Decode a hash to an 'acgt' string (reference snp_kmer_finder.py:14-16)."""
    bases = kmer_hashes_to_bases(np.array([hash_], dtype=_U64), k)[0]
    return "".join(numeric_to_letter_sequence(bases).tolist())


def kmer_hashes_to_bases(hashes: np.ndarray, k: int) -> np.ndarray:
    """hash -> (n, k) base matrix, base[i] = digit of 4^i.

    The reference extracts MSB-first then reverses (kmer_hashing.py:53-65);
    here we extract little-endian directly via shifts (2 bits per base),
    which is the same result.
    """
    hashes = np.asarray(hashes, dtype=_U64)
    shifts = (np.arange(k, dtype=np.int64) * 2).astype(_U64)
    return (hashes[:, None] >> shifts[None, :]) & _U64(3)


def kmer_hashes_to_complement_bases(hashes: np.ndarray, k: int) -> np.ndarray:
    """Per-base complement (0<->3, 1<->2) (reference kmer_hashing.py:40-49)."""
    return COMPLEMENT_LOOKUP[kmer_hashes_to_bases(hashes, k)]


def kmer_hashes_to_complement_hashes(hashes: np.ndarray, k: int) -> np.ndarray:
    """Complement each base, keep order (reference kmer_hashing.py:31-36)."""
    assert k <= 31
    comp = kmer_hashes_to_complement_bases(hashes, k)
    return np.sum(comp * reverse_power_array(k), axis=1, dtype=_U64)


_M2 = _U64(0x3333333333333333)
_M4 = _U64(0x0F0F0F0F0F0F0F0F)


def kmer_hashes_to_reverse_complement_hash(hashes: np.ndarray, k: int) -> np.ndarray:
    """Reverse complement in hash space (reference kmer_hashing.py:24-28).

    Computed entirely in packed form — complement is XOR with the all-ones
    base mask (each 2-bit field b^3 == 3-b), reversal is a 2-bit-group
    bit-reversal (swap ladder + byteswap) followed by a shift — instead of
    the reference's decode-to-(n,k)-bases round trip. Identical results
    (pinned by the hashing round-trip tests)."""
    if not 1 <= k <= 31:
        raise ValueError(f"k must be in 1..31, got {k}")
    x = np.asarray(hashes, dtype=_U64) ^ _U64((1 << (2 * k)) - 1)
    x = ((x >> _U64(2)) & _M2) | ((x & _M2) << _U64(2))
    x = ((x >> _U64(4)) & _M4) | ((x & _M4) << _U64(4))
    x = x.byteswap()
    return x >> _U64(64 - 2 * k)


def kmer_hash_to_reverse_complement_hash(hash_, k: int) -> int:
    return int(kmer_hashes_to_reverse_complement_hash(np.array([hash_], dtype=_U64), k)[0])


def kmer_hashes_to_reverse_complement_hash_chunked(
    hashes: np.ndarray, k: int, chunk_size: int = 1000000
) -> np.ndarray:
    """Chunked variant for memory (reference kmer_hashing.py:16-22)."""
    out = [
        kmer_hashes_to_reverse_complement_hash(hashes[i : i + chunk_size], k)
        for i in range(0, len(hashes), chunk_size)
    ]
    if not out:
        return np.zeros(0, dtype=_U64)
    return np.concatenate(out)


def sliding_window_hashes(numeric_sequence: np.ndarray, k: int) -> np.ndarray:
    """Hashes of every k-window of a numeric sequence (host version).

    Equivalent to the reference's ``np.convolve(seq, power_array(k), 'valid')``
    (read_kmers.py:68-70, kmer_finder.py:350-352): convolution flips the
    kernel, yielding the first-base-LSB convention — but exact in uint64
    (float convolution would lose bits above 2^53) and O(n): the native
    C++ rolling hash when available, else a numpy log-doubling shift/or
    ladder (the strided-dot formulation collapses to ~0.1 Mbases/s on
    large inputs from its cache-hostile column reduce).
    The device version is :func:`.ops.encode.sliding_hashes` (kernel K1).
    """
    seq_in = np.asarray(numeric_sequence)
    n = len(seq_in) - k + 1
    if n <= 0:
        return np.zeros(0, dtype=_U64)

    if n >= 4096:  # ctypes call overhead not worth it below this
        from . import native
        # int8 view straight to C: converting an int8 tape to u64 and
        # back cost 2 full-size copies (~16 bytes/base) per call
        h = native.sliding_hashes(seq_in.astype(np.int8, copy=False), k)
        if h is not None:
            return h
    seq = seq_in.astype(_U64, copy=False)

    # numpy log-doubling ladder: P_{2s}[i] = P_s[i] | P_s[i+s] << 2s
    x = np.concatenate([seq, np.zeros(32, dtype=_U64)])
    levels = [x]
    span = 1
    while span < k:
        p = levels[-1]
        shifted = np.empty_like(p)
        shifted[:-span] = p[span:]
        shifted[-span:] = 0
        levels.append(p | (shifted << _U64(2 * span)))
        span *= 2
    acc = np.zeros_like(x)
    offset, remaining, lvl = 0, k, len(levels) - 1
    while remaining > 0:
        size = 1 << lvl
        if remaining >= size:
            part = levels[lvl]
            if offset:
                shifted = np.empty_like(part)
                shifted[:-offset] = part[offset:]
                shifted[-offset:] = 0
                acc = acc | (shifted << _U64(2 * offset))
            else:
                acc = acc | part
            offset += size
            remaining -= size
        lvl -= 1
    return acc[:n]
