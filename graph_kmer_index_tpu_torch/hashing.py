"""Host-side (numpy) hash helpers that the read-mapping slice needs.

Re-written from ``graph_kmer_index_tpu/hashing.py`` rather than imported:
importing anything from the JAX package imports jax, which the machine
with the card does not have. The contract is the same: a/A=0, c/C=1,
g/G=2, t/T=3, every other byte 0; a k-mer's FIRST base is its least
significant 2-bit digit (``hash = sum(base[i] << 2i)``); k <= 31, so every
hash is < 2^62 and fits a signed int64.
"""
from __future__ import annotations

import numpy as np

ASCII_TO_2BIT = np.zeros(256, dtype=np.uint8)
for _chars, _code in (("aA", 0), ("cC", 1), ("gG", 2), ("tT", 3)):
    for _c in _chars:
        ASCII_TO_2BIT[ord(_c)] = _code


def letter_sequence_to_numeric(sequence) -> np.ndarray:
    """str/bytes -> uint8 2-bit codes."""
    if isinstance(sequence, str):
        sequence = sequence.encode("ascii")
    return ASCII_TO_2BIT[np.frombuffer(bytes(sequence), dtype=np.uint8)]


def sequence_to_kmer_hash(sequence) -> int:
    """Hash of one letter sequence (its length is k)."""
    codes = letter_sequence_to_numeric(sequence)
    return sum(int(c) << (2 * i) for i, c in enumerate(codes))


def sliding_window_hashes(numeric_sequence: np.ndarray, k: int) -> np.ndarray:
    """uint64 hashes of the ``len - k + 1`` complete windows of a 2-bit
    sequence (empty when the sequence is shorter than k)."""
    seq = np.asarray(numeric_sequence).astype(np.uint64)
    n = len(seq) - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.uint64)
    out = np.zeros(n, dtype=np.uint64)
    for j in range(k):
        out |= seq[j:j + n] << np.uint64(2 * j)
    return out


def kmer_hashes_to_reverse_complement_hash(hashes: np.ndarray,
                                           k: int) -> np.ndarray:
    """Reverse complement in hash space: complement is XOR with the
    all-ones base mask, reversal a 2-bit-group bit reversal."""
    if not 1 <= k <= 31:
        raise ValueError(f"k must be in 1..31, got {k}")
    x = np.asarray(hashes, dtype=np.uint64) ^ np.uint64((1 << (2 * k)) - 1)
    m2 = np.uint64(0x3333333333333333)
    m4 = np.uint64(0x0F0F0F0F0F0F0F0F)
    x = ((x >> np.uint64(2)) & m2) | ((x & m2) << np.uint64(2))
    x = ((x >> np.uint64(4)) & m4) | ((x & m4) << np.uint64(4))
    return x.byteswap() >> np.uint64(64 - 2 * k)
