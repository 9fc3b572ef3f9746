"""API-parity bridge for the reference's ``bionumpy_wrapper``
(bionumpy_wrapper.py:4-10): window hashing of a numeric sequence (the
port's copy of graph_kmer_index_tpu/bionumpy_wrapper.py).

The reference shells out to the external ``bionumpy`` package here; our
own sliding-window kernel produces the identical hashes (same ACTG
encoding, first-base-LSB convention), so this is just a named alias.
"""
from __future__ import annotations

import numpy as np

from .hashing import sliding_window_hashes


def bionumpy_hash(numeric_sequence, k: int) -> np.ndarray:
    """Hashes of all full k-windows of a 2-bit numeric sequence."""
    return sliding_window_hashes(
        np.asarray(numeric_sequence, dtype=np.uint64), k)
