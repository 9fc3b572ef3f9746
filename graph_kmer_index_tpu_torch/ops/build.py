"""Device-side index construction: the port of
graph_kmer_index_tpu/ops/build.py under its names.

The collision-free index build is a stable sort by bucket followed by
segment boundary extraction and scatters, and the frequency computation
(distinct ref offsets per k-mer) two more sorted-segment passes. Both are
plain torch on the tensors' device and live beside the index
(``models.kmer_index.build_modulo_layout``,
``frequencies_by_distinct_ref_offsets``); this module gives them the JAX
module's entry points, which take numpy arrays or tensors.

The JAX module sorts (hi, lo) uint32 lanes and needs a second, wider key
for ref offsets from 2^32 on; int64 sorts have one branch for every
offset below 2^63.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models.kmer_index import (build_modulo_layout,
                                 frequencies_by_distinct_ref_offsets)
from .lookup import as_device_tensor


def build_modulo_layout_device(hashes, modulo: int, row_arrays, *, device):
    """Sort rows by ``hashes % modulo`` on ``device`` and fill the bucket
    tables. ``hashes`` are the k-mers (numpy uint64 or an int64 tensor),
    ``row_arrays`` the columns to reorder with them. Returns (starts
    int32[modulo], sizes int32[modulo], [row tensors sorted by bucket],
    permutation), all on ``device``: the modulo-sized tables stay where
    the lookup reads them."""
    dev = resolve_device(device)
    kmers = as_device_tensor(hashes, torch.int64, dev)
    rows = [as_device_tensor(a, None, dev) for a in row_arrays]
    return build_modulo_layout(kmers % int(modulo), int(modulo), rows)


def frequencies_device(kmers_sorted, ref_offsets_sorted, *,
                       device) -> np.ndarray:
    """Per-row k-mer frequencies (distinct ref offsets per k-mer) computed
    on ``device``. Rows in any order; the output is aligned to the input
    and is uint16, as in the JAX package."""
    dev = resolve_device(device)
    freqs = frequencies_by_distinct_ref_offsets(
        as_device_tensor(kmers_sorted, torch.int64, dev),
        as_device_tensor(ref_offsets_sorted, torch.int64, dev))
    return freqs.cpu().numpy().astype(np.uint16)
