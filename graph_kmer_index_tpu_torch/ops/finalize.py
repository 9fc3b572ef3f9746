"""Device-resident span finalize: the port of
graph_kmer_index_tpu/ops/finalize.py. It expands the finder's compact span
representation into FlatKmers row columns on an explicit torch device.

The DenseKmerFinder control plane emits O(spans) descriptors plus a
1 byte/base tape (finder.py); the expanded rows are about 24 bytes/row and
about 1.3 rows/base. Hashing the tape and expanding the rows on the device
means the host-to-device upload is the tape plus the span-level arrays,
and the rows feed ``KmerIndex.from_flat_kmers`` without leaving the device.

The tape crosses the link 2-bit-packed (:func:`_pack_tape`: 4 bases a
byte; tape values are raw graph sequence digits 0..3), and the two
exclusive-start columns (span tape starts, span node-list starts) are
derived on the device as prefix sums of the lengths: span tape slices are
emitted consecutively (each exactly ``n_windows + k - 1`` bases), so the
starts are pure prefix sums.

Where the JAX module is one jitted program with static totals, this one is
plain torch around kernel K1 (``ops.encode.sliding_hashes``, the tape's
hash): ``repeat_interleave`` with ``output_size=`` (so that no step waits
for a size), prefix sums and gathers. Indices are int64, torch's index
type, so there is no 2^31-row limit per expansion. The JAX module pads
streamed groups to a ladder of shapes to bound its compile keys; here a
group is exact-shaped and groups are joined by ``torch.cat``, with the
same names and results. Hashes and ref offsets are int64 (the JAX
package's uint64 bits: every value is < 2^63), nodes int32, allele
frequencies float32, all in finder emission order.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .encode import sliding_hashes


def _pack_tape(tape: np.ndarray) -> np.ndarray:
    """Host-side 2-bit packing, base j of byte i at bits [2j, 2j+2).

    Negative values clamp to base 0 BEFORE packing, the same
    ``np.maximum(tape, 0)`` the host finalize paths apply (finder.py
    _finalize), so a foreign graph with a negative sentinel hashes
    identically on both paths. Codes > 3 violate the 2-bit sequence
    contract everywhere and pack to base 0 here."""
    tape = np.maximum(np.asarray(tape, dtype=np.int16), 0)
    tape = np.where(tape > 3, 0, tape).astype(np.uint8)
    pad = (-len(tape)) % 4
    if pad:
        tape = np.concatenate([tape, np.zeros(pad, np.uint8)])
    q = tape.reshape(-1, 4)
    return (q[:, 0] | (q[:, 1] << 2) | (q[:, 2] << 4)
            | (q[:, 3] << 6)).astype(np.uint8)


def _unpack_tape(packed: torch.Tensor, total_tape: int) -> torch.Tensor:
    """uint8 packed tape -> the first ``total_tape`` int8 2-bit codes."""
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8,
                          device=packed.device)
    codes = (packed[:, None] >> shifts) & 3
    return codes.reshape(-1)[:total_tape].to(torch.int8)


def _starts(lengths: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sums."""
    return torch.cumsum(lengths, 0) - lengths


def _expand(k, total_tape, total_windows, total_rows, tape_packed, nw,
            s_node, s_off, nl, span_nodes, s_af, start_ids):
    """Tape unpack, sliding-window hash (K1), then window- and row-index
    expansion, all on the tensors' device from the span-level inputs:
    nothing O(windows) or O(rows) crosses the host link, and the totals
    come from the host so that no step synchronises."""
    dev = nw.device
    n_spans = nw.shape[0]
    hashes = sliding_hashes(_unpack_tape(tape_packed, total_tape), k)
    nw = nw.to(torch.int64)
    nl = nl.to(torch.int64)
    # spans own consecutive tape slices of exactly nw + k - 1 bases and
    # consecutive node-list slices of nl
    ts = _starts(nw + (k - 1))
    ns = _starts(nl)
    cum_nw = _starts(nw)
    win_span = torch.repeat_interleave(
        torch.arange(n_spans, device=dev), nw, output_size=total_windows)
    win_local = torch.arange(total_windows, device=dev) - cum_nw[win_span]
    win_kmer = hashes[ts[win_span] + win_local]
    del hashes
    rpw = nl[win_span]                     # rows per window
    cum_rpw = _starts(rpw)
    row_win = torch.repeat_interleave(
        torch.arange(total_windows, device=dev), rpw, output_size=total_rows)
    row_local = torch.arange(total_rows, device=dev) - cum_rpw[row_win]
    del rpw, cum_rpw
    row_span = win_span[row_win]
    kmers = win_kmer[row_win]
    nodes = span_nodes[ns[row_span] + row_local]
    del row_local
    # FlatKmers v="1" ref offsets: PositionId.get(start_nodes,
    # start_offsets) as a device gather
    ref_offsets = (start_ids[s_node.to(torch.int64)][row_span]
                   + s_off.to(torch.int64)[row_span] + win_local[row_win])
    af = s_af[row_span]
    return kmers, nodes, ref_offsets, af


def _upload(a, dtype, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)


def expand_spans_device(tape, nw, s_node, s_off, nl, span_nodes,
                        s_af, position_start_ids, k, *, device):
    """Expand merged span arrays to FlatKmers columns on ``device``.

    Inputs are host numpy (span-level, small; plus the int8 tape, which
    is 2-bit-packed before crossing the link); returns (hashes int64,
    nodes int32, ref_offsets int64, allele_freqs float32) as tensors on
    ``device`` in finder emission order. Span tape slices must be
    consecutive in ``tape`` (each exactly ``nw[i] + k - 1`` bases) and
    node lists consecutive in ``span_nodes`` (each ``nl[i]`` entries):
    the emission invariant of finder._emit_span and the native walker.
    """
    dev = resolve_device(device)
    nw = np.asarray(nw, dtype=np.int64)
    nl = np.asarray(nl, dtype=np.int64)
    total_windows = int(nw.sum())
    total_rows = int((nw * nl).sum())
    if total_rows == 0 or total_windows == 0:
        return (torch.zeros(0, dtype=torch.int64, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros(0, dtype=torch.int64, device=dev),
                torch.zeros(0, dtype=torch.float32, device=dev))
    return _expand(
        int(k), int(len(tape)), total_windows, total_rows,
        _upload(_pack_tape(tape), np.uint8, dev),
        _upload(nw, np.int32, dev), _upload(s_node, np.int32, dev),
        _upload(s_off, np.int32, dev), _upload(nl, np.int32, dev),
        _upload(span_nodes, np.int32, dev), _upload(s_af, np.float32, dev),
        _upload(position_start_ids, np.int64, dev))


def expand_spans_device_padded(tape, nw, s_node, s_off, nl, span_nodes,
                               s_af, position_start_ids, k, *, device):
    """:func:`expand_spans_device` for one STREAMED chunk group: returns
    (hashes, nodes, ref_offsets, af, n_real_rows). The JAX function pads
    its arrays to a ladder of shapes and marks the real prefix with
    ``n_real_rows``; here the columns are exact, so ``n_real_rows`` is
    their length, and :func:`assemble_group_columns` takes the groups
    either way."""
    out = expand_spans_device(tape, nw, s_node, s_off, nl, span_nodes,
                              s_af, position_start_ids, k, device=device)
    return (*out, int(out[0].shape[0]))


def assemble_group_columns(groups):
    """Concatenate streamed groups' valid prefixes in group order.

    ``groups``: list of (hashes, nodes, ref_offsets, af, n_real) from
    :func:`expand_spans_device_padded`. Returns the four exact-length
    device columns, identical to a single expansion over the concatenated
    spans."""
    return tuple(torch.cat([g[c][:g[4]] for g in groups])
                 for c in range(4))
