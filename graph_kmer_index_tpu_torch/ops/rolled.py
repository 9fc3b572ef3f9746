"""The rolled form of a chunk of query hashes: how the staging ring
(``ops/host_buffers.py``) sends host hashes that roll one base from one
query to the next, as the k-mers of each read strand do.

A chunk goes to the card as one 2-bit digit a query (the new base) and,
for each query that does not roll from the one before it, an anchor: its
index, its whole hash and the direction of the run it starts (forward,
``h >> 2`` with the base on top, or reverse, ``h << 2`` with the base at
the bottom). Read k-mers of 150 bp reads carry one anchor a read strand,
so a chunk goes in about a 21st of its raw bytes.

:func:`encode` is the host's half (``csrc/host/rolled.cpp``, native, on the
process's threads): it probes the chunk's first queries for the digits a
hash (``w``, from the bit length of the largest) and the share of anchors,
and leaves a chunk in which more than one query in 16 of the probe does
not roll to the ring's plain copy (None). Every rolled query is checked
exactly, so any input comes back bit for bit. :func:`decode` is the card's
(``csrc/rolled_decode.cu``; :func:`decode_plain`, its plain twin, for a
CPU destination).

The form, in one buffer, each part 8-byte aligned (``Form`` gives the
byte offsets): the digits, ``uint64[ceil(n / 32)]`` with query i's digit
in bits ``2 (i % 32)`` of word ``i // 32``; the tile table,
``int32[ceil(n / TILE) + 1]``, the anchors before each tile of
:data:`TILE` queries and then all of them; the anchors in index order,
16 bytes each: the hash (``uint64``), the key (``int32``,
``index << 1 | reverse``) and 4 zero bytes.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _kernels

# queries a tile of the form: csrc/host/rolled.cpp and rolled_decode.cu
TILE = 2048


class Form(NamedTuple):
    """A chunk's rolled form: ``n`` queries of ``w`` digits, its
    ``n_anchors``, its ``nbytes``, and the byte offsets of its tile table
    and its anchors (the digits start at 0)."""

    n: int
    w: int
    n_anchors: int
    nbytes: int
    tiles: int
    anchors: int


def encode(src: torch.Tensor, out: torch.Tensor) -> Form | None:
    """The rolled form of ``src`` (1-D contiguous int64 on the CPU) written
    into ``out`` (1-D uint8 on the CPU, whose length is the room), on
    ``torch.get_num_threads()`` threads; None where the chunk goes as it
    is: the probe finds too few rolls, the anchors do not fit, or there is
    no native library."""
    from .. import native

    lib = native.get_lib()
    n = src.numel()
    if lib is None or n == 0:
        return None
    info = (ctypes.c_int64 * 4)()
    nbytes = lib.gki_rolled_encode(src.data_ptr(), n, out.data_ptr(),
                                   out.numel(), torch.get_num_threads(),
                                   info)
    if nbytes < 0:
        return None
    return Form(n, info[0], info[1], nbytes, info[2], info[3])


def _anchors(form: Form, rolled: torch.Tensor):
    """(keys as int64, hashes) of the form's anchors."""
    records = rolled[form.anchors:form.anchors + 16 * form.n_anchors]
    return (records.view(torch.int32).view(-1, 4)[:, 2].to(torch.int64),
            records.view(torch.int64).view(-1, 2)[:, 0])


def _right(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``x >> s`` with zeros shifted in (uint64 bits in int64), 0 <= s < 64."""
    return (x >> s) & ~(torch.full_like(x, -1) << (64 - s))


def decode_plain(form: Form, rolled: torch.Tensor,
                 out: torch.Tensor) -> None:
    """Plain twin of the decode kernel: the queries of ``form`` from the
    uint8 ``rolled`` into ``out`` (``form.n`` int64), by the same closed
    form, one digit of the window a pass."""
    n, w = form.n, form.w
    keys, values = _anchors(form, rolled)
    words = rolled[:8 * (-(-n // 32))].view(torch.int64)
    i = torch.arange(n, dtype=torch.int64, device=out.device)
    digits = (words[i >> 5] >> (2 * (i & 31))) & 3
    a = torch.searchsorted(keys >> 1, i, right=True) - 1
    t = i - (keys[a] >> 1)
    reverse = (keys[a] & 1).bool()
    anchor = values[a]
    h = torch.zeros(n, dtype=torch.int64, device=out.device)
    for j in range(min(w, n)):
        # the digit of query i - j, where it belongs to i's run
        d = torch.cat([torch.zeros(j, dtype=torch.int64, device=out.device),
                       digits[:n - j]])
        d = torch.where(t > j, d, torch.zeros_like(d))
        h |= torch.where(reverse, d << (2 * j), d << (2 * w - 2 - 2 * j))
    kept = (2 * t).clamp(max=63)
    mask = -1 if w == 32 else (1 << (2 * w)) - 1
    near = torch.where(reverse, (anchor << kept) & mask,
                       _right(anchor, kept))
    h |= torch.where(t < w, near, torch.zeros_like(near))
    out.copy_(torch.where(t == 0, anchor, h))


def decode(form: Form, rolled: torch.Tensor, out: torch.Tensor) -> None:
    """The queries of ``form`` from ``rolled`` (its bytes, uint8, on
    ``out``'s device) into ``out`` (``form.n`` int64, contiguous): the
    decode kernel on the device's current stream on CUDA, the plain twin
    on the CPU."""
    if out.device.type == "cpu":
        decode_plain(form, rolled, out)
        return
    _kernels.check_cuda_tensor(rolled, "rolled", torch.uint8, 1)
    _kernels.check_cuda_tensor(out, "out", torch.int64, 1)
    if rolled.numel() < form.nbytes or out.numel() != form.n:
        raise ValueError("the form does not fit the buffers")
    lib = _kernels.library()
    with _kernels.device_guard(out.device):
        err = lib.gki_rolled_decode(rolled.data_ptr(), form.n, form.w,
                                    form.tiles, form.anchors,
                                    out.data_ptr(),
                                    _kernels.stream_handle(out.device))
    _kernels.check_launch("rolled_decode", err)
    _kernels.launch_counts["rolled_decode"] += 1
