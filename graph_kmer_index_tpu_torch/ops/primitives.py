"""The port of the Pallas kernels of benchmarks/bench_primitives.py: the
device-memory bandwidth controls and the lookup's probes.

``stream_copy`` (kernel K4, csrc/stream.cu; ``k_pallas_stream_copy`` in
the JAX benchmarks) copies a float32 table: the bytes it moves per second,
read plus write, are the ceiling that a bandwidth-bound kernel such as K1
or K3 is judged against. ``stream_sum`` (K5; ``k_pallas_stream_sum``) is
its read-only sibling: one float32 sum per block of ``block_rows`` rows,
plus ``float(seed[0])``. Each runs its kernel on a CUDA tensor and its
plain twin on a CPU tensor, and raises on anything the kernel does not
take.

The probes measure the building blocks of a bucket-scan lookup (csrc/
probes.cu): ``gather_loop`` (K6; ``k_pallas_gather_loop``), one int32 sum
that wraps per block of ``block_q`` indices into column 0 of a table, a
dynamic gather; ``rmw_loop`` (K7; ``k_pallas_rmw_loop``), a zeroed
(n_c, cols) int32 table whose column 0 counts the indices, a
read-modify-write count; ``bcast_cmp`` (K8; ``k_pallas_bcast_cmp``), per
query (lo, hi) the number of matching table entries and the node of the
first match (else 0), a broadcast key compare. An index outside the
table counts nothing in K6 and K7. Each kernel stages its table in shared
memory, so a table must fit in SHARED_BYTES. K6 and K7 take indices of
any length and at any 4-byte offset (a slice of a tensor): what is no whole
16-byte vector they read as scalars.
"""
from __future__ import annotations

import functools

import torch

from . import _kernels
from .lookup import _i32_bits

# bench_primitives.py's sizes: (2^20, 128) float32 = 512 MiB in blocks of
# 4096 rows (256 block sums), about ten times the H100's 50 MB L2
STREAM_ROWS = 1 << 20
STREAM_COLS = 128
BLOCK_ROWS = 1 << 12
# the bytes K4 moves at a time (kTileBytes in csrc/stream.cu): a
# table of any other length ends in a shorter tile
COPY_TILE_BYTES = 1 << 15

# the probes' sizes in bench_primitives.py: 2^22 indices in blocks of 8192
# into a (4096, 128) int32 table (K6, K7); 2^21 queries in tiles of
# (256, 128) against 512 table entries (K8)
PROBE_ROWS = 1 << 12
PROBE_COLS = 128
PROBE_QUERIES = 1 << 22
PROBE_BLOCK = 1 << 13
CMP_QUERIES = 1 << 21
CMP_TILE_ROWS = 256
CMP_ENTRIES = 512
# the default dynamic shared memory of a block, which the probes' staged
# tables must fit
SHARED_BYTES = 48 * 1024
# queries per chunk of the (queries x entries) compare in bcast_cmp_plain
_CMP_CHUNK = 1 << 16


def _check_table(table: torch.Tensor) -> None:
    _kernels.check_tensor(table, "table", torch.float32, 2)
    if table.shape[1] % 4:
        raise ValueError(f"table rows must be whole 16-byte words, got "
                         f"{table.shape[1]} columns")


def _check_sum_args(table: torch.Tensor, seed: torch.Tensor,
                    block_rows: int) -> None:
    _check_table(table)
    _kernels.check_tensor(seed, "seed", torch.int32, 1)
    if seed.shape[0] < 1 or seed.device != table.device:
        raise ValueError("seed must hold at least one value, on the "
                         "table's device")
    if block_rows < 1 or table.shape[0] % block_rows:
        raise ValueError(f"block_rows {block_rows} does not divide the "
                         f"{table.shape[0]} rows")


def _check_aligned(t: torch.Tensor, name: str) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def stream_copy_plain(table: torch.Tensor) -> torch.Tensor:
    """Plain twin of K4: a device-to-device copy."""
    _check_table(table)
    return table.clone()


def stream_copy(table: torch.Tensor) -> torch.Tensor:
    """A copy of a contiguous 2-D float32 table of whole 16-byte rows, of
    any length (shorter than one tile of COPY_TILE_BYTES, or ending in a
    ragged one): kernel K4 on CUDA, the plain twin on CPU."""
    if table.device.type == "cpu":
        return stream_copy_plain(table)
    _kernels.check_cuda_tensor(table, "table", torch.float32, 2)
    _check_table(table)
    _check_aligned(table, "table")
    out = torch.empty_like(table)
    n4 = table.numel() // 4
    if n4 == 0:
        return out
    lib = _kernels.library()
    with torch.cuda.device(table.device):
        err = lib.gki_stream_copy(table.data_ptr(), out.data_ptr(), n4,
                                  _kernels.stream_handle(table.device))
    _kernels.check_launch("stream_copy", err)
    _kernels.launch_counts["stream_copy"] += 1
    return out


def stream_sum_plain(table: torch.Tensor, seed: torch.Tensor,
                     block_rows: int = BLOCK_ROWS) -> torch.Tensor:
    """Plain twin of K5: float32 sum of each block of ``block_rows`` rows
    plus ``float(seed[0])``."""
    _check_sum_args(table, seed, block_rows)
    n_blocks = table.shape[0] // block_rows
    return (table.view(n_blocks, block_rows * table.shape[1]).sum(1)
            + seed[0].to(torch.float32))


def stream_sum(table: torch.Tensor, seed: torch.Tensor,
               block_rows: int = BLOCK_ROWS) -> torch.Tensor:
    """Per-block sums plus ``float(seed[0])``: kernel K5 on CUDA, the plain
    twin on CPU. The kernel sums in another order than the twin, so the
    two agree to float32 rounding, not bit for bit."""
    if table.device.type == "cpu":
        return stream_sum_plain(table, seed, block_rows)
    _kernels.check_cuda_tensor(table, "table", torch.float32, 2)
    _kernels.check_cuda_tensor(seed, "seed", torch.int32, 1)
    _check_sum_args(table, seed, block_rows)
    _check_aligned(table, "table")
    n_blocks = table.shape[0] // block_rows
    out = torch.empty(n_blocks, dtype=torch.float32, device=table.device)
    if n_blocks == 0:
        return out
    lib = _kernels.library()
    with torch.cuda.device(table.device):
        err = lib.gki_stream_sum(table.data_ptr(), seed.data_ptr(),
                                 out.data_ptr(), n_blocks,
                                 block_rows * table.shape[1] // 4,
                                 _kernels.stream_handle(table.device))
    _kernels.check_launch("stream_sum", err)
    _kernels.launch_counts["stream_sum"] += 1
    return out


# -- the lookup's probes ------------------------------------------------------

def _check_device(first: torch.Tensor, **others: torch.Tensor) -> None:
    for name, t in others.items():
        if t.device != first.device:
            raise ValueError(f"{name} must be on {first.device}, got "
                             f"{t.device}")


def _require_cuda(t: torch.Tensor, name: str) -> None:
    """The device half of _kernels.check_cuda_tensor, for a wrapper whose
    argument check holds type, rank and layout already."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")


def _check_shared(n_words: int, what: str) -> None:
    if n_words * 4 > SHARED_BYTES:
        raise ValueError(f"{what} takes {n_words * 4} bytes of shared "
                         f"memory, over {SHARED_BYTES}")


def _check_gather_args(idx: torch.Tensor, table: torch.Tensor,
                       block_q: int) -> None:
    _kernels.check_tensor(idx, "idx", torch.int32, 1)
    _kernels.check_tensor(table, "table", torch.int32, 2)
    _check_device(idx, table=table)
    if table.shape[1] < 1:
        raise ValueError("table must have a column 0")
    if block_q < 1 or idx.shape[0] % block_q:
        raise ValueError(f"block_q {block_q} does not divide the "
                         f"{idx.shape[0]} indices")
    _check_shared(table.shape[0], "table column 0")


def gather_loop_plain(idx: torch.Tensor, table: torch.Tensor,
                      block_q: int = PROBE_BLOCK) -> torch.Tensor:
    """Plain twin of K6: per block of ``block_q`` indices, the int32 sum
    (wrapping) of ``table[idx, 0]``; indices outside the table add 0."""
    _check_gather_args(idx, table, block_q)
    n_t = table.shape[0]
    ok = (idx >= 0) & (idx < n_t)
    vals = torch.zeros(idx.shape, dtype=torch.int64, device=idx.device)
    vals[ok] = table[:, 0].to(torch.int64)[idx[ok].to(torch.int64)]
    # torch.sum of int32 is int64: wrap to 32 bits as the int32 add does
    sums = vals.view(-1, block_q).sum(1) & 0xFFFFFFFF
    return _i32_bits(sums)


def launch_gather_loop(lib, idx: torch.Tensor, table: torch.Tensor,
                       block_q: int) -> torch.Tensor:
    """K6 of the kernel library ``lib`` on checked CUDA tensors: one
    cooperative launch of at most a thread block an SM, which packs the
    table's column 0 into a scratch before it gathers from it."""
    n_q = idx.shape[0]
    out = torch.empty(n_q // block_q, dtype=torch.int32, device=idx.device)
    if n_q == 0:
        return out
    # column 0 packed, in whole 16-byte vectors
    scratch = torch.empty((table.shape[0] + 3) // 4 * 4, dtype=torch.int32,
                          device=idx.device)
    with _kernels.device_guard(idx.device):
        err = lib.gki_gather_loop(idx.data_ptr(), table.data_ptr(), n_q,
                                  table.shape[0], table.shape[1], block_q,
                                  out.data_ptr(), scratch.data_ptr(),
                                  _kernels.stream_handle(idx.device))
    _kernels.check_launch("gather_loop", err)
    _kernels.launch_counts["gather_loop"] += 1
    return out


def gather_loop(idx: torch.Tensor, table: torch.Tensor,
                block_q: int = PROBE_BLOCK) -> torch.Tensor:
    """Per-block gather sums: kernel K6 on CUDA, the plain twin on CPU."""
    if idx.device.type == "cpu":
        return gather_loop_plain(idx, table, block_q)
    _require_cuda(idx, "idx")
    _check_gather_args(idx, table, block_q)
    return launch_gather_loop(_kernels.library(), idx, table, block_q)


def _check_rmw_args(idx: torch.Tensor, n_c: int, cols: int) -> None:
    _kernels.check_tensor(idx, "idx", torch.int32, 1)
    if n_c < 1 or cols < 1:
        raise ValueError(f"counts must be at least (1, 1), got ({n_c}, "
                         f"{cols})")
    _check_shared(n_c, "the counts histogram")


def rmw_loop_plain(idx: torch.Tensor, n_c: int = PROBE_ROWS,
                   cols: int = PROBE_COLS) -> torch.Tensor:
    """Plain twin of K7: an (n_c, cols) int32 table of zeros whose column
    0 counts the indices in [0, n_c)."""
    _check_rmw_args(idx, n_c, cols)
    keep = (idx >= 0) & (idx < n_c)
    counts = torch.zeros((n_c, cols), dtype=torch.int32, device=idx.device)
    counts[:, 0] = _i32_bits(torch.bincount(
        idx[keep].to(torch.int64), minlength=n_c) & 0xFFFFFFFF)
    return counts


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_rmw_loop(lib, idx: torch.Tensor, n_c: int,
                    cols: int) -> torch.Tensor:
    """K7 of the kernel library ``lib`` on a checked CUDA tensor: one
    cooperative launch of a thread block an SM, which writes the whole
    table (zeros included) and needs a scratch row of ``n_c`` counts per
    block."""
    dev = idx.device
    if idx.shape[0] == 0:
        return torch.zeros((n_c, cols), dtype=torch.int32, device=dev)
    counts = torch.empty((n_c, cols), dtype=torch.int32, device=dev)
    n_grid = _sm_count(dev)
    scratch = torch.empty((n_grid, n_c), dtype=torch.int32, device=dev)
    with _kernels.device_guard(dev):
        err = lib.gki_rmw_loop(idx.data_ptr(), idx.shape[0], n_c, cols,
                               counts.data_ptr(), scratch.data_ptr(),
                               n_grid, _kernels.stream_handle(dev))
    _kernels.check_launch("rmw_loop", err)
    _kernels.launch_counts["rmw_loop"] += 1
    return counts


def rmw_loop(idx: torch.Tensor, n_c: int = PROBE_ROWS,
             cols: int = PROBE_COLS) -> torch.Tensor:
    """Index counts in column 0: kernel K7 on CUDA, the plain twin on
    CPU."""
    if idx.device.type == "cpu":
        return rmw_loop_plain(idx, n_c, cols)
    _require_cuda(idx, "idx")
    _check_rmw_args(idx, n_c, cols)
    return launch_rmw_loop(_kernels.library(), idx, n_c, cols)


def _check_cmp_args(qlo, qhi, tlo, thi, tnode) -> None:
    _kernels.check_tensor(qlo, "qlo", torch.int32, 2)
    _kernels.check_tensor(qhi, "qhi", torch.int32, 2)
    for name, t in (("tlo", tlo), ("thi", thi), ("tnode", tnode)):
        _kernels.check_tensor(t, name, torch.int32, 1)
    _check_device(qlo, qhi=qhi, tlo=tlo, thi=thi, tnode=tnode)
    if qhi.shape != qlo.shape:
        raise ValueError(f"qhi {tuple(qhi.shape)} != qlo "
                         f"{tuple(qlo.shape)}")
    if not tlo.shape == thi.shape == tnode.shape:
        raise ValueError("tlo, thi and tnode must have one length")
    _check_shared(3 * tlo.shape[0], "the compared table")


def bcast_cmp_plain(qlo, qhi, tlo, thi, tnode):
    """Plain twin of K8: (node, cnt), int32 of qlo's shape. cnt counts the
    entries j with (tlo[j], thi[j]) == (qlo, qhi); node is tnode of the
    first such j, else 0."""
    _check_cmp_args(qlo, qhi, tlo, thi, tnode)
    lo, hi = qlo.reshape(-1), qhi.reshape(-1)
    node = torch.zeros_like(lo)
    cnt = torch.zeros_like(lo)
    if tlo.shape[0] == 0:
        return node.view(qlo.shape), cnt.view(qlo.shape)
    for s in range(0, lo.shape[0], _CMP_CHUNK):
        m = ((lo[s:s + _CMP_CHUNK, None] == tlo[None])
             & (hi[s:s + _CMP_CHUNK, None] == thi[None]))
        c = m.sum(1)
        first = m.to(torch.uint8).argmax(1)  # the first maximum: first match
        node[s:s + _CMP_CHUNK] = torch.where(c > 0, tnode[first], 0)
        cnt[s:s + _CMP_CHUNK] = c.to(torch.int32)
    return node.view(qlo.shape), cnt.view(qlo.shape)


def bcast_cmp(qlo, qhi, tlo, thi, tnode):
    """Match counts and first-match nodes of every query against every
    table entry: kernel K8 on CUDA, the plain twin on CPU."""
    if qlo.device.type == "cpu":
        return bcast_cmp_plain(qlo, qhi, tlo, thi, tnode)
    _kernels.check_cuda_tensor(qlo, "qlo", torch.int32, 2)
    _check_cmp_args(qlo, qhi, tlo, thi, tnode)
    node = torch.empty_like(qlo)
    cnt = torch.empty_like(qlo)
    if qlo.numel() == 0:
        return node, cnt
    lib = _kernels.library()
    with torch.cuda.device(qlo.device):
        err = lib.gki_bcast_cmp(qlo.data_ptr(), qhi.data_ptr(), qlo.numel(),
                                tlo.data_ptr(), thi.data_ptr(),
                                tnode.data_ptr(), tlo.shape[0],
                                node.data_ptr(), cnt.data_ptr(),
                                _kernels.stream_handle(qlo.device))
    _kernels.check_launch("bcast_cmp", err)
    _kernels.launch_counts["bcast_cmp"] += 1
    return node, cnt
