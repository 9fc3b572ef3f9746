"""Device-memory bandwidth controls: the port of the stream kernels of
benchmarks/bench_primitives.py.

``stream_copy`` (kernel K4, csrc/stream.cu; ``k_pallas_stream_copy`` in
the JAX benchmarks) copies a float32 table: the bytes it moves per second,
read plus write, are the ceiling that a bandwidth-bound kernel such as K1
or K3 is judged against. ``stream_sum`` (K5; ``k_pallas_stream_sum``) is
its read-only sibling: one float32 sum per block of ``block_rows`` rows,
plus ``float(seed[0])``. Each runs its kernel on a CUDA tensor and its
plain twin on a CPU tensor, and raises on anything the kernel does not
take. The gather, read-modify-write and compare probes of the same file
are still to be ported.
"""
from __future__ import annotations

import torch

from . import _kernels

# bench_primitives.py's sizes: (2^20, 128) float32 = 512 MiB in blocks of
# 4096 rows (256 block sums), about ten times the H100's 50 MB L2
STREAM_ROWS = 1 << 20
STREAM_COLS = 128
BLOCK_ROWS = 1 << 12


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
    """A copy of a contiguous 2-D float32 table: kernel K4 on CUDA, the
    plain twin on CPU."""
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
