"""Build and load the hand-written CUDA kernels (ctypes route).

The sources under ``csrc/`` have a plain C interface, so they compile with
nvcc alone in seconds (no PyTorch headers): one nvcc per source, all
started together, then one link into a shared library under
``graph_kmer_index_tpu_torch/build/``, named by the sources' content hash.
The library is built at first use, never at import: the CPU tests import
every module on a machine without nvcc.

Each wrapper adds one to its entry in ``launch_counts`` where it launches
its kernel, and nowhere else, so a run can show that its main path went
through the kernels.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
SOURCES = ("sliding_hash.cu", "packed_lookup.cu", "sliding_pack.cu",
           "stream.cu", "probes.cu", "rolled_decode.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

launch_counts = {"sliding_hash": 0, "packed_lookup": 0,
                 "sliding_pack_p16": 0, "sliding_pack_p8": 0,
                 "stream_copy": 0, "stream_sum": 0, "gather_loop": 0,
                 "rmw_loop": 0, "bcast_cmp": 0, "rolled_decode": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    digest = hashlib.sha256()
    for name in SOURCES:
        digest.update((CSRC_DIR / name).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libgki_torch_{digest.hexdigest()[:16]}.so"


def _run_together(cmds: list[list[str]]) -> None:
    """Start every command, wait for all of them, and raise with the output
    of the first that failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{log}")


@functools.cache
def build() -> tuple[Path, float]:
    """Compile the kernels unless the library for these sources exists.
    Returns (library path, build seconds); raises with nvcc's output if
    a compile or the link fails."""
    path = library_path()
    if path.exists():
        return path, 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{Path(name).stem}.o") for name in SOURCES]
        _run_together([[nvcc, *NVCC_FLAGS, "-c", "-o", obj,
                        str(CSRC_DIR / name)]
                       for name, obj in zip(SOURCES, objs)])
        lib = Path(tmp) / path.name
        _run_together([[nvcc, "-shared", "-o", str(lib), *objs]])
        os.replace(lib, path)
    return path, time.perf_counter() - t0


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    ptr, i64, u64 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_ulonglong
    lib.gki_sliding_hash.argtypes = [ptr, ptr, i64, ctypes.c_int, ptr]
    lib.gki_sliding_hash.restype = ctypes.c_int
    lib.gki_packed_lookup.argtypes = [ptr, ptr, i64, i64, u64, u64, u64,
                                      ptr, ptr, i64, ptr, i64, ptr,
                                      ctypes.c_int, ptr, ptr]
    lib.gki_packed_lookup.restype = ctypes.c_int
    lib.gki_sliding_pack.argtypes = [ptr, ptr, i64, ctypes.c_int,
                                     ctypes.c_int, ptr]
    lib.gki_sliding_pack.restype = ctypes.c_int
    lib.gki_stream_copy.argtypes = [ptr, ptr, i64, ptr]
    lib.gki_stream_copy.restype = ctypes.c_int
    lib.gki_stream_sum.argtypes = [ptr, ptr, ptr, i64, i64, ptr]
    lib.gki_stream_sum.restype = ctypes.c_int
    lib.gki_gather_loop.argtypes = [ptr, ptr, i64, ctypes.c_int, i64,
                                    ctypes.c_int, ptr, ptr, ptr]
    lib.gki_gather_loop.restype = ctypes.c_int
    lib.gki_rmw_loop.argtypes = [ptr, i64, ctypes.c_int, i64, ptr, ptr,
                                 ctypes.c_int, ptr]
    lib.gki_rmw_loop.restype = ctypes.c_int
    lib.gki_bcast_cmp.argtypes = [ptr, ptr, i64, ptr, ptr, ptr,
                                  ctypes.c_int, ptr, ptr, ptr]
    lib.gki_bcast_cmp.restype = ctypes.c_int
    lib.gki_rolled_decode.argtypes = [ptr, i64, ctypes.c_int, i64, i64, ptr,
                                      ptr]
    lib.gki_rolled_decode.restype = ctypes.c_int
    return lib


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def device_guard(device: torch.device):
    """A context in which ``device`` is the current CUDA device; it costs
    nothing where it already is."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def check_cuda_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                      ndim: int) -> None:
    """Raise on anything a kernel does not take."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    check_tensor(t, name, dtype, ndim)


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                 ndim: int) -> None:
    """Raise unless ``t`` has this dtype and rank and is contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {t.dim()}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
