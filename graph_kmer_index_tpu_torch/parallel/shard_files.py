"""The file names and the atomic write of sharded index checkpoints, in
numpy alone, so that the out-of-core build's worker processes
(parallel.oocbuild) write shard files without importing torch;
parallel.checkpoint reads and writes whole checkpoints over them."""
from __future__ import annotations

import os

import numpy as np

_VERSION = 1


def manifest_path(prefix: str) -> str:
    return f"{prefix}.manifest.npz"


def shard_path(prefix: str, t: int, n_table: int) -> str:
    return f"{prefix}.shard-{t:05d}-of-{n_table:05d}.npz"


def _atomic_savez(path: str, **arrays) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
