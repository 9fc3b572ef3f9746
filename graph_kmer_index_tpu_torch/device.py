"""Explicit device selection: nothing in the port picks the CPU silently."""
from __future__ import annotations

import torch


def require_cuda() -> None:
    """Raise unless a CUDA device is present."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the kernels of this package "
                           "run only on an NVIDIA GPU")


def resolve_device(device) -> torch.device:
    """``device`` ("cuda", "cuda:0", "cpu" or a ``torch.device``) as a
    ``torch.device``; a CUDA device must exist."""
    if device is None:
        raise ValueError("pass an explicit device ('cuda' or 'cpu')")
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
