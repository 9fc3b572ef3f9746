"""Device-resident object store, the port of
graph_kmer_index_tpu/parallel/device_store.py (which replaces the
reference's POSIX shared-memory store, shared_mem.py:37-120:
``to_shared_memory(obj, name)`` / ``from_shared_memory(cls, name)``).

``to_device_memory`` moves every numpy array of ``obj.properties`` onto a
named device as a tensor and registers them under a name (uint64 as the
int64 of its bits, narrower unsigned types as int64: torch does no
arithmetic on them; every other dtype kept); ``from_device_memory``
rebuilds the object class around the same tensors, with no copy. Across
ranks each rank keeps its own store.
"""
from __future__ import annotations

import numpy as np

from ..device import resolve_device
from ..ops.lookup import as_device_tensor

_REGISTRY: dict = {}


class SingleSharedArray:
    """Wrapper that lets a bare array travel through the object store
    (reference shared_mem.py:11-18: the same trick for SharedArray
    segments)."""

    properties = ["array"]

    def __init__(self, array=None):
        self.array = array


def to_device_memory(obj, name: str, device="cuda") -> str:
    """Put every array in ``obj.properties`` on ``device``; register by
    name."""
    dev = resolve_device(device)
    arrays = {}
    for prop in obj.properties:
        value = getattr(obj, prop)
        if isinstance(value, np.ndarray):
            value = as_device_tensor(value, None, dev)
        arrays[prop] = value
    _REGISTRY[name] = (type(obj), arrays)
    return name


def from_device_memory(cls, name: str):
    """Rebuild the object around the registered tensors (no copy)."""
    stored_cls, arrays = _REGISTRY[name]
    assert issubclass(stored_cls, cls) or stored_cls is cls, \
        f"{name} holds a {stored_cls.__name__}, not {cls.__name__}"
    obj = cls.__new__(cls)
    # construct via __init__ when the signature is the property dict,
    # else set attributes directly (covers both styles used in models/)
    try:
        obj.__init__(**arrays)
    except TypeError:
        for prop, value in arrays.items():
            setattr(obj, prop, value)
    return obj


def free(name: str) -> None:
    _REGISTRY.pop(name, None)


def free_all() -> None:
    """Reference remove_shared_memory_in_session equivalent
    (shared_mem.py:99-120)."""
    _REGISTRY.clear()
