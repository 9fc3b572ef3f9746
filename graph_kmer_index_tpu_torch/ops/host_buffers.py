"""Pinned host blocks for results that come back from the card.

``KmerIndex.map_kmers`` copies its node counts (2.1 GB on a whole-genome
signature index) to the host once a call. Into a fresh pageable array that
copy costs the kernel's faulting in and zeroing of the new memory, then
CUDA's staging through its own pinned bounce buffer; into memory
that is already pinned it is one DMA at the link's rate.

:func:`take` lends a pinned host tensor of exactly the size asked for.
Each block is a page-aligned anonymous mapping of its own, registered with
CUDA (``cudaHostRegister``), and not PyTorch's caching host
allocator, which rounds a request up to the next power of two (a block
maps at most one huge page, 2 MiB, beyond the request). The block
is lent behind a numpy array that the tensor's storage holds; it comes
back to the pool only when that array is gone, that is when the tensor,
every tensor view of it, every numpy array made from it and every numpy
view of those are gone. So a result the caller keeps is never written
again.

The pool keeps at most :data:`MAX_FREE` blocks free; past that it unpins
and drops one, a block of another size than the one just given back
first, else the oldest. Host memory is then the caller's live results and
at most two blocks more.

Blocks come back from ``weakref.finalize`` callbacks, which the garbage
collector may run at any point, in any thread, also inside :meth:`take`.
A returned block is queued on a deque (one atomic append) and moved to the
free list by whoever can take the pool's lock without waiting; the holder
of the lock moves what was queued meanwhile before it is done.
"""
from __future__ import annotations

import mmap
import threading
import weakref
from collections import deque

import numpy as np
import torch

from ..utils import profiling

# free blocks the pool keeps at most
MAX_FREE = 2
# a mapping of at least this many bytes is a whole number of them: the
# CUDA pins 2.12 GB so in 0.34-0.42 s, at the exact size in 1.16-1.21 s
# (the host of an H100 80GB HBM3)
HUGE_PAGE = 1 << 21


class _Block:
    """``nbytes`` lent out of one anonymous mapping (rounded up to whole
    huge pages from one huge page on), pinned where the pool pins. The
    pinning faults every page in."""

    def __init__(self, nbytes: int, pin: bool):
        self.nbytes = nbytes
        size = (-(-nbytes // HUGE_PAGE) * HUGE_PAGE if nbytes >= HUGE_PAGE
                else max(nbytes, 1))
        self.memory = mmap.mmap(-1, size)
        self.ptr = np.frombuffer(self.memory, np.uint8).ctypes.data
        self.pinned = False
        if pin:
            torch.cuda.check_error(torch.cuda.cudart().cudaHostRegister(
                self.ptr, len(self.memory), 0))
            self.pinned = True

    def release(self) -> None:
        """Unpin; the mapping goes with the last reference to the block."""
        if self.pinned:
            self.pinned = False
            torch.cuda.check_error(
                torch.cuda.cudart().cudaHostUnregister(self.ptr))


class HostBlockPool:
    """Blocks of host memory lent out as tensors (see the module's text).
    ``pin``: register each block with CUDA; without it the
    blocks are plain pageable memory, lent and taken back the same way."""

    def __init__(self, pin: bool = True):
        self.pin = pin
        self._lock = threading.Lock()
        self._free: list[_Block] = []  # oldest first
        self._returned: deque[_Block] = deque()

    def take(self, n: int, dtype: torch.dtype) -> torch.Tensor:
        """A 1-D host tensor of ``n`` elements of ``dtype``, on a block
        lent until the last array or view over it is gone. Its contents are
        whatever the block last held: the caller overwrites them."""
        nbytes = n * dtype.itemsize
        with self._lock:
            self._settle_locked()
            block = next((b for b in self._free if b.nbytes == nbytes), None)
            if block is not None:
                self._free.remove(block)
        self._settle()
        if block is None:
            block = _Block(nbytes, self.pin)
            profiling.count("host_counts.allocated")
        else:
            profiling.count("host_counts.reused")
        lent = np.frombuffer(block.memory, np.uint8, count=nbytes)
        back = weakref.finalize(lent, self._give_back, block)
        back.atexit = False
        return torch.from_numpy(lent).view(dtype)

    def free_nbytes(self) -> list[int]:
        """The sizes of the free blocks, oldest first."""
        self._settle()
        with self._lock:
            return [b.nbytes for b in self._free]

    def _give_back(self, block: _Block) -> None:
        self._returned.append(block)
        self._settle()

    def _settle(self) -> None:
        """Move the returned blocks to the free list, unless another
        caller holds the lock: that caller moves them before it is done."""
        while self._returned and self._lock.acquire(blocking=False):
            try:
                self._settle_locked()
            finally:
                self._lock.release()

    def _settle_locked(self) -> None:
        while self._returned:
            block = self._returned.popleft()
            self._free.append(block)
            while len(self._free) > MAX_FREE:
                other = [b for b in self._free if b.nbytes != block.nbytes]
                victim = (other or self._free)[0]
                self._free.remove(victim)
                victim.release()


_POOL = HostBlockPool()
take = _POOL.take
