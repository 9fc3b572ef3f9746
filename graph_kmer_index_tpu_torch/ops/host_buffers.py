"""Pinned host blocks for results that come back from the card, and a
ring of pinned blocks through which host queries go to it.

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

:func:`upload` sends a host array of hashes to the card through a
:class:`StagingRing`: :data:`STAGE_BLOCKS` reused pinned blocks of
:data:`STAGE_BYTES` a device, each with the CUDA event recorded after its
last copy to the card. The host copies a chunk of the caller's array into
a block (torch's CPU ``copy_``, spread over the process's intra-op
threads) while the card takes the chunk before it from another block, so
the upload runs at the host's threaded copy rate and not at the rate of
CUDA's one-thread staging of pageable memory. The ring's blocks are
not the pool's: they are made at the ring's first upload and kept for the
life of the process, and they take nothing from the pool's free list.
Nor are they PyTorch's caching host allocator's, which never waits for a
block: where no freed block's copy has completed it pins a new one and
keeps it, so its pinned memory would grow with whatever the stream has
queued ahead of the copies, up to the whole query. The ring holds its
blocks and no more, and waits for the next one in turn instead.

Where a chunk's queries roll one base from one to the next, as the k-mers
of each read strand do, the ring sends it in the rolled form
(``ops/rolled.py``): the host's threads scan up to :data:`ROLL_QUERIES`
queries into a block as a 2-bit digit a query and the whole hash of each
query that does not roll (an anchor), the form goes to one buffer of
:data:`ROLL_BYTES` on the card, and a kernel writes the hashes into the
result. The host then reads each hash once and writes about a 21st of
it, and the link carries that 21st. The native encoder probes each
chunk's first queries and leaves a chunk that does not roll (distinct or
sorted k-mers, any array in no read order) to the plain copy, so such
queries pay one probe a chunk.
"""
from __future__ import annotations

import contextlib
import mmap
import threading
import weakref
from collections import deque

import numpy as np
import torch

from ..utils import profiling
from . import rolled

# free blocks the pool keeps at most
MAX_FREE = 2
# the staging ring of a device: its blocks, and the bytes of each. The
# host of an H100 80GB HBM3 (8 CPUs) copies into a pinned block fastest at
# 16 MiB: 21-33 GB/s on its 8 threads (4-6 GB/s on one), against 13-29
# GB/s at 8 or 32 MiB; the link takes 43-49 GB/s, so the host's copy sets
# the pace and a block is free again before its turn comes
STAGE_BLOCKS = 4
STAGE_BYTES = 16 << 20
# the queries a chunk in the rolled form covers at most, and the room of
# its form: on the host in a block, on the card in the ring's one buffer
# (2^23 queries take 2 MiB of digits; the rest holds 16-byte anchors up to
# one query in 13, beyond the one in 16 that the encoder's probe allows).
# The host of an H100 80GB HBM3 takes 45-60 us to set its 8 threads on a
# chunk, so chunks are large
ROLL_QUERIES = 1 << 23
ROLL_BYTES = 12 << 20
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


def _host_int64(array) -> torch.Tensor:
    """``array`` as a CPU tensor whose int64 elements hold the bits that
    ``as_device_tensor`` uploads: a tensor as it is (a copy into int64
    converts it as ``.to(torch.int64)`` would), a uint64 or int64 numpy
    array read in place as a view (a copy only where a stride is negative
    or not a whole number of elements, as in a field of a record array),
    anything else made a uint64 array first."""
    if isinstance(array, torch.Tensor):
        return array
    if not (isinstance(array, np.ndarray)
            and array.dtype in (np.uint64, np.int64)):
        array = np.asarray(array, dtype=np.uint64)
    if any(s < 0 or s % array.itemsize for s in array.strides):
        array = array.copy()
    return torch.from_numpy(array.view(np.int64))


class _Ready:
    """A CPU ring's event: a copy to the CPU is done when it returns."""

    def query(self) -> bool:
        return True

    def synchronize(self) -> None:
        pass

    def record(self, stream=None) -> None:
        pass


class StagingRing:
    """:data:`STAGE_BLOCKS` reused host blocks of :data:`STAGE_BYTES` each
    (as the module sets them when the ring is made), and the event recorded
    after each block's last copy to ``device``; pinned for a CUDA device,
    pageable for the CPU. The blocks are made at the first upload and
    kept."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.n_blocks = STAGE_BLOCKS
        self.chunk = STAGE_BYTES // 8  # int64 elements a block holds
        self.roll_queries = ROLL_QUERIES
        self.roll_bytes = min(ROLL_BYTES, STAGE_BYTES)
        self._blocks: list[_Block] = []
        self._staging: list[torch.Tensor] = []
        self._forms: list[torch.Tensor] = []  # the blocks as bytes
        self._events: list = []
        self._rolled: torch.Tensor | None = None  # the form on the device
        self._rolled_stream = None
        self._next = 0
        self._lock = threading.Lock()

    def _event(self):
        return torch.cuda.Event() if self.device.type == "cuda" else _Ready()

    def _make_blocks(self) -> None:
        cuda = self.device.type == "cuda"
        with (torch.cuda.device(self.device) if cuda
              else contextlib.nullcontext()):
            for _ in range(self.n_blocks):
                block = _Block(self.chunk * 8, pin=cuda)
                self._blocks.append(block)
                self._staging.append(torch.from_numpy(np.frombuffer(
                    block.memory, np.int64, count=self.chunk)))
                self._forms.append(torch.from_numpy(np.frombuffer(
                    block.memory, np.uint8, count=self.roll_bytes)))
                self._events.append(self._event())

    def upload(self, array) -> torch.Tensor:
        """``array`` (see :func:`_host_int64`) as an int64 tensor of its
        shape on the ring's device. Its elements go in order, in chunks:
        wait for the event of the block next in turn (its last copy may
        still be in flight, from this call or an earlier one), fill the
        block on the host with the chunk's rolled form where the encoder
        takes it, else with the chunk itself, copy that on to the device
        on its current stream without waiting, record the block's event,
        and decode a rolled form into the chunk's place in the result.
        Returns without waiting for the card: work on the current stream
        follows the copies in order."""
        host = _host_int64(array)
        flat = host.reshape(-1)
        n = flat.shape[0]
        out = torch.empty(n, dtype=torch.int64, device=self.device)
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)
        # the encoder reads int64 hashes one after another in memory
        roll = flat.dtype == torch.int64 and flat.is_contiguous()
        with self._lock:
            if not self._blocks:
                self._make_blocks()
            start = 0
            while start < n:
                k = self._next
                self._next = (k + 1) % self.n_blocks
                event = self._events[k]
                if not event.query():
                    profiling.count("upload.ring_waits")
                    event.synchronize()
                form = (rolled.encode(flat[start:start + self.roll_queries],
                                      self._forms[k]) if roll else None)
                if form is None:
                    m = min(self.chunk, n - start)
                    block = self._staging[k][:m]
                    block.copy_(flat[start:start + m])
                    out[start:start + m].copy_(block, non_blocking=True)
                    event.record(stream)
                    profiling.count("upload.staged_bytes", m * 8)
                else:
                    m = form.n
                    device_form = self._device_form(stream)
                    device_form[:form.nbytes].copy_(
                        self._forms[k][:form.nbytes], non_blocking=True)
                    event.record(stream)
                    rolled.decode(form, device_form, out[start:start + m])
                    profiling.count("upload.rolled", m - form.n_anchors)
                    profiling.count("upload.anchors", form.n_anchors)
                    profiling.count("upload.rolled_bytes", form.nbytes)
                start += m
        return out.view(host.shape)

    def _device_form(self, stream) -> torch.Tensor:
        """The ring's buffer for a rolled form on its device, made at first
        use. Its copies and decodes follow each other on one stream; a
        chunk on another stream first waits for the last decode."""
        if self._rolled is None:
            self._rolled = torch.empty(self.roll_bytes, dtype=torch.uint8,
                                       device=self.device)
        elif stream is not None and stream != self._rolled_stream:
            stream.wait_stream(self._rolled_stream)
        self._rolled_stream = stream
        return self._rolled


_RINGS: dict[torch.device, StagingRing] = {}
_RINGS_LOCK = threading.Lock()


def upload(array, device) -> torch.Tensor:
    """``array`` (a host array of hashes, see :func:`_host_int64`) as an
    int64 tensor on ``device``, through that device's staging ring, made
    at first use (:meth:`StagingRing.upload`)."""
    device = profiling._device_key(device)
    with _RINGS_LOCK:
        ring = _RINGS.get(device)
        if ring is None:
            ring = _RINGS[device] = StagingRing(device)
    return ring.upload(array)
