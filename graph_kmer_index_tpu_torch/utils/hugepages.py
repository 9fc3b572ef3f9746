"""Transparent-hugepage-backed numpy allocation.

(The port's copy of graph_kmer_index_tpu/utils/hugepages.py.)

Where THP runs in ``madvise`` mode, first-touch page faults at 4KB pages
dominate the fill of a fresh large buffer.  Every allocate-then-fill of
a large array should therefore go through :func:`hp_empty` /
:func:`hp_zeros`, which advise the kernel to back the range with 2MB
pages *before* the first write.

MADV_HUGEPAGE alone is NOT enough once the process heap is fragmented:
with THP defrag in ``madvise`` mode each huge-page fault does
synchronous compaction.  MADV_POPULATE_WRITE populates the range in one
syscall at allocation time, so :func:`hp_empty` — whose contract is
allocate-then-fill-everything — populates eagerly.  :func:`hp_zeros` keeps lazily-zeroed pages by
default (its big callers are modulo-sized tables that may stay sparse
and rely on shared zero pages for RSS).

No-ops anywhere madvise is unavailable.  Safe on already-touched memory
(madvise(MADV_HUGEPAGE) only affects future faults; POPULATE_WRITE on
populated pages is a cheap no-op walk).
"""
import ctypes
import sys

import numpy as np

_MADV_HUGEPAGE = 14
_MADV_POPULATE_WRITE = 23
_PAGE = 4096
_MIN_BYTES = 1 << 20  # don't bother below 1MB

_libc = None
if sys.platform.startswith("linux"):
    try:
        _libc = ctypes.CDLL("libc.so.6", use_errno=True)
    except OSError:
        _libc = None


def _madvise(arr: np.ndarray, advice: int) -> bool:
    if _libc is None or arr.nbytes < _MIN_BYTES:
        return False
    addr = arr.ctypes.data
    start = (addr + _PAGE - 1) // _PAGE * _PAGE
    end = (addr + arr.nbytes) // _PAGE * _PAGE
    if end <= start:
        return False
    return _libc.madvise(ctypes.c_void_p(start),
                         ctypes.c_size_t(end - start), advice) == 0


def madvise_hugepage(arr: np.ndarray) -> bool:
    """Advise THP backing for ``arr``'s buffer. Returns True on success."""
    return _madvise(arr, _MADV_HUGEPAGE)


def madvise_populate(arr: np.ndarray) -> bool:
    """Populate ``arr``'s pages now (one syscall, no per-page faults).
    Returns True on success; False on old kernels (< 5.14, EINVAL) —
    callers then just pay first-touch faults as before."""
    return _madvise(arr, _MADV_POPULATE_WRITE)


def hp_empty(shape, dtype) -> np.ndarray:
    a = np.empty(shape, dtype)
    madvise_hugepage(a)
    madvise_populate(a)
    return a


def hp_concatenate(arrays) -> np.ndarray:
    """np.concatenate into a populated hugepage-advised buffer (1-D).
    A plain np.concatenate output faults page-by-page while copying —
    the pathological path this module exists to avoid."""
    arrays = [np.asarray(a) for a in arrays]
    if not arrays:
        raise ValueError("need at least one array")
    # promote like np.concatenate would (a first-array dtype would
    # silently truncate mixed-dtype inputs)
    dtype = np.result_type(*[a.dtype for a in arrays])
    out = hp_empty(sum(len(a) for a in arrays), dtype)
    pos = 0
    for a in arrays:
        out[pos:pos + len(a)] = a
        pos += len(a)
    return out


def hp_zeros(shape, dtype, populate=False) -> np.ndarray:
    # np.zeros gets lazily-zeroed pages from calloc; the advice must
    # land before the consumer's first write, which this guarantees
    a = np.zeros(shape, dtype)
    madvise_hugepage(a)
    if populate:
        madvise_populate(a)
    return a




_MALLOC_CAPPED = False


def cap_malloc_mmap_threshold(threshold: int = 1 << 20) -> bool:
    """Pin glibc's mmap threshold so every allocation >= ``threshold``
    comes from (and returns to) its own mapping instead of the arenas.

    glibc's threshold is DYNAMIC: repeatedly freeing large blocks
    raises it (up to 32 MB), after which multi-MB numpy buffers are
    carved from brk/arena memory where interleaved small live objects
    prevent coalescing — a streaming consumer (the out-of-core spill
    loop) then retains many chunk-sizes of freed-but-unreturnable
    heap. Pinning makes frees immediate; the refault cost on new
    mappings is bounded by the THP fault path (see module docstring).
    Process-wide; idempotent."""
    global _MALLOC_CAPPED
    if _MALLOC_CAPPED:
        return True
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        M_MMAP_THRESHOLD = -3
        ok = bool(libc.mallopt(M_MMAP_THRESHOLD, int(threshold)))
        _MALLOC_CAPPED = ok
        return ok
    except Exception:
        return False
