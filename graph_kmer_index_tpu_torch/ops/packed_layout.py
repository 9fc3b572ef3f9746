"""The packed record layout's constants and host arithmetic, in numpy only,
so that host modules (the out-of-core packed conversion and its subprocess
workers, parallel.oocbuild) use them without importing torch.
ops.lookup builds and serves the layout on a device; it takes these from
here (JAX ops/lookup.py keeps them beside its device code).

One 32-byte record per internal bucket, eight 32-bit lanes:

    [k0_lo, k0_hi, node0, ~(size | dup2 << 30), k1_lo, k1_hi,
     node1 or start row, spare]
"""
from __future__ import annotations

# buckets deeper than this are "ultra" (e.g. poly-A): resolved per unique
# query k-mer, not by the scan by depth
SCAN_CAP = 256
# the size lane's flag of a "dup2" bucket: one k-mer twice
DUP2 = 1 << 30


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def internal_modulo(n_rows: int) -> int:
    """Next prime >= max(67, 2*n_rows + 1)."""
    m = max(67, 2 * n_rows + 1)
    while not _is_prime(m):
        m += 1
    return m


def record_rows(modulo2: int) -> int:
    """Rows of the record tensor: modulo2 rounded up to 16, as in JAX."""
    return -(-modulo2 // 16) * 16


def _dup2_masks(is_second, sz_row, ks):
    """(dup_b, dup_a): second / first row of every size-2 bucket that
    holds the same k-mer twice (JAX lookup.py:_dup2_masks). Takes numpy
    arrays or torch tensors, and returns the same kind."""
    same = is_second ^ is_second  # all False, of the input's kind
    same[1:] = ks[1:] == ks[:-1]
    dup_b = is_second & (sz_row == 2) & same
    dup_a = dup_b ^ dup_b
    dup_a[:-1] = dup_b[1:]
    return dup_b, dup_a
