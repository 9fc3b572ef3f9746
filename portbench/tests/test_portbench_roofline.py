"""The frozen roofline arithmetic against hand-worked small cases."""
import pytest
import torch

from portbench.lib import roofline


def test_peak_and_bound():
    assert roofline.PEAK_BYTES_PER_S == 3.35e12
    assert roofline.bound_seconds(3.35e12) == 1.0
    assert roofline.roofline_percent(3.35e9, 2e-3) == pytest.approx(50.0)
    assert roofline.roofline_percent(1, 0) is None


def test_k1_bytes():
    # 150 M bases: one byte in and one int64 hash out a base
    assert roofline.k1_bytes(150_000_000) == 1_350_000_000
    assert roofline.k1_bytes(0) == 0


def test_internal_modulo():
    assert roofline.internal_modulo(0) == 67
    assert roofline.internal_modulo(10) == 67
    assert roofline.internal_modulo(40) == 83  # 81 = 3^4, 83 prime
    # the chromosome's 241,229,002 rows: its packed table's record count
    assert roofline.internal_modulo(241_229_002) == 482_458_021


def test_k2_bytes_hand_worked():
    """Rows at modulo2 = 67: bucket 1 holds 1, 68, 135 (deep), bucket 2
    holds 2 twice (dup2), bucket 3 holds 3 and 70 (plain pair), bucket 4
    holds 4."""
    rows = torch.tensor([1, 68, 135, 2, 2, 3, 70, 4])
    sizes = roofline.BucketSizes(rows, torch.arange(10, 18))
    assert sizes.modulo2 == 67
    # queries: 1 (deep bucket, hit), 202 (deep bucket, miss), 2 (dup2,
    # hit), 69 (dup2 bucket, miss: the record answers it), 3 (pair, hit),
    # 5 (empty bucket), 1 again (counted once in the scan)
    q = torch.tensor([1, 202, 2, 69, 3, 5, 1])
    n_nodes = 14
    # non-final distinct k-mers: 1 (scans 3, matches 1), 202 (scans 3,
    # matches 0), 2 (scans 2, matches 2)
    scanned, matched = 3 + 3 + 2, 1 + 0 + 2
    # nodes hit: 10 (k-mer 1), 13 and 14 (k-mer 2), 15 (k-mer 3)
    want = 7 * 40 + (scanned + matched) * 8 + 4 * 8
    assert roofline.k2_bytes(sizes, q, 20) == want
    # nodes at or above n_nodes (14 and 15) are dropped, as K2 drops them
    want -= 8 * 2
    assert roofline.k2_bytes(sizes, q, n_nodes) == want


def test_k2_bytes_all_final():
    rows = torch.tensor([10, 11, 12])
    sizes = roofline.BucketSizes(rows, torch.tensor([0, 1, 1]))
    q = torch.tensor([10, 11, 99])
    assert roofline.k2_bytes(sizes, q, 4) == 3 * 40 + 2 * 8
