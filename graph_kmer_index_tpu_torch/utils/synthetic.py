"""Chip-scale synthetic data for the read-mapping path, all from one seed:
a random genome with planted repeats, and reads sampled from it with
substitutions, written as FASTA."""
from __future__ import annotations

import numpy as np

_ASCII = np.frombuffer(b"ACGT", dtype=np.uint8)

# one poly-A run: k-mer 0 repeated, an ultra-deep bucket (> SCAN_CAP rows)
POLY_A_LEN = 400
# share of the genome copied over itself in segments of SEGMENT_RANGE
# bases: repeated k-mers, the index's dup2 and deep buckets
REPEAT_FRACTION = 0.005
SEGMENT_RANGE = (1000, 10000)
# per-base substitution rate of the sampled reads
ERROR_RATE = 0.01
# share of the sampled reads drawn over the poly-A run
POLY_A_FRACTION = 0.01


def random_genome(n_bases: int, rng: np.random.Generator):
    """(int8 2-bit genome, (poly-A start, poly-A length)).

    Uniform random bases, then REPEAT_FRACTION of the genome copied over
    itself in segments, then one poly-A run of POLY_A_LEN bases."""
    if n_bases <= max(SEGMENT_RANGE[1], POLY_A_LEN):
        raise ValueError("genome too short for its planted repeats")
    genome = rng.integers(0, 4, n_bases, dtype=np.int8)
    copied, target = 0, int(REPEAT_FRACTION * n_bases)
    while copied < target:
        length = int(rng.integers(SEGMENT_RANGE[0], SEGMENT_RANGE[1] + 1))
        src, dst = rng.integers(0, n_bases - length, 2)
        genome[dst:dst + length] = genome[src:src + length].copy()
        copied += length
    poly_a = int(rng.integers(0, n_bases - POLY_A_LEN))
    genome[poly_a:poly_a + POLY_A_LEN] = 0
    return genome, (poly_a, POLY_A_LEN)


def sample_reads(genome: np.ndarray, n_reads: int, read_len: int,
                 rng: np.random.Generator,
                 poly_a: tuple[int, int]) -> np.ndarray:
    """(n_reads, read_len) int8 reads at uniform genome positions, with
    POLY_A_FRACTION of them overlapping the (start, length) poly-A run
    that :func:`random_genome` returned, and each base substituted by
    another with ERROR_RATE."""
    n = len(genome)
    starts = rng.integers(0, n - read_len + 1, n_reads)
    pa_start, pa_len = poly_a
    n_pa = int(POLY_A_FRACTION * n_reads)
    lo = max(0, pa_start - read_len + 1)
    hi = min(n - read_len, pa_start + pa_len - 1)
    starts[:n_pa] = rng.integers(lo, hi + 1, n_pa)
    reads = np.empty((n_reads, read_len), dtype=np.int8)
    offsets = np.arange(read_len)
    for i in range(0, n_reads, 1 << 16):
        reads[i:i + (1 << 16)] = genome[starts[i:i + (1 << 16), None]
                                        + offsets]
    errors = rng.random(reads.shape) < ERROR_RATE
    shift = rng.integers(1, 4, int(errors.sum()), dtype=np.int8)
    reads[errors] = (reads[errors] + shift) % 4
    return reads


def write_fasta(path, reads: np.ndarray) -> None:
    """Reads (2-bit codes) as FASTA: one ``>read`` header and one
    sequence line per read."""
    header = np.frombuffer(b">read\n", dtype=np.uint8)
    n, length = reads.shape
    lines = np.empty((n, len(header) + length + 1), dtype=np.uint8)
    lines[:, :len(header)] = header
    lines[:, len(header):-1] = _ASCII[reads]
    lines[:, -1] = ord("\n")
    lines.tofile(path)
