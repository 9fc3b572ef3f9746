"""FASTA/FASTQ read streaming: the port of graph_kmer_index_tpu/read_kmers.py:
its device path (``hash_fasta_file(keep_on_device=True)``) as
:func:`hash_fasta_file`, and the per-read host class ``ReadKmers``.

The file is parsed on the host in whole-record blocks into a 2-bit read
tape (by the native library's C++ parser where it is available, else in
Python: the same arrays); each tape segment is uploaded once and hashed on the device with
cross-read windows compacted out (ops.encode.read_tape_hashes). The read
k-mers stay on the device for the lookup.
"""
from __future__ import annotations

import contextlib
import itertools
import logging
import time

import numpy as np
import torch

from . import native
from .device import resolve_device
from .hashing import (ASCII_TO_2BIT, kmer_to_hash_fast,
                      letter_sequence_to_numeric, power_array,
                      sliding_window_hashes)
from .ops.encode import read_tape_hashes, revcomp_hashes
from .utils import profiling

# a tape segment holds at most this many bases (cut at read boundaries):
# it bounds the device transients of hashing and compaction
SEGMENT_BASES = 1 << 28
BLOCK_BYTES = 1 << 27

_COMP = str.maketrans("acgtACGT", "tgcaTGCA")


def reverse_complement_string(seq: str) -> str:
    return seq.translate(_COMP)[::-1]


def _iter_record_blocks(path: str, block_bytes: int):
    """Yield whole-record byte blocks of a FASTA/FASTQ file, each about
    <= ``block_bytes`` (one oversize record may exceed it). Blocks cut
    only at record headers; a FASTQ quality line (the line after a '+'
    line) is never taken for a header, and blank lines do not consume
    that state."""
    buf = bytearray()
    skip_quality = False
    with open(path, "rb") as f:
        for line in f:
            s = line.strip()
            if s:
                if skip_quality:
                    skip_quality = False
                elif s.startswith(b"+"):
                    skip_quality = True
                elif s[:1] in (b">", b"@") and len(buf) >= block_bytes:
                    yield bytes(buf)
                    buf = bytearray()
            buf += line
    if buf:
        yield bytes(buf)


def encode_block(text: bytes):
    """(int8 2-bit tape, int64 starts, int64 lens) of one text block: one
    read per sequence line (a multi-line FASTA record is several reads),
    header lines ('>'/'@') and FASTQ '+'/quality lines skipped, blank
    lines ignored, whitespace (CRLF included) stripped. Parsed by the
    native library (``native.fasta_encode``) when it is available, else
    by :func:`encode_block_plain`."""
    encoded = native.fasta_encode(text)
    if encoded is not None:
        return encoded
    return encode_block_plain(text)


def encode_block_plain(text: bytes):
    """:func:`encode_block` in Python: the route of a machine without a
    compiler, and the native parser's twin in the tests."""
    lines = []
    skip_quality = False
    for line in text.decode().splitlines():
        line = line.strip()
        if not line:
            continue
        if skip_quality:
            skip_quality = False
        elif line.startswith("+"):
            skip_quality = True
        elif not line.startswith((">", "@")):
            lines.append(line)
    raw = np.frombuffer("".join(lines).encode("ascii"), dtype=np.uint8)
    flat = ASCII_TO_2BIT[raw].view(np.int8)
    lens = np.fromiter((len(line) for line in lines), dtype=np.int64,
                       count=len(lines))
    starts = np.cumsum(lens) - lens
    return flat, starts, lens


class DeviceReadKmers:
    """Read k-mers on the device: one int64 tensor per tape segment, the
    valid windows only, in read order. ``to_numpy()`` gives the uint64
    array of the JAX package's host path."""

    def __init__(self, segments, k: int):
        self.segments = segments  # list[torch.Tensor]
        self.k = k

    def __len__(self):
        return sum(int(s.shape[0]) for s in self.segments)

    def to_numpy(self) -> np.ndarray:
        if not self.segments:
            return np.zeros(0, dtype=np.uint64)
        return torch.cat(self.segments).cpu().numpy().view(np.uint64)


def _segment_cuts(starts: np.ndarray, lens: np.ndarray, bound: int):
    """Read-index boundaries of tape segments of <= ``bound`` bases (a
    single longer read is a segment of its own)."""
    ends = starts + lens
    cuts = [0]
    while True:
        nxt = int(np.searchsorted(ends, starts[cuts[-1]] + bound,
                                  side="right"))
        nxt = max(nxt, cuts[-1] + 1)
        if nxt >= len(starts):
            break
        cuts.append(nxt)
    cuts.append(len(starts))
    return cuts


def hash_fasta_file(path, k: int, *, device,
                    include_reverse_complements: bool = False,
                    block_bytes: int | None = None,
                    stage_seconds: dict | None = None) -> DeviceReadKmers:
    """All window hashes of all reads in a FASTA/FASTQ file, on
    ``device``: every forward k-mer in read order, then (with
    ``include_reverse_complements``) every reverse complement in the same
    order. The read (the file cut into whole-record blocks), parse (a
    block's 2-bit encoding), upload and hash stages are the spans
    ``read_kmers.<stage>`` inside ``read_kmers.hash_fasta_file``
    (utils.profiling). With ``stage_seconds``, each stage also ends in a
    device synchronise and its host-clock seconds are added to it."""
    dev = resolve_device(device)

    @contextlib.contextmanager
    def timed(name):
        t0 = time.perf_counter()
        with profiling.span(name):
            yield
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        key = name.rpartition(".")[2]
        stage_seconds[key] = (stage_seconds.get(key, 0.0)
                              + time.perf_counter() - t0)

    def stage(name):
        return profiling.span(name) if stage_seconds is None else timed(name)

    fw, rc = [], []
    with profiling.span("read_kmers.hash_fasta_file"):
        blocks = _iter_record_blocks(path, block_bytes or BLOCK_BYTES)
        while True:
            with stage("read_kmers.read"):
                text = next(blocks, None)
            if text is None:
                break
            with stage("read_kmers.parse"):
                flat, starts, lens = encode_block(text)
            if len(flat) == 0:
                continue
            cuts = _segment_cuts(starts, lens, SEGMENT_BASES)
            for r0, r1 in zip(cuts[:-1], cuts[1:]):
                base = int(starts[r0])
                seg_n = int(starts[r1 - 1] + lens[r1 - 1]) - base
                with stage("read_kmers.upload"):
                    tape = torch.from_numpy(flat[base:base + seg_n]).to(dev)
                    seg_starts = torch.from_numpy(starts[r0:r1] - base).to(dev)
                    seg_lens = torch.from_numpy(lens[r0:r1]).to(dev)
                with stage("read_kmers.hash"):
                    hashes, _n_valid = read_tape_hashes(
                        tape, seg_starts, seg_lens, seg_n, k)
                    del tape
                    fw.append(hashes)
                    if include_reverse_complements:
                        rc.append(revcomp_hashes(hashes, k))
    return DeviceReadKmers(fw + rc, k)


class ReadKmers:
    """Per-read window hashes on the host (reference read_kmers.py:9-89):
    an iterable of one uint64 array per read. The batched route to the
    device is :func:`hash_fasta_file`; ``ReadKmers.hash_fasta_file``
    returns its k-mers as the uint64 numpy array of the JAX package's
    host path."""

    def __init__(self, kmers):
        self.kmers = kmers
        self._power_vector = None

    @classmethod
    def from_fasta_file(cls, fasta_file_name, k, small_k=None, smallest_k=8):
        with open(fasta_file_name) as f:
            lines = [l.strip() for l in f.readlines() if not l.startswith(">")]
        logging.info("Number of lines: %d", len(lines))

        def both_strands(power_vector):
            return (itertools.chain(
                ReadKmers.get_kmers_from_read_dynamic(line, power_vector),
                ReadKmers.get_kmers_from_read_dynamic(
                    reverse_complement_string(line), power_vector))
                for line in lines)

        power_vector = power_array(k)
        if small_k is None:
            kmers = itertools.chain(
                (ReadKmers.get_kmers_from_read_dynamic(line, power_vector)
                 for line in lines),
                (ReadKmers.get_kmers_from_read_dynamic(
                    reverse_complement_string(line), power_vector)
                 for line in lines))
        else:
            kmers = zip(both_strands(power_vector),
                        both_strands(power_array(small_k)),
                        both_strands(power_array(smallest_k)))
        return cls(kmers)

    @classmethod
    def from_list_of_string_kmers(cls, string_kmers):
        kmers = [
            [kmer_to_hash_fast(letter_sequence_to_numeric(k), len(k))
             for k in read_kmers]
            for read_kmers in string_kmers]
        return cls(kmers)

    @staticmethod
    def get_kmers_from_read(read, k):
        return [
            kmer_to_hash_fast(letter_sequence_to_numeric(read[i:i + k]), k)
            for i in range(len(read) - k)]

    @staticmethod
    def get_kmers_from_read_dynamic(read, power_vector):
        """All window hashes of a read; ``power_vector`` carries k
        (reference read_kmers.py:68-70 np.convolve equivalent)."""
        k = len(power_vector)
        numeric = letter_sequence_to_numeric(read)
        return sliding_window_hashes(numeric, k)

    @staticmethod
    def hash_fasta_file(fasta_file_name, k, include_reverse_complements=False,
                        *, device, block_bytes=None) -> np.ndarray:
        """All window hashes of all reads of a FASTA/FASTQ file as one
        uint64 array (forward k-mers in read order, then the reverse
        complements), hashed on ``device``."""
        return hash_fasta_file(
            fasta_file_name, k, device=device,
            include_reverse_complements=include_reverse_complements,
            block_bytes=block_bytes).to_numpy()

    def __iter__(self):
        return self.kmers.__iter__()

    def __next__(self):
        return self.kmers.__next__()
