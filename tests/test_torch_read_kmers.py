"""Port parity: graph_kmer_index_tpu_torch.hash_fasta_file against the
JAX package's ReadKmers.hash_fasta_file(keep_on_device=True), on the CPU,
over adversarial FASTA/FASTQ input."""
import jax  # noqa: F401  (JAX on the CPU backend, set up by conftest)
import numpy as np
import pytest
import torch

from graph_kmer_index_tpu import ReadKmers
from graph_kmer_index_tpu_torch import hash_fasta_file
from graph_kmer_index_tpu_torch import read_kmers as torch_read_kmers

torch.set_num_threads(2)

_BIG = "ACGTTGCA" * 500
FILES = {
    # FASTQ quality lines starting with '@', '>' and '+', a blank line,
    # CRLF, a record far larger than the block, multi-line FASTA
    "mix.fq": (5, b"@r1\nACTGACTG\n+\n@CGTACGT\n"
                  b"@r2\nTTTTTAAA\n+r2\n>IIIIIII\n"
                  b"@r3\nGGGGCCCC\n+\n+FFFFFFF\n"
                  b"\n@r4\r\nACACACAC\r\n+\r\nFFFFFFFF\r\n"
                  + f">big\n{_BIG}\n".encode()
                  + b">multi\nACGT\nTGCA\nGGCC\n"),
    # quality lines that look like sequence
    "reads.fq": (3, b"@r1\nACTGACTG\n+\nFFGGACGT\n@r2\nTTTTT\n+r2\nIIIII\n"),
}


def _jax_kmers(path, k, rc, bb):
    return ReadKmers.hash_fasta_file(
        str(path), k, keep_on_device=True, include_reverse_complements=rc,
        block_bytes=bb).to_numpy()


@pytest.mark.parametrize("name", sorted(FILES))
@pytest.mark.parametrize("rc", [False, True])
@pytest.mark.parametrize("bb", [1, 64, 300, None])
def test_hash_fasta_file_matches_jax(tmp_path, name, rc, bb):
    k, text = FILES[name]
    path = tmp_path / name
    path.write_bytes(text)
    port = hash_fasta_file(str(path), k, device="cpu",
                           include_reverse_complements=rc, block_bytes=bb)
    assert np.array_equal(port.to_numpy(), _jax_kmers(path, k, rc, bb))
    assert len(port) == len(port.to_numpy())


def test_segments_cut_at_read_boundaries(tmp_path, monkeypatch):
    """Tape segments far below the file size (cut at read boundaries)
    give the same k-mers in the same order."""
    k, text = FILES["mix.fq"]
    path = tmp_path / "mix.fq"
    path.write_bytes(text)
    monkeypatch.setattr(torch_read_kmers, "SEGMENT_BASES", 10)
    stages = {}
    port = hash_fasta_file(str(path), k, device="cpu",
                           include_reverse_complements=True,
                           stage_seconds=stages)
    assert len(port.segments) > 2
    assert set(stages) == {"parse", "upload", "hash"}
    assert np.array_equal(port.to_numpy(), _jax_kmers(path, k, True, None))


def test_empty_file(tmp_path):
    path = tmp_path / "empty.fa"
    path.write_bytes(b">only_a_header\n\n")
    port = hash_fasta_file(str(path), 5, device="cpu",
                           include_reverse_complements=True)
    assert port.to_numpy().shape == (0,) and len(port) == 0
