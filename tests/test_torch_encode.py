"""Port parity: graph_kmer_index_tpu_torch.ops.encode against the JAX
package's ops.encode, on the CPU (the port's kernels run their plain
twins there). Every comparison is exact: the outputs are integers."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_kmer_index_tpu import hashing as jax_hashing
from graph_kmer_index_tpu.ops import encode as jax_encode
from graph_kmer_index_tpu_torch import hashing as torch_hashing
from graph_kmer_index_tpu_torch.ops import encode as torch_encode

torch.set_num_threads(2)

KS = (1, 4, 5, 15, 16, 17, 30, 31)


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def _combine(lo, hi) -> np.ndarray:
    return (np.asarray(lo).astype(np.uint64)
            | (np.asarray(hi).astype(np.uint64) << np.uint64(32)))


@pytest.mark.parametrize("k", KS)
def test_sliding_hashes_match_jax(k):
    rng = np.random.default_rng(k)
    for n in sorted({1, max(1, k - 1), 4099}):
        seq = rng.integers(0, 4, n).astype(np.int8)
        port = _u64(torch_encode.sliding_hashes(torch.from_numpy(seq), k))
        xla = np.asarray(jax_encode.sliding_hashes(jnp.asarray(seq), k))
        pallas = _combine(*jax_encode.sliding_hashes_pallas(
            jnp.asarray(seq), k, interpret=True))
        assert np.array_equal(port, xla), (k, n)
        assert np.array_equal(port, pallas), (k, n)


def test_sliding_hashes_empty_and_bad_k():
    out = torch_encode.sliding_hashes(torch.zeros(0, dtype=torch.int8), 5)
    assert out.shape == (0,) and out.dtype == torch.int64
    for k in (0, 32):
        with pytest.raises(ValueError):
            torch_encode.sliding_hashes(torch.zeros(4, dtype=torch.int8), k)


def test_encode_ascii_matches_jax():
    raw = np.frombuffer(b"ACGTacgtNnMm", dtype=np.uint8)
    port = torch_encode.encode_ascii(torch.from_numpy(raw.copy())).numpy()
    xla = np.asarray(jax_encode.encode_ascii(jnp.asarray(raw)))
    assert np.array_equal(port.astype(np.int64), xla.astype(np.int64))


@pytest.mark.parametrize("k", (1, 16, 31))
def test_revcomp_hashes_match_jax(k):
    rng = np.random.default_rng(100 + k)
    h = rng.integers(0, 4 ** k, 2000, dtype=np.uint64)
    h[:2] = [0, 4 ** k - 1]
    port = _u64(torch_encode.revcomp_hashes(
        torch.from_numpy(h.view(np.int64)), k))
    xla = np.asarray(jax_encode.revcomp_hashes(jnp.asarray(h), k))
    assert np.array_equal(port, xla)


def _tape(rng, read_lens, pad_reads, pad_bases):
    """A read tape with ladder-style padding: pad rows (start=N, len=0)
    and zero bases past the real tape."""
    lens = np.asarray(read_lens, dtype=np.int32)
    starts = (np.cumsum(lens) - lens).astype(np.int32)
    n_real = int(lens.sum())
    n = n_real + pad_bases
    flat = np.zeros(n, np.int8)
    flat[:n_real] = rng.integers(0, 4, n_real)
    sp = np.concatenate([starts, np.full(pad_reads, n, np.int32)])
    lp = np.concatenate([lens, np.zeros(pad_reads, np.int32)])
    return flat, sp, lp, n_real


@pytest.mark.parametrize("k", (1, 5, 17, 31))
@pytest.mark.parametrize("case", ("mixed", "n_real_cut", "no_pad"))
def test_read_tape_hashes_match_jax(k, case):
    rng = np.random.default_rng(k * 7 + len(case))
    # empty reads, reads shorter than k, exactly k, and long ones
    read_lens = [0, 3, max(0, k - 1), k, 50, 0, 200, k + 1, 1]
    flat, sp, lp, n_real = _tape(rng, read_lens,
                                 pad_reads=0 if case == "no_pad" else 7,
                                 pad_bases=0 if case == "no_pad" else 37)
    if case == "n_real_cut":
        n_real -= 60  # the tape's real end cuts through the last reads
    hs, nv = jax_encode.read_tape_hashes(
        jnp.asarray(flat), jnp.asarray(sp), jnp.asarray(lp), n_real, k)
    nv = int(nv)
    port, port_nv = torch_encode.read_tape_hashes(
        torch.from_numpy(flat), torch.from_numpy(sp), torch.from_numpy(lp),
        n_real, k)
    assert port_nv == nv
    assert np.array_equal(_u64(port), np.asarray(hs)[:nv])


@pytest.mark.parametrize("k", (1, 16, 31))
def test_host_hashing_matches_jax(k):
    """The port's own numpy host helpers (it cannot import the JAX
    package's on the card) against graph_kmer_index_tpu.hashing."""
    rng = np.random.default_rng(200 + k)
    text = "".join(rng.choice(list("ACGTacgtNnM"), size=300))
    assert np.array_equal(
        torch_hashing.letter_sequence_to_numeric(text).astype(np.uint64),
        jax_hashing.letter_sequence_to_numeric(text))
    assert (torch_hashing.sequence_to_kmer_hash(text[:k])
            == jax_hashing.sequence_to_kmer_hash(text[:k]))
    codes = jax_hashing.letter_sequence_to_numeric(text)
    for n in (k - 1, k, 300):
        assert np.array_equal(
            torch_hashing.sliding_window_hashes(codes[:n], k),
            jax_hashing.sliding_window_hashes(codes[:n], k))
    h = rng.integers(0, 4 ** k, 500, dtype=np.uint64)
    assert np.array_equal(
        torch_hashing.kmer_hashes_to_reverse_complement_hash(h, k),
        jax_hashing.kmer_hashes_to_reverse_complement_hash(h, k))
