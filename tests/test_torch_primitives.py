"""The port's bandwidth controls (graph_kmer_index_tpu_torch.ops.primitives)
on the CPU, where the wrappers run their plain twins. The Pallas bodies
they replace are closures inside the rate functions of
benchmarks/bench_primitives.py, so the kernels' stated semantics are the
reference here: a copy is exact, a block sum is held against a float64
sum at relative 1e-4 (the bound of the JAX benchmark's own self-check).
Sizes are the benchmark's small ones: 2^10 x 128 rows, blocks of 128."""
import re
from pathlib import Path

import jax  # noqa: F401  (same process set-up as the other port tests)
import numpy as np
import pytest
import torch

from graph_kmer_index_tpu_torch.ops import primitives

torch.set_num_threads(2)

ROWS, BLOCK = 1 << 10, 1 << 7


def _table(seed=0):
    return np.random.default_rng(seed).random(
        (ROWS, primitives.STREAM_COLS)).astype(np.float32)


@pytest.mark.parametrize("fn", (primitives.stream_copy,
                                primitives.stream_copy_plain))
def test_stream_copy_is_exact(fn):
    table = _table()
    out = fn(torch.from_numpy(table))
    assert out.dtype == torch.float32
    assert np.array_equal(out.numpy(), table)
    # a copy, not a view
    assert out.data_ptr() != torch.from_numpy(table).data_ptr()


_TILE_WORDS = primitives.COPY_TILE_BYTES // 16


@pytest.mark.parametrize("shape", [
    (0, 4), (1, 4), (5, 4), (_TILE_WORDS - 1, 4), (_TILE_WORDS, 4),
    (_TILE_WORDS + 1, 4), (3 * _TILE_WORDS + 37, 4), (7, 128), (1000, 12)])
def test_stream_copy_of_any_length(shape):
    """Tables shorter than one tile of K4, of whole tiles, and ending in a
    ragged tile: the wrapper takes each and the copy is exact."""
    table = np.random.default_rng(shape[0]).random(shape).astype(np.float32)
    assert (table.nbytes % primitives.COPY_TILE_BYTES == 0) == (
        shape[0] in (0, _TILE_WORDS))
    out = primitives.stream_copy(torch.from_numpy(table))
    assert out.shape == shape and out.dtype == torch.float32
    assert np.array_equal(out.numpy(), table)


def test_stream_copy_tile_is_the_sources():
    """COPY_TILE_BYTES is the tile that csrc/stream.cu compiles in."""
    source = (Path(primitives.__file__).resolve().parents[1] / "csrc"
              / "stream.cu").read_text()
    tile = re.search(r"constexpr int kTileBytes = (\d+);", source)
    assert int(tile.group(1)) == primitives.COPY_TILE_BYTES
    assert primitives.COPY_TILE_BYTES % 16 == 0


@pytest.mark.parametrize("fn", (primitives.stream_sum,
                                primitives.stream_sum_plain))
def test_stream_sum_matches_float64(fn):
    table = _table(1)
    seed = np.random.default_rng(2).integers(1, 100, 1024).astype(np.int32)
    got = fn(torch.from_numpy(table), torch.from_numpy(seed), BLOCK)
    assert got.dtype == torch.float32 and got.shape == (ROWS // BLOCK,)
    want = (table.astype(np.float64).reshape(ROWS // BLOCK, -1).sum(1)
            + float(seed[0]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)
    # the JAX benchmark's own check: the block sums reduce to the table's
    total = float(got.numpy().astype(np.float64).sum())
    assert total == pytest.approx(
        float(table.astype(np.float64).sum()) + len(want) * float(seed[0]),
        rel=1e-4)


def test_stream_sum_default_blocks():
    table = torch.ones((2 * primitives.BLOCK_ROWS, 4))
    got = primitives.stream_sum(table, torch.tensor([3], dtype=torch.int32))
    assert got.tolist() == [4 * primitives.BLOCK_ROWS + 3.0] * 2


def test_stream_wrappers_refuse_what_the_kernels_do_not_take():
    table = torch.from_numpy(_table())
    seed = torch.ones(4, dtype=torch.int32)
    # a tensor on neither the CPU nor a CUDA device gets no twin
    with pytest.raises(ValueError, match="CUDA"):
        primitives.stream_copy(table.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        primitives.stream_sum(table.to("meta"), seed.to("meta"), BLOCK)
    for fn in (primitives.stream_copy,
               lambda t: primitives.stream_sum(t, seed, BLOCK)):
        with pytest.raises(TypeError):
            fn(table.double())
        with pytest.raises(ValueError, match="contiguous"):
            fn(table.t())
        with pytest.raises(ValueError, match="dims"):
            fn(table.flatten())
        with pytest.raises(ValueError, match="16-byte"):
            fn(table[:, :6].contiguous())
    with pytest.raises(ValueError, match="does not divide"):
        primitives.stream_sum(table, seed, 3)
    with pytest.raises(ValueError, match="does not divide"):
        primitives.stream_sum_plain(table, seed, 0)
    with pytest.raises(TypeError):
        primitives.stream_sum(table, seed.to(torch.int64), BLOCK)
    with pytest.raises(ValueError, match="seed"):
        primitives.stream_sum(table, seed[:0], BLOCK)
