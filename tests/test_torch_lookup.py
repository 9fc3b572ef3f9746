"""Port parity: the packed-record lookup of graph_kmer_index_tpu_torch
against the JAX package's ops.lookup and CollisionFreeKmerIndex, on the
CPU. Record tables must be bit-identical; counts and membership equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_kmer_index_tpu import CollisionFreeKmerIndex, FlatKmers
from graph_kmer_index_tpu.ops import lookup as jax_lookup
from graph_kmer_index_tpu_torch import KmerIndex
from graph_kmer_index_tpu_torch.ops import lookup as torch_lookup

torch.set_num_threads(2)


@pytest.mark.parametrize("n", [0, 1, 2, 33, 34, 1000, 123457])
def test_internal_modulo_matches_jax(n):
    assert torch_lookup.internal_modulo(n) == jax_lookup.internal_modulo(n)


def _table(kind):
    """(kmers u64, nodes u32, reference modulo) of one table class."""
    rng = np.random.default_rng(len(kind))
    if kind == "random":
        n = 3000
        kmers = rng.integers(0, 4 ** 31, n, dtype=np.uint64)
        nodes = rng.integers(1, 500, n).astype(np.uint32)
        return kmers, nodes, 1009
    if kind == "deep":  # small-int k-mers: buckets deeper than 2
        n = 3000
        kmers = rng.integers(0, 10000, n).astype(np.uint64)
        return kmers, rng.integers(1, 200, n).astype(np.uint32), 7
    if kind == "dup2":  # every bucket holds one k-mer twice, none deeper
        uniq = 4 * np.arange(40, dtype=np.uint64) + 1
        kmers = np.repeat(uniq, 2)
        nodes = (np.arange(len(kmers), dtype=np.uint32) % 37) + 1
        return kmers, nodes, 101
    if kind == "ultra":  # > SCAN_CAP copies of k-mer 0 (poly-A)
        n = 2000
        kmers = rng.integers(0, 4 ** 31, n, dtype=np.uint64)
        kmers[:300] = 0
        kmers[300:320] = 12345
        nodes = rng.integers(1, 300, n).astype(np.uint32)
        return kmers, nodes, 211
    if kind == "mixed":  # all three query classes in one table
        n = 3000
        kmers = rng.integers(0, 4 ** 31, n, dtype=np.uint64)
        kmers[:300] = 0                                   # ultra (poly-A)
        kmers[300:1300] = rng.integers(1, 400, 1000)      # deep buckets
        kmers[1300:1400] = np.repeat(                     # one k-mer twice
            rng.integers(4 ** 20, 4 ** 25, 50, dtype=np.uint64), 2)
        nodes = rng.integers(1, 300, n).astype(np.uint32)
        return kmers, nodes, 211
    raise ValueError(kind)


def _jax_index(kind):
    kmers, nodes, modulo = _table(kind)
    flat = FlatKmers(kmers, nodes, np.arange(len(kmers), dtype=np.uint64))
    return CollisionFreeKmerIndex.from_flat_kmers(flat, modulo=modulo)


@pytest.mark.parametrize("kind", ["random", "deep", "dup2", "ultra",
                                  "empty"])
def test_packed_records_bit_identical(kind):
    if kind == "empty":
        km, nd = np.zeros(0, np.uint64), np.zeros(0, np.int32)
    else:
        index = _jax_index(kind)
        km, nd = np.asarray(index._kmers), np.asarray(index._nodes)
    modulo2 = jax_lookup.internal_modulo(len(km))
    rec, ks, ns, max_sz, deep_frac = jax_lookup._build_packed(
        jnp.asarray(km, dtype=jnp.uint64), jnp.asarray(nd, dtype=jnp.int32),
        modulo2)
    port = torch_lookup.build_packed(
        torch.from_numpy(km.view(np.int64)),
        torch.from_numpy(nd.astype(np.int64)), modulo2)
    assert np.array_equal(port.records.reshape(-1).numpy().view(np.uint32),
                          np.asarray(rec).reshape(-1))
    assert np.array_equal(port.ks.numpy().view(np.uint64), np.asarray(ks))
    assert np.array_equal(port.ns.numpy(), np.asarray(ns).astype(np.int64))
    assert port.max_sz == int(max_sz)
    assert port.deep_frac == deep_frac
    if kind == "ultra":
        assert port.max_sz > torch_lookup.SCAN_CAP
    if kind == "dup2":
        assert port.max_sz == 2 and port.deep_frac > 0


def _queries(kind, kmers, modulo2, rng):
    hits = rng.choice(kmers, size=min(len(kmers), 700))
    misses = rng.integers(0, 4 ** 31, 300, dtype=np.uint64)
    # misses that land in the buckets of stored k-mers (deep, dup2 and
    # ultra buckets included)
    same_bucket = (rng.choice(kmers, 200)
                   + np.uint64(modulo2) * rng.integers(1, 1000, 200)
                   .astype(np.uint64))
    parts = [hits, misses, same_bucket]
    if kind == "ultra":
        parts.append(np.zeros(50, np.uint64))
    return np.concatenate(parts)


@pytest.mark.parametrize("kind,n_nodes", [
    ("random", None), ("deep", None), ("deep", 100), ("dup2", None),
    ("ultra", None)])
def test_map_and_has_kmers_match_jax(kind, n_nodes):
    index = _jax_index(kind)
    kmers = np.asarray(index._kmers)
    n_nodes = n_nodes or int(np.max(index._nodes)) + 1
    rng = np.random.default_rng(7)
    queries = _queries(kind, kmers,
                       torch_lookup.internal_modulo(len(kmers)), rng)
    port = KmerIndex.from_jax_state(index._kmers, index._nodes,
                                    index._modulo, device="cpu")
    expected = np.asarray(index.map_kmers(queries, n_nodes), dtype=np.int64)
    counts = port.map_kmers(queries, n_nodes)
    assert counts.dtype == np.int64 and counts.shape == (n_nodes,)
    assert np.array_equal(counts, expected)
    assert np.array_equal(port.has_kmers(queries),
                          np.asarray(index.has_kmers(queries)))


def test_from_file_reads_the_jax_npz(tmp_path):
    index = _jax_index("deep")
    path = str(tmp_path / "index")
    index.to_file(path)
    port = KmerIndex.from_file(path, device="cpu")
    assert port.modulo == index._modulo == 7
    assert np.array_equal(port.kmers.numpy().view(np.uint64),
                          np.asarray(index._kmers, dtype=np.uint64))
    assert np.array_equal(port.nodes.numpy(),
                          np.asarray(index._nodes).astype(np.int64))


def test_empty_index_counts_nothing():
    port = KmerIndex.from_arrays(np.zeros(0, np.uint64), np.zeros(0, np.int64),
                                 7, device="cpu")
    q = np.array([0, 5, 4 ** 31 - 1], dtype=np.uint64)
    assert np.array_equal(port.map_kmers(q, 4), np.zeros(4, np.int64))
    assert not port.has_kmers(q).any()


def test_padding_past_n_valid_is_ignored():
    """k-mer 0 is a real hash (poly-A): zero padding past n_valid must
    count nothing, in every query class."""
    kmers, nodes, _ = _table("ultra")
    t = torch_lookup.build_packed(torch.from_numpy(kmers.view(np.int64)),
                                  torch.from_numpy(nodes.astype(np.int64)),
                                  torch_lookup.internal_modulo(len(kmers)))
    q = torch.from_numpy(kmers[:500].view(np.int64))
    padded = torch.cat([q, torch.zeros(64, dtype=torch.int64)])
    for n_nodes in (None, 300):
        a, cls_a = torch_lookup.packed_decode_plain(
            t.records, q, len(q), t.modulo2, n_nodes)
        b, cls_b = torch_lookup.packed_decode_plain(
            t.records, padded, len(q), t.modulo2, n_nodes)
        assert torch.equal(cls_b[len(q):], torch.zeros(64, dtype=torch.uint8))
        assert torch.equal(cls_a, cls_b[:len(q)])
        if n_nodes is None:
            assert torch.equal(a, b[:len(q)]) and not b[len(q):].any()
        else:
            assert torch.equal(a, b)


def test_over_budget_raises(monkeypatch):
    """Records over the device's budget no longer raise: map and has fall
    back to the CSR bucket scan, as the JAX package's do, with its
    results."""
    index = _jax_index("random")
    port = KmerIndex.from_jax_state(
        index._kmers, index._nodes, index._modulo, device="cpu",
        hashes_to_index=index._hashes_to_index, n_kmers=index._n_kmers)
    monkeypatch.setattr(torch_lookup, "packed_byte_budget", lambda dev: 1024)
    queries = _queries("random", np.asarray(index._kmers), 1009,
                       np.random.default_rng(8))
    n_nodes = int(np.max(index._nodes)) + 1
    assert np.array_equal(port.map_kmers(queries, n_nodes), np.asarray(
        index.map_kmers(queries, n_nodes), dtype=np.int64))
    assert np.array_equal(port.has_kmers(queries),
                          np.asarray(index.has_kmers(queries)))
    assert port.device_index.packed() is None


def _packed_tables(index):
    port = KmerIndex.from_jax_state(index._kmers, index._nodes,
                                    index._modulo, device="cpu")
    return port.device_index.packed()


@pytest.mark.parametrize("fn", [torch_lookup.packed_lookup,
                                torch_lookup.packed_lookup_plain])
@pytest.mark.parametrize("kind,n_nodes,pad", [
    ("mixed", None, 0), ("mixed", None, 77), ("mixed", 40, 77),
    ("ultra", None, 5), ("deep", 100, 64), ("dup2", None, 3),
    ("random", None, 1)])
def test_packed_lookup_twin_matches_jax(fn, kind, n_nodes, pad):
    """K2's plain twin (which the wrapper takes for a CPU tensor) against
    the JAX package's map_kmers and has_kmers, exact: queries of every
    class, padding past n_valid (k-mer 0, a stored poly-A hash), and
    nodes >= n_nodes dropped."""
    index = _jax_index(kind)
    kmers = np.asarray(index._kmers)
    all_nodes = int(np.max(index._nodes)) + 1
    n_nodes = n_nodes or all_nodes
    t = _packed_tables(index)
    queries = _queries("ultra" if kind == "mixed" else kind, kmers,
                       t.modulo2, np.random.default_rng(11))
    n_valid = len(queries)
    q = torch.from_numpy(np.concatenate(
        [queries, np.zeros(pad, np.uint64)]).view(np.int64))
    if kind == "mixed":
        cls = torch_lookup.packed_decode_plain(t.records, q, n_valid,
                                               t.modulo2, n_nodes)[1]
        assert torch.bincount(cls.to(torch.int64), minlength=3).min() > 0
        assert not cls[n_valid:].any()
    counts = fn(t, q, n_valid, n_nodes)
    assert counts.dtype == torch.int64 and counts.shape == (n_nodes,)
    # dropped nodes: the counts of all nodes, cut (the JAX package's own
    # ultra resolution indexes past a shorter count array)
    assert np.array_equal(counts.numpy(), np.asarray(
        index.map_kmers(queries, all_nodes), dtype=np.int64)[:n_nodes])
    hit = fn(t, q, n_valid)
    assert hit.dtype == torch.bool and hit.shape == q.shape
    assert np.array_equal(hit[:n_valid].numpy(),
                          np.asarray(index.has_kmers(queries)))
    assert not hit[n_valid:].any()


@pytest.mark.parametrize("fn", [torch_lookup.packed_lookup,
                                torch_lookup.packed_lookup_plain])
def test_packed_lookup_of_an_empty_batch(fn):
    t = _packed_tables(_jax_index("mixed"))
    q = torch.zeros(0, dtype=torch.int64)
    assert torch.equal(fn(t, q, 0, 7), torch.zeros(7, dtype=torch.int64))
    assert fn(t, q, 0).shape == (0,) and fn(t, q, 0).dtype == torch.bool
    # a batch that is all padding counts nothing either
    pad = torch.zeros(9, dtype=torch.int64)
    assert not fn(t, pad, 0, 7).any() and not fn(t, pad, 0).any()


def test_packed_lookup_refuses_what_the_kernel_does_not_take():
    t = _packed_tables(_jax_index("random"))
    q = torch.zeros(4, dtype=torch.int64)
    # a tensor on neither the CPU nor a CUDA device gets no twin
    with pytest.raises(ValueError, match="CUDA"):
        torch_lookup.packed_lookup(t, q.to("meta"), 4)
    with pytest.raises(ValueError, match="CUDA"):
        torch_lookup.packed_lookup(t, q.to("meta"), 4, 10)
