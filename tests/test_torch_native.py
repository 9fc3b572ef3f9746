"""Port parity: the native host library of graph_kmer_index_tpu_torch
(csrc/host/*.cpp built by g++ at first use, loaded by native.py) against
the JAX package's graph_kmer_index_tpu.native on the same seeded inputs,
wrapper by wrapper, and read_kmers.encode_block by both of its parse
routes. Exact equality."""
from pathlib import Path

import jax  # noqa: F401  (same process set-up as the other port tests)
import numpy as np
import pytest
import torch  # noqa: F401

from graph_kmer_index_tpu import (CollisionFreeKmerIndex, CriticalGraphPaths,
                                  FlatKmers)
from graph_kmer_index_tpu import native as jax_native
from graph_kmer_index_tpu.finder import _dedup_span_nodes
from graph_kmer_index_tpu.ops.lookup import internal_modulo
from graph_kmer_index_tpu.utils.synthetic import random_snp_graph

from graph_kmer_index_tpu_torch import native, read_kmers

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", ["gki.cpp", "walker.cpp"])
def test_host_sources_are_byte_copies(name):
    copy = ROOT / "graph_kmer_index_tpu_torch" / "csrc" / "host" / name
    original = ROOT / "graph_kmer_index_tpu" / "native" / name
    assert copy.read_bytes() == original.read_bytes()


def test_library_builds_into_the_ports_build_directory():
    assert native.available() and native.build_error() is None
    path = Path(native.library_path())
    assert path.exists() and path.name.startswith("libgki_host_")
    assert path.parent == ROOT / "graph_kmer_index_tpu_torch" / "build"
    assert path == Path(native.library_path())
    # nothing half-built is left beside it
    assert not list(path.parent.glob("*.so.tmp"))


def test_a_failed_build_leaves_numpy_routes(monkeypatch):
    """get_lib's contract: no compiler, no library, every wrapper None;
    build_error says why."""
    monkeypatch.setattr(native, "_FLAGS", native._FLAGS + ["--no-such-flag"])
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_build_error", None)
    assert not native.available()
    assert "no-such-flag" in native.build_error()
    assert native.encode_ascii(b"ACGT") is None
    assert native.fasta_encode(b">r\nACGT\n") is None
    assert native.sliding_hashes(np.zeros(40, np.int8), 5) is None
    assert not Path(native.library_path()).exists()
    # the Python parse route serves encode_block then
    flat, starts, lens = read_kmers.encode_block(b">r\nACGT\nGG\n")
    assert flat.tolist() == [0, 1, 2, 3, 2, 2]
    assert starts.tolist() == [0, 4] and lens.tolist() == [4, 2]


def test_encode_ascii_and_sliding_hashes():
    rng = np.random.default_rng(0)
    text = bytes(rng.choice(np.frombuffer(b"ACGTacgtNnMx-", np.uint8), 5000))
    assert np.array_equal(native.encode_ascii(text),
                          jax_native.encode_ascii(text))
    seq = rng.integers(0, 4, 20000).astype(np.int8)
    for k in (1, 5, 16, 17, 31):
        got, want = (m.sliding_hashes(seq, k) for m in (native, jax_native))
        assert got.dtype == np.uint64 and np.array_equal(got, want)
    assert len(native.sliding_hashes(seq[:10], 31)) == 0
    with pytest.raises(ValueError):
        native.sliding_hashes(seq, 32)


def _index(modulo, seed=0, n=6000):
    rng = np.random.default_rng(seed)
    flat = FlatKmers(rng.integers(0, 2500, n).astype(np.uint64),
                     rng.integers(1, 400, n).astype(np.uint32),
                     rng.integers(0, 3000, n).astype(np.uint64),
                     rng.random(n).astype(np.single))
    index = CollisionFreeKmerIndex.from_flat_kmers(flat, modulo=modulo,
                                                   use_device=False)
    queries = np.concatenate([rng.integers(0, 2500, 3000),
                              rng.integers(2500, 1 << 40, 500)])
    return index, queries.astype(np.uint64)


@pytest.mark.parametrize("starts_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("modulo", [211, 4099])
def test_bucket_table_lookups(modulo, starts_dtype):
    index, q = _index(modulo)
    starts = np.asarray(index._hashes_to_index).astype(starts_dtype)
    tables = (index._kmers, index._nodes, index._ref_offsets,
              index._frequencies, index._allele_frequencies, starts,
              index._n_kmers, modulo)
    for caps in ({}, {"hit_cap": 40, "freq_cap": 2}):
        got = native.bucket_lookup(q, *tables, **caps)
        want = jax_native.bucket_lookup(q, *tables, **caps)
        assert got.shape[0] == 5 and got.shape[1] > 0
        assert np.array_equal(got, want)
    args = (q, index._kmers, index._nodes, starts, index._n_kmers, modulo,
            400)
    assert np.array_equal(native.map_kmers(*args),
                          jax_native.map_kmers(*args))
    args = (q, index._kmers, starts, index._n_kmers, modulo)
    got = native.has_kmers(*args)
    assert got.dtype == bool and got.any() and not got.all()
    assert np.array_equal(got, jax_native.has_kmers(*args))
    with pytest.raises(ValueError, match="modulo"):
        native.has_kmers(q, index._kmers, starts, index._n_kmers, 0)


def test_frequencies_bucket_ordered():
    index, _ = _index(997, seed=4)
    got = native.frequencies_bucket_ordered(index._kmers, index._ref_offsets,
                                            997)
    want = jax_native.frequencies_bucket_ordered(index._kmers,
                                                 index._ref_offsets, 997)
    assert got.dtype == np.uint16 and got.max() > 1
    assert np.array_equal(got, want)
    assert np.array_equal(got, index._frequencies)
    # rows that are not in bucket order are refused, not miscounted
    assert native.frequencies_bucket_ordered(index._kmers[::-1].copy(),
                                             index._ref_offsets, 997) is None


def test_packed_tables():
    index, q = _index(211, seed=2)
    modulo2 = internal_modulo(len(index._kmers))
    got = native.build_packed(index._kmers, index._nodes, modulo2)
    want = jax_native.build_packed(index._kmers, index._nodes, modulo2)
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    rec, rows_k, rows_n = got
    assert np.array_equal(
        native.packed_map_kmers(q, rec, rows_k, rows_n, modulo2, 400),
        jax_native.packed_map_kmers(q, rec, rows_k, rows_n, modulo2, 400))
    has = native.packed_has_kmers(q, rec, rows_k, modulo2)
    assert has.any() and not has.all()
    assert np.array_equal(has, jax_native.packed_has_kmers(q, rec, rows_k,
                                                           modulo2))


@pytest.mark.parametrize("seed", [1, 8])
def test_walk_and_finalize_rows(seed):
    """The span walker and the row expansion, chained as the finder chains
    them; the port's graph module is not involved (its parity has its own
    test), so both libraries walk one graph object."""
    k = 7
    graph, v2n = random_snp_graph(4000, 60, seed=seed, indel_fraction=0.3)
    cpaths = CriticalGraphPaths.from_graph(graph, k)
    seen = cpaths.reversed_points()
    crit = cpaths.dense_index(graph.n_nodes())
    spans = []
    for module in (native, jax_native):
        graph._native_walk_arrays = None
        spans.append(module.walk(graph, crit, k, 4, worklist=seen,
                                 seen_points=seen))
    for got, want in zip(*spans, strict=True):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    tape, ts, nw, s_node, s_off, nl, span_nodes = spans[0]
    assert len(ts) > 50
    for kwargs in ({}, {"only_save_one": True},
                   {"only_store_nodes": set(int(v) for v in
                                            v2n.var_nodes[:20])}):
        rows = [module.finalize_rows(tape, k, ts, nw, s_node, s_off, nl,
                                     span_nodes, graph.allele_frequencies,
                                     **kwargs)
                for module in (native, jax_native)]
        for got, want in zip(*rows, strict=True):
            assert got.dtype == want.dtype and np.array_equal(got, want)
        # and the row count is the spans' windows x deduped nodes
        dedup_nl = _dedup_span_nodes(nl, span_nodes,
                                     graph.allele_frequencies,
                                     kwargs.get("only_save_one", False),
                                     kwargs.get("only_store_nodes"))[0]
        assert len(rows[0][0]) == int((nw.astype(np.int64) * dedup_nl).sum())


_TEXTS = {
    "fasta": b">r1\nACGTACGT\n>r2 desc\nTTGCA\n",
    "multi_line_fasta": b">r1\nACGTAC\nGTTTGA\nCC\n>r2\nGATTACA\n",
    "fastq": b"@r1\nACTGACTGTC\n+\nIIIIIIIIII\n@r2\nCCCTACTGT\n+r2\n@@@>>>+++\n",
    "crlf": b">r1\r\nACGTNNAC\r\n>r2\r\nggcat\r\n",
    "blank_lines": b"\n>r1\n\nACGT\n\n\n>r2\nTT\n",
    "no_final_newline": b">r1\nACGT\n>r2\nGGA",
    "empty": b"",
    "headers_only": b">r1\n>r2\n",
}


@pytest.mark.parametrize("name", sorted(_TEXTS))
def test_encode_block_by_both_parse_routes(name):
    text = _TEXTS[name]
    want = jax_native.fasta_encode(text)
    routes = {"native": native.fasta_encode(text),
              "python": read_kmers.encode_block_plain(text),
              "default": read_kmers.encode_block(text)}
    for route, got in routes.items():
        for a, b in zip(got, want, strict=True):
            assert a.dtype == b.dtype, (route, a.dtype)
            assert np.array_equal(a, b), route
    flat, starts, lens = routes["default"]
    assert len(flat) == int(lens.sum())
    if name == "multi_line_fasta":
        assert lens.tolist() == [6, 6, 2, 7]


def test_encode_block_routes_on_random_reads():
    rng = np.random.default_rng(5)
    lines = []
    for i in range(300):
        read = "".join(rng.choice(list("ACGTacgtN"),
                                  size=int(rng.integers(1, 200))))
        lines += [f"@read{i}", read, "+", "I" * len(read)]
    text = ("\n".join(lines) + "\n").encode()
    got = read_kmers.encode_block(text)
    for a, b, c in zip(got, read_kmers.encode_block_plain(text),
                       jax_native.fasta_encode(text), strict=True):
        assert np.array_equal(a, b) and np.array_equal(a, c)
    assert len(got[1]) == 300
