"""The plain reference against the port's plain CPU twins on a tiny
reference and a tiny read set: the signature index against
``KmerIndex.from_flat_kmers``, the read hashes against
``hash_fasta_file`` and ``read_tape_hashes``, and the node counts against
``map_kmers``, by device tensors and by host arrays."""
import numpy as np
import pytest
import torch

from portbench.lib import checks, genome as gen, reference
from portbench.tests import tiny

CFG = tiny.config("wg_signature")
TRAFFIC = tiny.traffic("map_fasta")
MODULO = 1009


def reads_of(seed, n=300):
    g = gen.make_genome(CFG, seed, "cpu")
    hap, poly_a = gen.sample_haplotype(g, TRAFFIC, seed)
    return g, gen.sample_reads(hap, poly_a, TRAFFIC, n,
                               gen.generator(seed, "r", "cpu"), 400)


def port_index(g):
    from graph_kmer_index_tpu_torch.flat_kmers import FlatKmers
    from graph_kmer_index_tpu_torch.models.kmer_index import KmerIndex

    rows = reference.signature_rows(gen.signature_windows(g), g.pos)
    flat = FlatKmers(rows[0].numpy().view(np.uint64), rows[1].numpy(),
                     rows[2].numpy())
    return rows, KmerIndex.from_flat_kmers(flat, MODULO, device="cpu")


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 5])
def test_signature_index_equals_from_flat_kmers(seed):
    g = gen.make_genome(CFG, seed, "cpu")
    rows, index = port_index(g)
    found = dict((n, v) for n, v, _ in checks.index_checks(
        index, rows, MODULO, torch.device("cpu")))
    assert found == {"index_rows": 0, "index_frequencies": 0,
                     "index_layout": 0}
    # the planted repeats give k-mers of more than one offset
    assert int(index.frequencies.max()) > 1


def test_frequencies_count_distinct_offsets():
    km = torch.tensor([5, 5, 5, 7, 9, 9])
    ro = torch.tensor([1, 1, 2, 3, 4, 4])
    assert reference.frequencies(km, ro).tolist() == [2, 2, 2, 1, 1, 1]
    assert reference.frequencies(km, ro, distinct=False).tolist() == \
        [3, 3, 3, 1, 2, 2]


def test_read_hashes_equal_hash_fasta_file(tmp_path):
    from graph_kmer_index_tpu_torch.read_kmers import hash_fasta_file

    _, reads = reads_of(8)
    path = tmp_path / "r.fa"
    gen.write_fasta(path, reads.numpy())
    got = hash_fasta_file(str(path), 31, device="cpu",
                          include_reverse_complements=True)
    assert torch.equal(torch.cat(got.segments), reference.batch_hashes(reads))


def test_read_hashes_equal_read_tape_hashes():
    from graph_kmer_index_tpu_torch.ops.encode import (read_tape_hashes,
                                                       revcomp_hashes)

    _, reads = reads_of(9)
    tape = reads.reshape(-1)
    fw, _ = read_tape_hashes(tape, torch.arange(300) * 150,
                             torch.full((300,), 150), tape.shape[0], 31)
    assert torch.equal(torch.cat([fw, revcomp_hashes(fw, 31)]),
                       reference.batch_hashes(reads, block=64))


@pytest.mark.parametrize("host", [False, True])
def test_node_counts_equal_map_kmers(host):
    g, reads = reads_of(10, 400)
    rows, index = port_index(g)
    queries = reference.batch_hashes(reads)
    want = reference.node_counts(rows[0], rows[1], queries, g.n_nodes)
    assert int(want.sum()) > 0
    q = queries.numpy().view(np.uint64) if host else queries
    got = index.map_kmers(q, g.n_nodes)
    assert np.array_equal(got, want.numpy())
