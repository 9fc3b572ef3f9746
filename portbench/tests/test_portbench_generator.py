"""The generator: deterministic in the seed, the variants' and the
haplotype's shape, and the signature windows."""
import pytest
import torch

from portbench.lib import genome as gen
from portbench.tests import tiny

CFG = tiny.config("wg_signature")
TRAFFIC = tiny.traffic("map_fasta")


def test_same_seed_same_inputs():
    seed = 2 ** 31 + 99
    a, b = gen.make_genome(CFG, seed, "cpu"), gen.make_genome(CFG, seed, "cpu")
    for x, y in zip(vars(a).values(), vars(b).values()):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))
    ha, pa = gen.sample_haplotype(a, TRAFFIC, seed)
    hb, pb = gen.sample_haplotype(b, TRAFFIC, seed)
    assert torch.equal(ha, hb) and pa == pb
    ra = gen.sample_reads(ha, pa, TRAFFIC, 500,
                          gen.generator(seed, "reads/0", "cpu"), 400)
    rb = gen.sample_reads(hb, pb, TRAFFIC, 500,
                          gen.generator(seed, "reads/0", "cpu"), 400)
    assert torch.equal(ra, rb)


def test_other_seed_other_inputs():
    a, b = gen.make_genome(CFG, 1, "cpu"), gen.make_genome(CFG, 2, "cpu")
    assert not torch.equal(a.ref, b.ref)
    assert gen.sub_seed(1, "reads/0") != gen.sub_seed(1, "reads/1")


def test_variants_shape():
    g = gen.make_genome(CFG, 3, "cpu")
    assert g.n_variants == tiny.N_VARIANTS
    assert g.n_nodes == 3 * tiny.N_VARIANTS + 2
    # distinct positions, one reference base at least between two
    # variants, and room for a window at both ends
    assert torch.all(g.pos[1:] >= g.pos[:-1] + g.ref_len[:-1] + 1)
    assert int(g.pos[0]) >= 31
    assert int(g.pos[-1] + g.ref_len[-1]) <= CFG["ref_bases"] - 31
    # close variants exist: windows of 31 bases that hold several
    assert int((g.pos[1:] - g.pos[:-1] < 31).sum()) > tiny.N_VARIANTS // 4
    snp = (g.ref_len == 1) & (g.alt_len == 1)
    assert torch.all(g.alt_bases[snp, 0] != g.ref[g.pos[snp]])
    ins, dele = g.ref_len == 0, g.alt_len == 0
    assert torch.all((g.alt_len[ins] >= 1) & (g.alt_len[ins] <= 4))
    assert torch.all((g.ref_len[dele] >= 1) & (g.ref_len[dele] <= 4))
    assert int(ins.sum()) > 0 and int(dele.sum()) > 0
    assert abs(int((ins | dele).sum()) / g.n_variants - 0.0408) < 0.02


def test_repeats_planted():
    g = gen.make_genome(CFG, 4, "cpu")
    assert torch.all(g.ref[g.poly_a:g.poly_a + 400] == 0)
    # the copied segments repeat 31-mers of the random bases
    w = g.ref.unfold(0, 31, 1).to(torch.int64)
    h = (w << (2 * torch.arange(31))).sum(1)
    repeated = h.shape[0] - torch.unique(h).shape[0]
    assert repeated >= 1000 - 31 + 399


def haplotype_by_hand(g, carries):
    out, at = [], 0
    for i in range(g.n_variants):
        p = int(g.pos[i])
        out.append(g.ref[at:p])
        if carries[i]:
            out.append(g.alt_bases[i, :int(g.alt_len[i])])
        else:
            out.append(g.ref[p:p + int(g.ref_len[i])])
        at = p + int(g.ref_len[i])
    out.append(g.ref[at:])
    return torch.cat(out)


@pytest.mark.parametrize("block", [1 << 28, 977])
def test_haplotype_by_hand(block):
    g = gen.make_genome(CFG, 5, "cpu")
    carries = torch.rand(g.n_variants,
                         generator=gen.generator(5, "c", "cpu")) < 0.5
    hap, poly_a = gen.haplotype(g, carries, block=block)
    want = haplotype_by_hand(g, carries)
    assert torch.equal(hap, want)
    assert int((hap[poly_a:poly_a + 400] == 0).sum()) >= 300


def test_reads_come_from_the_haplotype():
    """With no substitutions and no reverse strand, every read is a
    stretch of the haplotype, and 1% of them overlap the poly-A run."""
    g = gen.make_genome(CFG, 6, "cpu")
    hap, poly_a = gen.sample_haplotype(g, TRAFFIC, 6)
    t = dict(TRAFFIC, substitution_rate=0.0, reverse_share=0.0)
    reads = gen.sample_reads(hap, poly_a, t, 300,
                             gen.generator(6, "r", "cpu"), 400)
    whole = hap.numpy().tobytes()
    for r in reads.numpy():
        assert r.tobytes() in whole
    for r in reads[:3].numpy():
        assert poly_a - 150 < whole.find(r.tobytes()) < poly_a + 400


def test_signature_windows_centred():
    g = gen.make_genome(CFG, 7, "cpu")
    w = gen.signature_windows(g, block=37)
    assert w.shape == (2 * g.n_variants, 31)
    for row in (0, 1, 17, 2 * g.n_variants - 1,
                *range(2 * int(torch.nonzero(g.alt_len == 0)[0]), 2 * int(
                    torch.nonzero(g.alt_len == 0)[0]) + 2),
                *range(2 * int(torch.nonzero(g.ref_len == 0)[0]), 2 * int(
                    torch.nonzero(g.ref_len == 0)[0]) + 2)):
        i, alt = row // 2, row % 2
        p, rl = int(g.pos[i]), int(g.ref_len[i])
        allele = g.alt_bases[i, :int(g.alt_len[i])] if alt else g.ref[p:p + rl]
        before = (31 - allele.shape[0]) // 2
        after = 31 - before - allele.shape[0]
        want = torch.cat([g.ref[p - before:p], allele,
                          g.ref[p + rl:p + rl + after]])
        assert torch.equal(w[row], want), row


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 1, 2 ** 40])
def test_large_seeds(seed):
    g = gen.make_genome(CFG, seed, "cpu")
    assert g.ref.shape[0] == tiny.REF_BASES
