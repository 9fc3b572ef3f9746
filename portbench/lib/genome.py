"""The benchmark's input generator: a linear reference with planted
repeats, bi-allelic variants at random positions on it, a haplotype of
one sample, and reads sampled from that haplotype, all from a seed, made
on a device in a few large calls.

The reference: uniform random bases, then ``repeat_fraction`` of them
copied over themselves in segments of ``repeat_length`` bases, then one
poly-A run of ``poly_a_length`` bases (the repeat model of the port's
``utils/synthetic.random_genome``: repeated k-mers, deep buckets).

The variants: ``n_variants`` of them at distinct random positions, with
no spacing imposed beyond one reference base between two of them (so
windows of k bases often hold several). ``indel_fraction`` of them are
indels, of which ``deletion_share`` delete 1 to ``max_indel`` reference
bases (an empty alternative allele) and the others insert 1 to
``max_indel`` bases (an empty reference allele); the rest are SNPs,
whose reference allele is the reference's base and whose alternative is
another base. Node ids follow a bubble chain: the segment before variant
``i`` is ``3i + 1``, its reference allele ``3i + 2`` and its alternative
``3i + 3``.

The same seed gives the same inputs on the same kind of device. This
module imports torch and numpy only: it is the yardstick's, and the
plain reference reads what it makes.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import torch

K = 31


def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for the named random stream of a run's seed: streams
    do not overlap, and any whole number is a valid seed."""
    digest = hashlib.sha256(f"{int(seed)}/{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, stream: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, stream))
    return g


@dataclass
class Genome:
    """A reference and its variants as tensors on one device.

    ``ref``: the reference's bases (int8 2-bit codes); per variant ``i``,
    in the order of their positions: ``pos`` (the first base of its
    reference allele, or for an insertion the base it is inserted before),
    ``ref_len`` and ``alt_len`` (bases of the two alleles) and
    ``alt_bases`` (n_variants, max_indel), the alternative's bases;
    ``poly_a``: the first base of the poly-A run."""
    ref: torch.Tensor
    pos: torch.Tensor
    ref_len: torch.Tensor
    alt_len: torch.Tensor
    alt_bases: torch.Tensor
    poly_a: int

    @property
    def n_variants(self) -> int:
        return int(self.pos.shape[0])

    @property
    def n_nodes(self) -> int:
        """Node ids run to 3 * n_variants + 1; node 0 is unused."""
        return 3 * self.n_variants + 2


def _plant_repeats(ref: torch.Tensor, config: dict, seed: int) -> int:
    """Copy ``repeat_fraction`` of ``ref`` over itself in segments, one
    after another, then write the poly-A run; returns its first base."""
    n = ref.shape[0]
    lo, hi = (int(x) for x in config["repeat_length"])
    poly = int(config["poly_a_length"])
    if n <= max(hi, poly) + 2 * K:
        raise ValueError("the reference is too short for its repeats")
    g = generator(seed, "repeats", "cpu")
    target = int(float(config["repeat_fraction"]) * n)
    most = target // lo + 1
    length = torch.randint(lo, hi + 1, (most,), generator=g)
    count = int(torch.searchsorted(torch.cumsum(length, 0),
                                   torch.tensor(target))) + 1
    count = min(count, most) if target else 0
    src = (torch.rand(count, generator=g, dtype=torch.float64)
           * (n - length[:count])).to(torch.int64)
    dst = (torch.rand(count, generator=g, dtype=torch.float64)
           * (n - length[:count])).to(torch.int64)
    for s, d, m in zip(src.tolist(), dst.tolist(), length[:count].tolist()):
        ref[d:d + m] = ref[s:s + m].clone()
    start = int(torch.randint(0, n - poly, (1,), generator=g))
    ref[start:start + poly] = 0
    return start


def make_genome(config: dict, seed: int, device) -> Genome:
    """The configuration's reference and variants."""
    n = int(config["ref_bases"])
    n_var = int(config["n_variants"])
    max_indel = int(config["max_indel"])
    g = generator(seed, "genome", device)
    ref = torch.randint(0, 4, (n,), dtype=torch.int8, device=device,
                        generator=g)
    poly_a = _plant_repeats(ref, config, seed)
    is_indel = (torch.rand(n_var, device=device, generator=g)
                < float(config["indel_fraction"]))
    is_del = is_indel & (torch.rand(n_var, device=device, generator=g)
                         < float(config["deletion_share"]))
    is_ins = is_indel & ~is_del
    length = torch.randint(1, max_indel + 1, (n_var,), device=device,
                           generator=g)
    ref_len = torch.where(is_del, length, torch.where(is_ins, 0, 1))
    alt_len = torch.where(is_ins, length, torch.where(is_del, 0, 1))
    # distinct positions: sorted free draws plus what each variant before
    # needs (its reference allele and one base of segment after it)
    need = ref_len + 1
    free = n - 2 * K - int(need.sum())
    if free < 0:
        raise ValueError("too many variants for the reference")
    draws = torch.sort(torch.randint(0, free + 1, (n_var,), device=device,
                                     generator=g)).values
    pos = K + draws + torch.cumsum(need, 0) - need
    del draws, need
    shift = torch.randint(1, 4, (n_var,), device=device, generator=g)
    ins = torch.randint(0, 4, (n_var, max_indel), dtype=torch.int8,
                        device=device, generator=g)
    snp_alt = ((ref[pos].to(torch.int64) + shift) % 4).to(torch.int8)
    alt_bases = torch.where((alt_len == 1)[:, None] & ~is_ins[:, None],
                            snp_alt[:, None], ins)
    alt_bases = torch.where(torch.arange(max_indel, device=device)[None, :]
                            < alt_len[:, None], alt_bases, 0).to(torch.int8)
    return Genome(ref, pos, ref_len, alt_len, alt_bases, poly_a)


def signature_windows(genome: Genome, block: int = 1 << 22) -> torch.Tensor:
    """(2 * n_var, K) bases: for every allele node, in node order (the
    reference allele of variant i, then its alternative), the K-base
    window of the reference with that allele in place, centred on the
    allele: (K - len) // 2 reference bases before it, the allele, then the
    reference bases after the variant's reference allele."""
    n_var = genome.n_variants
    dev = genome.ref.device
    out = torch.empty((2 * n_var, K), dtype=torch.int8, device=dev)
    j = torch.arange(K, device=dev)
    width = genome.alt_bases.shape[1]
    for lo in range(0, 2 * n_var, block):
        row = torch.arange(lo, min(2 * n_var, lo + block), device=dev)
        var, alt = row // 2, (row % 2).bool()
        rl = genome.ref_len[var]
        length = torch.where(alt, genome.alt_len[var], rl)
        rel = j[None, :] - ((K - length) // 2)[:, None]  # from the allele
        p = genome.pos[var][:, None]
        ref_idx = torch.where(rel < length[:, None], p + rel,
                              p + rl[:, None] + rel - length[:, None])
        bases = genome.ref[ref_idx]
        use_alt = alt[:, None] & (rel >= 0) & (rel < length[:, None])
        alt_b = genome.alt_bases[var[:, None], rel.clamp(0, width - 1)]
        out[lo:lo + row.shape[0]] = torch.where(use_alt, alt_b, bases)
    return out


def haplotype(genome: Genome, carries_alt: torch.Tensor,
              block: int = 1 << 28) -> tuple[torch.Tensor, int]:
    """(bases, first base of the poly-A run in them) of the haplotype
    that carries the alternative allele at the variants where
    ``carries_alt`` is true and the reference elsewhere, built block by
    block of the reference."""
    ref = genome.ref
    dev = ref.device
    n = ref.shape[0]
    v = torch.nonzero(carries_alt).flatten()
    pos, rl, al = genome.pos[v], genome.ref_len[v], genome.alt_len[v]
    removed = torch.zeros(n, dtype=torch.bool, device=dev)
    for j in range(genome.alt_bases.shape[1]):
        removed[pos[rl > j] + j] = True
    # the alternative's bases go before the first base after the allele
    anchor = pos + rl
    hap = torch.empty(n - int(rl.sum()) + int(al.sum()), dtype=torch.int8,
                      device=dev)
    done = 0  # haplotype bases before the block
    poly_a = None
    for lo in range(0, n, block):
        hi = min(n, lo + block)
        kept = ~removed[lo:hi]
        a0, a1 = (int(x) for x in torch.searchsorted(
            anchor, torch.tensor([lo, hi], device=dev)))
        at = anchor[a0:a1] - lo
        ins = torch.zeros(hi - lo, dtype=torch.int64, device=dev)
        ins.index_add_(0, at, al[a0:a1])
        ins_cum = torch.cumsum(ins, 0)
        kept_before = torch.cumsum(kept, 0) - kept.to(torch.int64)
        out = done + kept_before + ins_cum
        hap[out[kept]] = ref[lo:hi][kept]
        base = done + kept_before[at] + ins_cum[at] - al[a0:a1]
        for j in range(genome.alt_bases.shape[1]):
            m = al[a0:a1] > j
            hap[base[m] + j] = genome.alt_bases[v[a0:a1][m], j]
        if lo <= genome.poly_a < hi:
            poly_a = int(out[genome.poly_a - lo])
        done += int(kept.sum()) + int(ins.sum())
        del kept, ins, ins_cum, kept_before, out
    return hap, poly_a


def sample_haplotype(genome: Genome, traffic: dict, seed: int):
    """The sequenced sample's haplotype: each variant's alternative drawn
    with ``alt_allele_share``."""
    g = generator(seed, "haplotype", genome.ref.device)
    carries = (torch.rand(genome.n_variants, device=genome.ref.device,
                          generator=g) < float(traffic["alt_allele_share"]))
    return haplotype(genome, carries)


def sample_reads(hap: torch.Tensor, poly_a: int, traffic: dict,
                 n_reads: int, g: torch.Generator,
                 poly_a_length: int, block: int = 1 << 18) -> torch.Tensor:
    """(n_reads, read_length) int8 reads of a haplotype: start positions
    uniform over it, except ``poly_a_read_share`` of them, which overlap
    the poly-A run; ``substitution_rate`` of the bases substituted by
    another base, and ``reverse_share`` of the reads reverse-complemented
    (sequenced from the other strand)."""
    dev = hap.device
    length = int(traffic["read_length"])
    n = hap.shape[0]
    start = (torch.rand(n_reads, device=dev, generator=g, dtype=torch.float64)
             * (n - length + 1)).to(torch.int64)
    n_pa = int(float(traffic["poly_a_read_share"]) * n_reads)
    lo = max(0, poly_a - length + 1)
    hi = min(n - length, poly_a + poly_a_length - 1)
    start[:n_pa] = lo + (torch.rand(n_pa, device=dev, generator=g,
                                    dtype=torch.float64)
                         * (hi - lo + 1)).to(torch.int64)
    offsets = torch.arange(length, device=dev)
    reads = torch.empty((n_reads, length), dtype=torch.int8, device=dev)
    for i in range(0, n_reads, block):
        reads[i:i + block] = hap[start[i:i + block, None] + offsets]
    sub = (torch.rand(reads.shape, device=dev, generator=g)
           < float(traffic["substitution_rate"]))
    shift = torch.randint(1, 4, reads.shape, device=dev, generator=g,
                          dtype=torch.int8)
    reads = torch.where(sub, (reads + shift) % 4, reads)
    del sub, shift
    flip = (torch.rand(n_reads, device=dev, generator=g)
            < float(traffic["reverse_share"]))
    reads[flip] = (3 - reads[flip]).flip(1)
    return reads


ASCII = np.frombuffer(b"ACGT", dtype=np.uint8)


def write_fasta(path, reads: np.ndarray) -> int:
    """Reads (2-bit codes) as FASTA, one ``>r`` header and one sequence
    line a read; returns the file's bytes."""
    header = np.frombuffer(b">r\n", dtype=np.uint8)
    n, length = reads.shape
    lines = np.empty((n, len(header) + length + 1), dtype=np.uint8)
    lines[:, :len(header)] = header
    lines[:, len(header):-1] = ASCII[reads]
    lines[:, -1] = ord("\n")
    lines.tofile(path)
    return lines.size
