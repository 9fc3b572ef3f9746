"""Chip-scale synthetic data, all from one seed: a random genome with
planted repeats and reads sampled from it with substitutions, written as
FASTA (the read-mapping path); and the JAX package's synthetic SNP/indel
pangenome graph (``random_snp_graph``: the same rng calls in the same
order, so a seed gives the same graph in both packages), which the build
path indexes, and that graph as a reference sequence with VCF variants
(``reference_and_variants``), from which the signature path builds it
again."""
from __future__ import annotations

import numpy as np

from ..graph import Graph, VariantToNodes
from ..hashing import numeric_to_letter_sequence
from ..variants import VcfVariant, VcfVariants

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


def random_snp_graph(n_ref_bases: int = 100000, n_variants: int = 1000,
                     seed: int = 0, indel_fraction: float = 0.0):
    """(Graph, VariantToNodes): evenly spaced bi-allelic variants.

    Each variant: ref segment ... -> (ref_allele | alt_allele) -> ...
    Indels (when ``indel_fraction``>0) use an empty ref-allele node
    (the dummy-node case, reference kmer_finder.py:261-266).
    """
    rng = np.random.default_rng(seed)
    bases = "acgt"
    spacing = max(2, n_ref_bases // max(1, n_variants))

    node_seqs = {}
    edges = {}
    linear_ref = []
    ref_nodes_v, var_nodes_v = [], []

    nid = 1
    prev_tails = []

    def link(frm_list, to):
        for f in frm_list:
            edges.setdefault(f, []).append(to)

    pos = 0
    while pos < n_ref_bases:
        seg_len = min(spacing, n_ref_bases - pos)
        seg = "".join(rng.choice(list(bases), size=seg_len))
        node_seqs[nid] = seg
        link(prev_tails, nid)
        linear_ref.append(nid)
        seg_node = nid
        nid += 1
        pos += seg_len
        if pos >= n_ref_bases or len(ref_nodes_v) >= n_variants:
            prev_tails = [seg_node]
            continue
        is_indel = rng.random() < indel_fraction
        if is_indel:
            ref_allele, var_allele = nid, nid + 1
            node_seqs[ref_allele] = ""
            node_seqs[var_allele] = "".join(
                rng.choice(list(bases), size=int(rng.integers(1, 5))))
        else:
            ref_allele, var_allele = nid, nid + 1
            b = int(rng.integers(0, 4))
            node_seqs[ref_allele] = bases[b]
            node_seqs[var_allele] = bases[(b + 1 + int(rng.integers(0, 3))) % 4]
        nid += 2
        edges[seg_node] = [ref_allele, var_allele]
        linear_ref.append(ref_allele)
        ref_nodes_v.append(ref_allele)
        var_nodes_v.append(var_allele)
        prev_tails = [ref_allele, var_allele]

    graph = Graph.from_dicts(node_seqs, edges, linear_ref)
    v2n = VariantToNodes(np.array(ref_nodes_v, dtype=np.int32),
                         np.array(var_nodes_v, dtype=np.int32))
    return graph, v2n


def reference_and_variants(graph: Graph, variant_to_nodes: VariantToNodes,
                           chromosome: str = "1"):
    """(reference string, VcfVariants) that describe a graph of
    :func:`random_snp_graph`: its linear reference, and per variant a VCF
    record as a variant caller would write it. A SNP is REF base -> ALT
    base at its 1-based position; an insertion (empty ref-allele node) is
    anchored on the base before it, REF = anchor, ALT = anchor + inserted
    bases. ``build_graph_from_vcf`` over the two gives the same graph
    again, node for node."""
    _, _, refseq = graph.linear_ref_sequence()
    reference = "".join(numeric_to_letter_sequence(refseq).tolist()).upper()
    starts = np.asarray(graph.node_to_ref_offset)
    variants = []
    for line, (ref_node, var_node) in enumerate(variant_to_nodes):
        ref_node, var_node = int(ref_node), int(var_node)
        pos0 = int(starts[ref_node])
        alt = graph.get_node_sequence(var_node).upper()
        if graph.get_node_size(ref_node):
            variants.append(VcfVariant(chromosome, pos0 + 1, reference[pos0],
                                       alt, vcf_line_number=line))
        else:
            anchor = reference[pos0 - 1]
            variants.append(VcfVariant(chromosome, pos0, anchor, anchor + alt,
                                       vcf_line_number=line))
    return reference, VcfVariants(variants)
