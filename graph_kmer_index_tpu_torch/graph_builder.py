"""Build a variant pangenome graph from a reference FASTA + VCF (the
port's copy of graph_kmer_index_tpu/graph_builder.py).

The reference implementation delegates graph construction to the external
``obgraph`` package (SURVEY.md L0); a user switching to this framework
needs it in-tree. Produces the same topology KAGE expects:

- the linear reference chopped at variant sites,
- one (ref_allele, alt_allele) node pair per bi-allelic variant
  (SNP: two 1-bp nodes; insertion: empty ref-dummy + inserted bases;
  deletion: deleted bases + empty alt-dummy),
- a VariantToNodes table aligned with VCF line numbers.

Overlapping or unsupported variants are skipped with a warning (their
VariantToNodes rows are 0, which the variant-kmer machinery already
treats as "no nodes", unique_variant_kmers.py find_unique_kmers).
"""
from __future__ import annotations

import logging

import numpy as np

from .graph import Graph, VariantToNodes
from .variants import VcfVariants
from .utils.fasta import read_fasta_sequences


def build_graph_from_vcf(reference_sequences: dict, variants: VcfVariants):
    """(Graph, VariantToNodes) from {chrom: sequence} + variants."""
    node_seqs: dict[int, str] = {}
    edges: dict[int, list[int]] = {}
    linear_ref: list[int] = []
    chromosome_start_nodes: list[int] = []
    n_variants = len(variants)
    ref_nodes_v = np.zeros(n_variants, dtype=np.int32)
    var_nodes_v = np.zeros(n_variants, dtype=np.int32)

    by_chrom: dict = {}
    for v in variants:
        by_chrom.setdefault(str(v.chromosome), []).append(v)

    nid = 1

    def add_node(seq):
        nonlocal nid
        node_seqs[nid] = seq
        nid += 1
        return nid - 1

    def link(frm, to):
        for f in frm:
            edges.setdefault(f, []).append(to)

    n_skipped = 0
    for chrom, seq in reference_sequences.items():
        chrom_variants = sorted(by_chrom.get(str(chrom), []),
                                key=lambda v: v.position)
        cursor = 0
        prev_tails: list[int] = []
        first_node_of_chrom = None

        # multi-allelic sites arrive as several bi-allelic variants at
        # the same position (variants.py splits ALT "G,T"); encode them
        # as ONE bubble — one shared ref-allele node, one alt node per
        # allele — like the obgraph merge topology the reference pipeline
        # consumes, instead of dropping all but the first as overlaps
        last_site = None  # (seg_end, after, seg, ref_allele)
        for v in chrom_variants:
            pos0 = v.position - 1  # VCF is 1-based
            if v.type not in ("SNP", "INSERTION", "DELETION"):
                logging.warning("unsupported variant type %s at %s:%d — "
                                "skipping", v.type, chrom, v.position)
                n_skipped += 1
                continue
            ref_s = v.ref_sequence.upper()
            alt_s = v.variant_sequence.upper()
            if seq[pos0:pos0 + len(ref_s)].upper() != ref_s:
                logging.warning("REF mismatch at %s:%d (have %s, vcf %s)"
                                " — skipping", chrom, v.position,
                                seq[pos0:pos0 + len(ref_s)], ref_s)
                n_skipped += 1
                continue
            # general anchored encoding: consume the common REF/ALT
            # prefix into the linear segment (the VCF anchor bases —
            # possibly more than one on non-minimal records), then one
            # node per remaining allele. Minimal records reduce to the
            # classic shapes: SNP -> two 1-bp nodes, insertion -> empty
            # ref node + inserted bases, deletion -> deleted bases +
            # empty alt node. Non-minimal records (REF 'CA' ALT 'CATG')
            # used to duplicate the unconsumed anchor base.
            pre = 0
            while (pre < len(ref_s) and pre < len(alt_s)
                   and ref_s[pre] == alt_s[pre]):
                pre += 1
            seg_end = pos0 + pre
            after = pos0 + len(ref_s)
            ref_allele_seq = seq[seg_end:after]
            alt_allele_seq = alt_s[pre:]

            if last_site is not None and (seg_end, after) == last_site[:2]:
                # same REF span as the previous variant: another allele
                # of the same site — share its segment and ref node
                _, _, seg, ref_allele = last_site
                alt_allele = add_node(alt_allele_seq)
                edges[seg].append(alt_allele)
                prev_tails.append(alt_allele)
                if v.vcf_line_number is not None:
                    ref_nodes_v[v.vcf_line_number] = ref_allele
                    var_nodes_v[v.vcf_line_number] = alt_allele
                continue

            if seg_end < cursor:
                logging.warning("overlapping variant at %s:%d — skipping",
                                chrom, v.position)
                n_skipped += 1
                continue

            seg = add_node(seq[cursor:seg_end])
            link(prev_tails, seg)
            linear_ref.append(seg)
            if first_node_of_chrom is None:
                first_node_of_chrom = seg
            ref_allele = add_node(ref_allele_seq)
            alt_allele = add_node(alt_allele_seq)
            edges[seg] = [ref_allele, alt_allele]
            linear_ref.append(ref_allele)
            prev_tails = [ref_allele, alt_allele]
            cursor = after
            last_site = (seg_end, after, seg, ref_allele)
            if v.vcf_line_number is not None:
                ref_nodes_v[v.vcf_line_number] = ref_allele
                var_nodes_v[v.vcf_line_number] = alt_allele

        tail = add_node(seq[cursor:])
        link(prev_tails, tail)
        linear_ref.append(tail)
        if first_node_of_chrom is None:
            first_node_of_chrom = tail
        chromosome_start_nodes.append(first_node_of_chrom)

    if n_skipped:
        logging.warning("build_graph_from_vcf: skipped %d variants",
                        n_skipped)
    graph = Graph.from_dicts(
        node_seqs, edges, linear_ref,
        chromosome_start_nodes=chromosome_start_nodes,
        chromosome_names=[str(c) for c in reference_sequences])
    return graph, VariantToNodes(ref_nodes_v, var_nodes_v)


def build_graph_from_files(fasta_file: str, vcf_file: str):
    refs = read_fasta_sequences(fasta_file)
    variants = VcfVariants.from_vcf(vcf_file)
    return build_graph_from_vcf(refs, variants)
