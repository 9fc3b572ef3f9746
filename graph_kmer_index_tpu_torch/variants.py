"""VCF variant model — replaces the external ``obgraph.variants`` package
(the reference imports ``VcfVariants``/``VcfVariant`` in
unique_variant_kmers.py and command_line_interface.py:23). The port's
copy of graph_kmer_index_tpu/variants.py.

Only the interface the k-mer machinery needs: per-variant
(chromosome, position, ref_sequence, variant_sequence, type,
vcf_line_number), iteration, and chunking for worklist sharding
(reference CLI make_unique_variant_kmers, command_line_interface.py:352).
"""
from __future__ import annotations

import gzip
import logging


class VcfVariant:
    def __init__(self, chromosome, position, ref_sequence="", variant_sequence="",
                 vcf_line_number=None, type=""):
        self.chromosome = chromosome
        self.position = position
        self.ref_sequence = ref_sequence
        self.variant_sequence = variant_sequence
        self.vcf_line_number = vcf_line_number
        self.type = type if type else self._infer_type()

    def _infer_type(self):
        if len(self.ref_sequence) == 1 and len(self.variant_sequence) == 1:
            return "SNP"
        if len(self.ref_sequence) < len(self.variant_sequence):
            return "INSERTION"
        if len(self.ref_sequence) > len(self.variant_sequence):
            return "DELETION"
        return "SUBSTITUTION"

    def __repr__(self):
        return (f"VcfVariant(chrom={self.chromosome}, pos={self.position}, "
                f"{self.ref_sequence}->{self.variant_sequence}, "
                f"type={self.type}, line={self.vcf_line_number})")


class VcfVariants:
    def __init__(self, variants):
        self.variants = list(variants)

    def __iter__(self):
        return iter(self.variants)

    def __len__(self):
        return len(self.variants)

    def __getitem__(self, i):
        return self.variants[i]

    @classmethod
    def from_vcf(cls, file_name, skip_index=True, make_generator=False,
                 dont_encode_chromosomes=True, limit_to_n_lines=None):
        """Minimal VCF reader (plain or gzipped); CHROM kept as string when
        ``dont_encode_chromosomes``, else parsed to int where possible.

        ``vcf_line_number`` indexes EMITTED variants (it is what
        UniqueVariantKmersFinder uses to row-index VariantToNodes, so
        the two must come from the same reader). On bi-allelic files —
        the case the reference pipeline supports — it equals the VCF
        data-line ordinal, matching the reference numbering exactly.
        Files with multi-allelic or symbolic-ALT records shift the
        numbering relative to data lines (split records emit several
        numbers, skipped records none); the warnings below flag this,
        and a VariantToNodes built elsewhere from such a file must use
        the same splitting to stay aligned."""
        opener = gzip.open if str(file_name).endswith(".gz") else open
        variants = []
        n = 0
        n_multiallelic = 0
        with opener(file_name, "rt") as f:
            for line in f:
                if line.startswith("#"):
                    continue
                cols = line.rstrip("\n").split("\t")
                if len(cols) < 5:
                    continue
                chrom = cols[0]
                if not dont_encode_chromosomes:
                    try:
                        chrom = int(chrom.lstrip("chr"))
                    except ValueError:
                        pass
                # multi-allelic records (ALT "G,T") are split into
                # bi-allelic variants; symbolic ALTs ("<DEL>", breakends)
                # are unsupported and skipped with a warning
                alts = cols[4].split(",")
                if len(alts) > 1:
                    n_multiallelic += 1
                for alt in alts:
                    if not alt or not alt.replace("*", "").isalpha():
                        logging.warning(
                            "skipping unsupported ALT %r at %s:%s "
                            "(vcf_line_numbers of later variants shift; "
                            "pair with a VariantToNodes from this same "
                            "reader)", alt, chrom, cols[1])
                        continue
                    variants.append(VcfVariant(
                        chrom, int(cols[1]), cols[3], alt,
                        vcf_line_number=n))
                    n += 1
                if limit_to_n_lines and n >= limit_to_n_lines:
                    break
        if n_multiallelic:
            logging.warning(
                "split %d multi-allelic VCF records into bi-allelic "
                "variants (vcf_line_numbers index emitted variants, not "
                "data lines; pair with a VariantToNodes from this same "
                "reader)", n_multiallelic)
        logging.info("Read %d variants from %s", n, file_name)
        return cls(variants)

    def get_chunks(self, chunk_size=10000):
        return [VcfVariants(self.variants[i:i + chunk_size])
                for i in range(0, len(self.variants), chunk_size)]
