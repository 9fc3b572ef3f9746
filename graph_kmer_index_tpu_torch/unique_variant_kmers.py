"""UniqueVariantKmersFinder — select "signature" k-mers per VCF variant
(the KAGE genotyping input); the port's copy of
graph_kmer_index_tpu/unique_variant_kmers.py. Behavioral mirror of the
reference unique_variant_kmers.py:10-269:

- candidate start positions ``[variant.position - i for i in range(2, k-2)]
  [::4][::-1]`` (reference :119);
- per candidate, run a finder (Snp- or Dense-) from that linear-ref
  position with ``only_store_nodes={ref,var} - already_found`` (:121-140);
- reject candidates where ref & var alleles share a k-mer (:165-167); the
  LAST candidate is always accepted as fallback (:170-172);
- rank surviving candidates by max k-mer frequency against a frequency
  index, pick the lowest (stable sort, :214-218);
- early-exit the candidate scan when a candidate's max frequency <= 1
  (:181-183);
- assert each node is selected at most once across variants (:232-235).

The frequency scoring — the expensive part at genome scale — is one
``get_frequencies`` batch per run of the batched selector
(KmerIndex.get_frequencies answers it on the index's device), and one
batch per candidate in the per-variant search.
"""
from __future__ import annotations

import logging

import numpy as np

from .finder import DenseKmerFinder
from .flat_kmers import FlatKmers
from .hashing import sliding_window_hashes
from .snp_finder import SnpKmerFinder, linear_ref_specials


class UniqueVariantKmersFinder:
    def __init__(self, graph, variant_to_nodes, variants, k=31,
                 max_variant_nodes=6, kmer_index_with_frequencies=None,
                 haplotype_matrix=None, node_to_variants=None,
                 do_not_choose_lowest_frequency_kmers=False,
                 use_dense_kmer_finder=False, position_id_index=None,
                 use_simple=False):
        self.graph = graph
        self.variant_to_nodes = variant_to_nodes
        self.reference_kmer_index = None
        self.variants = variants
        self.k = k
        self.flat_kmers_found = []
        self.n_failed_variants = 0
        self._max_variant_nodes = max_variant_nodes
        self._kmer_index_with_frequencies = kmer_index_with_frequencies
        self.haplotype_matrix = haplotype_matrix
        self.node_to_variants = node_to_variants
        self._use_dense_kmer_finder = use_dense_kmer_finder
        self._position_id_index = position_id_index
        self._nodes_found = set()
        self._use_simple = use_simple
        # skip-counter discipline (SURVEY §5.5 "no silent caps"): the
        # batched selector must report how much of a run degraded to the
        # exact per-variant fallback
        self.n_batched_variants = 0
        self.n_fallback_variants = 0
        self.n_zero_node_variants = 0

        if self._use_dense_kmer_finder:
            assert self._position_id_index is not None, \
                "Position id index must be set when using dense kmer finder"

        self._choose_kmers_with_lowest_frequencies = \
            not do_not_choose_lowest_frequency_kmers

    # -- per-node search (reference :70-100) --------------------------------

    def find_kmers_over_variant_node(self, variant, node):
        start_pos = variant.position
        assert variant.type, "Variant type must be set"
        if variant.type != "SNP":
            start_pos = start_pos + 1  # indel pos is 1 base before
        start_pos -= 1  # 1-based -> 0-based

        node_sequence = self.graph.get_node_sequence(node)
        if node_sequence == "" or variant.type != "SNP":
            start_node = self.graph.get_node_at_chromosome_and_chromosome_offset(
                variant.chromosome, start_pos - 8)
            start_node_offset = \
                self.graph.get_node_offset_at_chromosome_and_chromosome_offset(
                    variant.chromosome, start_pos - 8)
        else:
            start_node = node
            start_node_offset = 0

        finder = DenseKmerFinder(
            self.graph, self.k, None, position_id=self._position_id_index,
            max_variant_nodes=self._max_variant_nodes,
            only_store_nodes={node}, only_follow_nodes={node})
        finder.find_only_kmers_starting_at_position(
            int(start_node), int(start_node_offset))
        return finder.get_flat_kmers(v="1")

    def kmer_is_unique_on_reference_position(self, kmer, reference_position,
                                             ref_start, ref_end):
        """True if ``kmer`` does not occur at any other reference position
        in [ref_start, ref_end) (reference unique_variant_kmers.py:39-47;
        requires ``self.reference_kmer_index`` to be set)."""
        reference_kmers = self.reference_kmer_index.get_between(ref_start,
                                                               ref_end)
        for i, reference_kmer in enumerate(reference_kmers):
            pos = ref_start + i
            if pos != reference_position and reference_kmer == kmer:
                return False
        return True

    def find_kmers_over_structural_variant(self, variant, ref_node,
                                           variant_node):
        """Search both allele nodes (reference unique_variant_kmers.py
        :102-105 — NB the reference discards the results too)."""
        self.find_kmers_over_variant_node(variant, ref_node)
        self.find_kmers_over_variant_node(variant, variant_node)

    def find_kmers_over_variant(self, variant, ref_node, variant_node):
        """Simple mode: kmers over both alleles, no uniqueness search
        (reference :107-111)."""
        ref_kmers = self.find_kmers_over_variant_node(variant, ref_node)
        variant_kmers = self.find_kmers_over_variant_node(variant, variant_node)
        return FlatKmers.from_multiple_flat_kmers([ref_kmers, variant_kmers])

    # -- unique search (reference :114-238) ---------------------------------

    def find_unique_kmers_over_variant(self, variant, ref_node, variant_node):
        possible_ref_positions = \
            [variant.position - i for i in range(2, self.k - 2)][::4][::-1]
        valid_positions_found = []

        for possible_ref_position in possible_ref_positions:
            possible_ref_position_adjusted = \
                self.graph.convert_chromosome_ref_offset_to_graph_ref_offset(
                    possible_ref_position, variant.chromosome)
            is_valid = True
            only_store_nodes = {n for n in (ref_node, variant_node)
                                if n not in self._nodes_found}

            if not self._use_dense_kmer_finder:
                finder = SnpKmerFinder(
                    self.graph, self.k,
                    max_variant_nodes=self._max_variant_nodes,
                    only_store_nodes=only_store_nodes,
                    haplotype_matrix=self.haplotype_matrix,
                    node_to_variants=self.node_to_variants,
                    variant_to_nodes=self.variant_to_nodes)
                finder.find_kmers_from_linear_ref_position(
                    possible_ref_position_adjusted)
            else:
                finder = DenseKmerFinder(
                    self.graph, self.k, None,
                    position_id=self._position_id_index,
                    max_variant_nodes=self._max_variant_nodes,
                    only_store_nodes=only_store_nodes)
                node = self.graph.get_node_at_ref_offset(
                    possible_ref_position_adjusted)
                offset = self.graph.get_node_offset_at_ref_offset(
                    possible_ref_position_adjusted)
                finder.find_only_kmers_starting_at_position(node, offset)

            kmers_ref, kmers_variant = set(), set()
            for _kmer, nodes, *_rest, hash_ in finder.kmers_found:
                if ref_node in nodes:
                    kmers_ref.add(hash_)
                if variant_node in nodes:
                    kmers_variant.add(hash_)

            # identical kmers on the two alleles are useless as signatures
            if kmers_ref & kmers_variant:
                is_valid = False

            # last candidate: accept anyway, better than nothing
            if possible_ref_position == possible_ref_positions[-1]:
                is_valid = True

            if is_valid:
                flat = finder.get_flat_kmers(v="1")
                assert len(set(flat._nodes)) <= 2
                valid_positions_found.append(flat)

                if flat.maximum_kmer_frequency(
                        self._kmer_index_with_frequencies) <= 1:
                    break  # all kmers already unique, stop searching

                if len(flat._nodes) == 0:
                    logging.warning(
                        "Found 0 nodes for variant %s (searched from %d)",
                        variant, possible_ref_position)

        if not valid_positions_found:
            logging.warning("Found no positions with valid kmers for "
                            "variant %s", variant)
            self.n_failed_variants += 1
            return None

        if self._choose_kmers_with_lowest_frequencies:
            valid_positions_found = sorted(
                valid_positions_found,
                key=lambda p: p.maximum_kmer_frequency(
                    self._kmer_index_with_frequencies))
        best_position = valid_positions_found[0]

        for node in set(best_position._nodes):
            assert node not in self._nodes_found, (
                "Found node %d at variant %s (nodes %d/%d), but already "
                "found for previous variant"
                % (node, variant, ref_node, variant_node))
            self._nodes_found.add(node)
        return best_position

    # -- batched selection (kivs replacement) -------------------------------

    def _batched_geometry(self, variants):
        """Vectorized per-variant bubble geometry + eligibility for the
        batched path. A variant is eligible when its candidate windows
        form an isolated bi-allelic bubble: exactly two DFS paths exist
        from every candidate position (the ref window and the alt-
        substituted window), so hashes and node sets are computable as
        arrays. Everything else (variant clusters within k, chromosome
        edges, exotic graph shapes, zero node ids) falls back to the
        exact per-variant search."""
        g = self.graph
        k = self.k
        ref_nodes_ord, cum, refseq = g.linear_ref_sequence()
        specials = linear_ref_specials(g)
        ref_len = len(refseq)
        n = len(variants)

        vl = np.array([v.vcf_line_number for v in variants], dtype=np.int64)
        rn = np.asarray(self.variant_to_nodes.ref_nodes)[vl].astype(np.int64)
        vn = np.asarray(self.variant_to_nodes.var_nodes)[vl].astype(np.int64)
        pos = np.array([v.position for v in variants], dtype=np.int64)
        chrom_base = np.array(
            [g.convert_chromosome_ref_offset_to_graph_ref_offset(
                0, v.chromosome) for v in variants], dtype=np.int64)

        cand_i = np.arange(2, k - 2, dtype=np.int64)[::4][::-1]
        n_cand = len(cand_i)
        # candidate graph-ref positions, (n, n_cand)
        p = (chrom_base + pos)[:, None] - cand_i[None, :]

        nonzero = (rn > 0) & (vn > 0)
        rs = np.where(nonzero, rn, 1)
        vs = np.where(nonzero, vn, 1)
        size_r = g.node_sizes[rs].astype(np.int64)
        f1 = g.node_to_ref_offset[rs].astype(np.int64)
        merge = f1 + size_r
        out_deg = (g.edge_index[1:] - g.edge_index[:-1])

        ok = nonzero & (n_cand > 0)
        # ref arm on the linear path (or an insertion's zero-length dummy)
        ok &= g.linear_ref_mask[rs] | (size_r == 0)
        ok &= ~g.linear_ref_mask[vs]
        ok &= (f1 >= 1) & (merge < ref_len)
        # fork node = ref node covering offset f1-1, must branch exactly
        # into {ref arm, var arm}
        fi = np.searchsorted(cum, np.maximum(f1 - 1, 0), side="right") - 1
        fork = ref_nodes_ord[np.clip(fi, 0, len(ref_nodes_ord) - 1)]
        e0 = g.edge_index[fork]
        deg2 = out_deg[fork] == 2
        t0 = g.edge_targets[np.where(deg2, e0, 0)]
        t1 = g.edge_targets[np.where(deg2, e0 + 1, 0)]
        ok &= deg2 & (((t0 == rs) & (t1 == vs)) | ((t0 == vs) & (t1 == rs)))
        # both arms rejoin at the ref node starting at `merge`
        mi = np.searchsorted(cum, merge, side="right") - 1
        mnode = ref_nodes_ord[np.clip(mi, 0, len(ref_nodes_ord) - 1)]
        for arm in (rs, vs):
            ea = g.edge_index[arm]
            deg1 = out_deg[arm] == 1
            ta = g.edge_targets[np.where(deg1, ea, 0)]
            ok &= deg1 & (ta == mnode)
        # every candidate window must straddle the fork
        ok &= np.all((p >= 0) & (p < f1[:, None]) & (f1[:, None] < p + k),
                     axis=1)
        # no foreign branch point near any window: exactly the variant's
        # own fork inside [p_min, p_max + k), nothing else; and nothing
        # after the merge within reach of the alt path's suffix
        p_min, p_max = p.min(axis=1), p.max(axis=1)
        in_ref_win = (np.searchsorted(specials, p_max + k)
                      - np.searchsorted(specials, p_min))
        ok &= in_ref_win == 1  # the fork itself
        after = (np.searchsorted(specials, merge + k)
                 - np.searchsorted(specials, merge))
        own_in_after = ((merge <= f1) & (f1 < merge + k)).astype(np.int64)
        ok &= after == own_in_after
        return {
            "rn": rn, "vn": vn, "p": p, "f1": f1, "merge": merge,
            "eligible": ok, "ref_nodes_ord": ref_nodes_ord, "cum": cum,
            "refseq": refseq, "n_cand": n_cand,
        }

    def _batched_hashes(self, geo):
        """One sliding-window pass (on the host) over all eligible variants'
        candidate tapes: per variant a ref tape (the plain reference
        span) and an alt tape (prefix + alt allele + suffix). Returns
        (n, n_cand) uint64 H_ref / H_alt arrays (zeros where ineligible).
        Windows never cross tape boundaries at the offsets read."""
        g = self.graph
        k = self.k
        refseq = geo["refseq"]
        p, f1, merge = geo["p"], geo["f1"], geo["merge"]
        vn = geo["vn"]
        elig = np.nonzero(geo["eligible"])[0]
        n, n_cand = p.shape

        tapes, meta = [], []  # meta: (variant_row, tape_start_offset)
        total = 0
        for v in elig:
            pmin, pmax = int(p[v].min()), int(p[v].max())
            ref_tape = refseq[pmin:pmax + k]
            alt = g.sequence[g.seq_start[vn[v]]:
                             g.seq_start[vn[v]] + g.node_sizes[vn[v]]]
            alt_tape = np.concatenate([
                refseq[pmin:f1[v]], alt,
                refseq[merge[v]:merge[v] + k - 1]])
            tapes.append(ref_tape)
            meta.append((v, total, pmin, False))
            total += len(ref_tape)
            tapes.append(alt_tape)
            meta.append((v, total, pmin, True))
            total += len(alt_tape)

        h_ref = np.zeros((n, n_cand), dtype=np.uint64)
        h_alt = np.zeros((n, n_cand), dtype=np.uint64)
        if not tapes:
            return h_ref, h_alt
        tape = np.concatenate(tapes).astype(np.uint64)
        hashes = sliding_window_hashes(tape, k)
        for v, start, pmin, is_alt in meta:
            offs = start + (p[v] - pmin)
            (h_alt if is_alt else h_ref)[v] = hashes[offs]
        return h_ref, h_alt

    @staticmethod
    def _span_min(values_ext, cum, lo, hi):
        """Vectorized min of ``values`` over the ref nodes covering each
        [lo, hi) range (lo < hi elementwise). ``values_ext`` must carry a
        +inf sentinel appended at the end."""
        a = np.searchsorted(cum, lo, side="right") - 1
        b = np.searchsorted(cum, hi - 1, side="right") - 1
        bounds = np.empty(2 * len(a), dtype=np.int64)
        bounds[0::2] = a
        bounds[1::2] = b + 1
        return np.minimum.reduceat(values_ext, bounds)[0::2]

    def find_unique_kmers_batched(self):
        """Batched variant-signature selection — the replacement for the
        reference's external C++ ``kivs`` path
        (command_line_interface.py:391-426). Candidate windows for ALL
        variants are constructed geometrically, hashed in one
        sliding-window kernel pass and scored with one batched frequency
        lookup; per-variant python is only the final argmin selection
        with the shared-kmer rejection rule. Variants failing the
        isolated-bubble eligibility check fall back to the exact
        per-variant search, making results bit-identical to
        ``find_unique_kmers`` (SnpKmerFinder mode) on any input."""
        assert not self._use_dense_kmer_finder, \
            "batched selection implements the SnpKmerFinder-mode semantics"
        variants = list(self.variants)
        if not variants:
            return FlatKmers.from_multiple_flat_kmers(self.flat_kmers_found)
        for v in variants:
            assert v.vcf_line_number is not None, \
                "Variant line number must be specified"

        geo = self._batched_geometry(variants)
        if (self._kmer_index_with_frequencies is None
                or self._max_variant_nodes < 2
                or self.haplotype_matrix is not None):
            # scoring index missing or per-path filters active in ways the
            # geometric construction does not model: run everything exact
            geo["eligible"][:] = False
        h_ref, h_alt = self._batched_hashes(geo)
        # one frequency batch for every candidate hash (same scoring call
        # as FlatKmers.maximum_kmer_frequency)
        if geo["eligible"].any():
            idx = self._kmer_index_with_frequencies
            both = np.concatenate([h_ref.reshape(-1), h_alt.reshape(-1)])
            freqs = np.asarray(idx.get_frequencies(both), dtype=np.int64)
            f_ref = freqs[:both.size // 2].reshape(h_ref.shape)
            f_alt = freqs[both.size // 2:].reshape(h_alt.shape)

        g = self.graph
        n = len(variants)
        n_cand = geo["n_cand"]
        rn_a, vn_a, p_a = geo["rn"], geo["vn"], geo["p"]
        eligible = geo["eligible"]
        choose_lowest = self._choose_kmers_with_lowest_frequencies
        nodes_found = self._nodes_found

        # phase 1 — sequential selection (cheap per-variant python: score
        # argmin + the node-uniqueness bookkeeping); fallback variants run
        # the exact per-variant search inline so _nodes_found stays in
        # variant order. Eligible variants only record WHAT to emit; the
        # rows themselves are built vectorized in phase 2.
        slots = []         # per output flat: FlatKmers | (row_lo, row_hi)
        sel_v, sel_c = [], []
        emit_ref, emit_var = [], []
        n_rows = 0
        for v, variant in enumerate(variants):
            ref_node, variant_node = int(rn_a[v]), int(vn_a[v])
            if ref_node == 0 or variant_node == 0:
                self.n_zero_node_variants += 1
                continue
            if not eligible[v]:
                self.n_fallback_variants += 1
                n_before = len(self.flat_kmers_found) + len(slots)
                found = self.find_unique_kmers_over_variant(
                    variant, ref_node, variant_node)
                if found is not None:
                    slots.append(found)
                if len(self.flat_kmers_found) + len(slots) != n_before + 1:
                    logging.warning("DID NOT FIND KMERS ON %s", variant)
                continue

            self.n_batched_variants += 1
            store_ref = ref_node not in nodes_found
            store_var = variant_node not in nodes_found
            hr_row, ha_row = h_ref[v], h_alt[v]
            fr_row, fa_row = f_ref[v], f_alt[v]
            best_score, best_c = None, None
            for c in range(n_cand):
                if hr_row[c] == ha_row[c] and c != n_cand - 1:
                    continue  # shared kmer on both alleles: useless
                if store_ref:
                    score = fr_row[c] if not store_var \
                        else max(fr_row[c], fa_row[c])
                elif store_var:
                    score = fa_row[c]
                else:
                    score = 0
                if best_score is None or score < best_score:
                    best_score, best_c = score, c
                if score <= 1:
                    break
                if not choose_lowest:
                    break  # first valid candidate wins
            sel_v.append(v)
            sel_c.append(best_c)
            emit_ref.append(store_ref)
            emit_var.append(store_var)
            lo = n_rows
            n_rows += int(store_ref) + int(store_var)
            slots.append((lo, n_rows))
            for node in ([ref_node] if store_ref else []) + \
                    ([variant_node] if store_var else []):
                assert node not in nodes_found, (
                    "Found node %d at variant %s (nodes %d/%d), but already "
                    "found for previous variant"
                    % (node, variant, ref_node, variant_node))
                nodes_found.add(node)

        # phase 2 — vectorized row construction for all selected variants
        if sel_v:
            sv = np.asarray(sel_v)
            sc = np.asarray(sel_c)
            e_ref = np.asarray(emit_ref)
            e_var = np.asarray(emit_var)
            cum = geo["cum"]
            af_ord = g.allele_frequencies[geo["ref_nodes_ord"]]
            af_ext = np.append(af_ord, np.inf)
            af_node = g.allele_frequencies
            k = self.k
            pp = p_a[sv, sc]
            f1 = geo["f1"][sv]
            merge = geo["merge"][sv]
            rn_s, vn_s = rn_a[sv], vn_a[sv]
            alt_len = g.node_sizes[vn_s].astype(np.int64)
            # ref path: nodes covering [p, p+k) (+ the zero-length
            # insertion dummy, harmless to include generally)
            af_r = np.minimum(self._span_min(af_ext, cum, pp, pp + k),
                              af_node[rn_s])
            # alt path: [p, f1) + var node + [merge, merge + suffix)
            af_a = np.minimum(self._span_min(af_ext, cum, pp, f1),
                              af_node[vn_s])
            suffix = k - (f1 - pp) - alt_len
            has_suf = np.nonzero(suffix > 0)[0]
            if len(has_suf):
                m2 = self._span_min(af_ext, cum, merge[has_suf],
                                    merge[has_suf] + suffix[has_suf])
                af_a[has_suf] = np.minimum(af_a[has_suf], m2)

            big_h = np.zeros(n_rows, dtype=np.uint64)
            big_n = np.zeros(n_rows, dtype=np.uint32)
            big_o = np.zeros(n_rows, dtype=np.uint64)
            big_af = np.zeros(n_rows, dtype=np.single)
            off = np.cumsum(e_ref.astype(np.int64) + e_var) - \
                (e_ref.astype(np.int64) + e_var)
            r_at = off[e_ref]
            big_h[r_at] = h_ref[sv, sc][e_ref]
            big_n[r_at] = rn_s[e_ref]
            big_o[r_at] = pp[e_ref]
            big_af[r_at] = af_r[e_ref]
            v_at = (off + e_ref)[e_var]
            big_h[v_at] = h_alt[sv, sc][e_var]
            big_n[v_at] = vn_s[e_var]
            big_o[v_at] = pp[e_var]
            big_af[v_at] = af_a[e_var]

        for slot in slots:
            if isinstance(slot, tuple):
                lo, hi = slot
                self.flat_kmers_found.append(FlatKmers(
                    big_h[lo:hi], big_n[lo:hi], big_o[lo:hi], big_af[lo:hi]))
            else:
                self.flat_kmers_found.append(slot)

        logging.info("N variants with kmers found: %d",
                     len(self.flat_kmers_found))
        logging.info("Done with all variants. N that failed: %d",
                     self.n_failed_variants)
        n_routed = self.n_batched_variants + self.n_fallback_variants
        logging.info(
            "batched selection: %d/%d variants batched, %d exact-fallback"
            "%s", self.n_batched_variants, n_routed,
            self.n_fallback_variants,
            (", %d skipped (zero nodes)" % self.n_zero_node_variants
             if self.n_zero_node_variants else ""))
        if n_routed >= 100 and self.n_fallback_variants > n_routed // 2:
            logging.warning(
                "batched variant-signature selection degraded: %.0f%% of "
                "%d variants took the exact per-variant fallback (dense "
                "variant clusters / non-isolated bubbles) — expect "
                "per-variant-search throughput, not the batched rate",
                100.0 * self.n_fallback_variants / n_routed, n_routed)
        return FlatKmers.from_multiple_flat_kmers(self.flat_kmers_found)

    def find_unique_kmers(self):
        for i, variant in enumerate(self.variants):
            n_processed = len(self.flat_kmers_found)
            assert variant.vcf_line_number is not None, \
                "Variant line number must be specified"
            ref_node = self.variant_to_nodes.ref_nodes[variant.vcf_line_number]
            variant_node = self.variant_to_nodes.var_nodes[variant.vcf_line_number]
            if ref_node == 0 or variant_node == 0:
                continue

            if not self._use_simple:
                found = self.find_unique_kmers_over_variant(
                    variant, int(ref_node), int(variant_node))
            else:
                found = self.find_kmers_over_variant(
                    variant, int(ref_node), int(variant_node))
            if found is not None:
                self.flat_kmers_found.append(found)

            if len(self.flat_kmers_found) != n_processed + 1:
                logging.warning("DID NOT FIND KMERS ON %s", variant)

        logging.info("N variants with kmers found: %d",
                     len(self.flat_kmers_found))
        logging.info("Done with all variants. N that failed: %d",
                     self.n_failed_variants)
        return FlatKmers.from_multiple_flat_kmers(self.flat_kmers_found)
