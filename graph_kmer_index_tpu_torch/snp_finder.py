"""SnpKmerFinder — the simple per-position finder, as a vectorized
linear-reference sweep (the port's copy of
graph_kmer_index_tpu/snp_finder.py; its one device branch, the hash of
the linear-reference tape, is kernel K1 here).

The reference implementation (snp_kmer_finder.py:29-345) runs a recursive
python DFS from *every* linear-reference position. Here the sweep is
inverted: the entire linear reference is hashed in ONE sliding-window
pass (ops.encode.sliding_hashes, the kernel that also serves the reads
and DenseKmerFinder), every position whose k-window crosses no branch point
is emitted straight from the precomputed arrays, and only windows within
k of a fork / dummy node / chromosome boundary run a branch walk — an
explicit-stack enumeration of the same paths in the same order as the
reference's recursion (snp_kmer_finder.py:228-289).

All filter semantics and quirks are preserved bit-exactly:

- emission iterates ``set(nodes_in_path)`` (reference
  snp_kmer_finder.py:174) — node order is python-set iteration order;
- ``_n_variant_nodes_passed`` accumulates across sibling branches of one
  position search, and ``max_variant_nodes`` compares with ``>=``;
- pruning window of 124 bp keyed on the last *added* ref position;
- the kmer-frequency cap counts *added* occurrences (``>=`` compare);
- linear-ref arm is explored first (reference :274-282), branch arms in
  reversed edge order when the first edge is a variant arm.
"""
from __future__ import annotations

import logging
from collections import defaultdict

import numpy as np

from .flat_kmers import FlatKmers
from .hashing import (letter_sequence_to_numeric, numeric_to_letter_sequence,
                      kmer_to_hash_fast, kmer_hash_to_reverse_complement_hash,
                      kmer_hashes_to_reverse_complement_hash,
                      sliding_window_hashes, power_array, reverse_power_array)
from .read_kmers import ReadKmers, reverse_complement_string


def linear_ref_specials(graph):
    """Sorted ref offsets near which a k-window cannot be treated as a
    plain linear-reference window: ends of ref nodes that fork, dead-end
    (chromosome tails), bridge into anything but the next ref node, or
    are zero-length — plus the end of the reference itself. Cached on the
    graph (graph-static)."""
    cached = getattr(graph, "_specials_cache", None)
    if cached is not None:
        return cached
    ref_nodes, cum, refseq = graph.linear_ref_sequence()
    specials = [len(refseq)]
    for i, u in enumerate(ref_nodes):
        edges = graph.get_edges(u)
        if (len(edges) != 1
                or i + 1 >= len(ref_nodes)
                or int(edges[0]) != int(ref_nodes[i + 1])
                or graph.get_node_size(int(u)) == 0
                or graph.get_node_size(int(ref_nodes[i + 1])) == 0):
            specials.append(int(cum[i + 1]))
    graph._specials_cache = np.unique(np.asarray(specials, dtype=np.int64))
    return graph._specials_cache


class SnpKmerFinder:
    """Simple kmer finder that only supports SNP graphs (+ indel dummies)."""

    # linear references from this length on are hashed on the device
    DEVICE_TAPE_THRESHOLD = 1 << 20

    def __init__(self, graph, k=15, spacing=None,
                 include_reverse_complements=False, pruning=False,
                 max_kmers_same_position=100000, max_frequency=10000,
                 max_variant_nodes=10000, only_add_variant_kmers=False,
                 whitelist=None, only_save_variant_nodes=False,
                 start_position=None, end_position=None,
                 only_store_nodes=None, skip_kmers_with_nodes=None,
                 only_save_one_node_per_kmer=False, reference=None,
                 variant_to_nodes=None, node_to_variants=None,
                 haplotype_matrix=None, use_device=None, device="cuda"):
        """``use_device``/``device``: where the sweep hashes the
        linear-reference tape, as in DenseKmerFinder. ``use_device=True``
        hashes on ``device`` (required then); ``False`` on the host;
        ``None`` on ``device`` when it is a CUDA device and the reference
        has at least ``DEVICE_TAPE_THRESHOLD`` bases, else on the host.
        The default device is the card: a long reference on a machine
        without one raises (pass ``device="cpu"`` to hash it on the
        host)."""
        self.graph = graph
        self._use_device = use_device
        self._device = device
        self.reference = reference
        self.k = k
        self.spacing = k if spacing is None else spacing
        self.pruning = pruning
        self._include_reverse_complements = include_reverse_complements
        self._max_kmers_same_position = max_kmers_same_position
        self._max_frequency = max_frequency
        self._max_variant_nodes = max_variant_nodes
        self._only_add_variant_kmers = only_add_variant_kmers
        self._whitelist = whitelist
        self._start_position = start_position or 0
        self._end_position = end_position
        self._only_store_nodes = only_store_nodes
        self._skip_kmers_with_nodes = skip_kmers_with_nodes
        self._only_save_one_node_per_kmer = only_save_one_node_per_kmer
        self.haplotype_matrix = haplotype_matrix
        self.variant_to_nodes = variant_to_nodes
        self.node_to_variants = node_to_variants

        # output rows: list-appends from the filter chain, plus whole
        # array chunks from the vectorized batch path, ordered by flush
        self._hashes = []
        self._nodes = []
        self._ref_offsets = []
        self._allele_frequencies = []
        self._row_chunks = []
        self.kmers_found = []          # first 500 (kmer, nodes, pos, hash)
        self._kmers_found = 0

        # sequential filter state
        self._unique_kmers_added = set()
        self._kmer_frequencies = defaultdict(int)
        self._last_ref_pos_added = 0
        self._current_ref_offset = None
        self._has_traversed_variant = False
        self._n_kmers_added_current_position = 0
        self._n_paths_searched = 0
        self._n_variant_nodes_passed = 0

        # skip counters (observability parity)
        self._n_kmers_pruned = 0
        self._n_kmers_skipped = 0
        self._n_skipped_due_to_frequency = 0
        self._n_skipped_due_to_max_variant_nodes = 0
        self._n_skipped_whitelist = 0
        self._n_skipped_blacklist_nodes = 0
        self._n_kmers_skipped_low_allele_frequency = 0

        # branch-walk path state: numeric 2-bit bases, -1 = dummy sentinel
        self._path_bases: list[int] = []
        self._path_nodes: list[int] = []
        self._pv = reverse_power_array(k)  # cached hash weights

        self._only_save_variant_nodes = only_save_variant_nodes
        self._variant_nodes = set()
        if only_save_variant_nodes:
            # all successors of fork nodes are variant-associated
            for node in range(graph.n_nodes()):
                edges = graph.get_edges(node)
                if len(edges) > 1:
                    for nxt in edges:
                        self._variant_nodes.add(int(nxt))

    # -- shared emission filter chain --------------------------------------

    def has_kmer(self, kmer, nodes):
        """Test helper (reference snp_kmer_finder.py:~91). Our decoded kmer
        strings are lowercase 'acgt'; compare case-insensitively."""
        kmer = kmer.lower()
        return any(f[0] == kmer and f[1] == nodes for f in self.kmers_found)

    def _emit(self, hash_, nodes, kmer_string, rev_hash=None,
              n_variant_nodes=None, allele_frequency=None):
        """Run one candidate kmer occurrence through the filter chain and
        append surviving rows. Checks run in the reference's order
        (snp_kmer_finder.py:117-203) — order is observable through the
        skip counters and the stateful frequency/pruning filters.

        ``kmer_string`` may be a callable (built lazily — only whitelist
        misses and the first 500 found kmers need the string).
        """
        self._n_paths_searched += 1

        if self._whitelist is not None and hash_ not in self._whitelist:
            if rev_hash is None:
                if callable(kmer_string):
                    kmer_string = kmer_string()
                rev_hash = kmer_to_hash_fast(letter_sequence_to_numeric(
                    reverse_complement_string(kmer_string)), self.k)
            if rev_hash not in self._whitelist:
                self._n_skipped_whitelist += 1
                return

        if (self._skip_kmers_with_nodes is not None
                and nodes.intersection(self._skip_kmers_with_nodes)):
            self._n_skipped_blacklist_nodes += 1
            return

        if not self._has_traversed_variant and self._only_add_variant_kmers:
            return

        if self._kmer_frequencies[hash_] >= self._max_frequency:
            self._n_skipped_due_to_frequency += 1
            return

        if self.pruning and hash_ not in self._unique_kmers_added:
            if (self._last_ref_pos_added != self._current_ref_offset
                    and self._last_ref_pos_added > self._current_ref_offset - 124):
                if not self._has_traversed_variant:
                    self._n_kmers_pruned += 1
                    return

        if self._n_kmers_added_current_position > self._max_kmers_same_position:
            self._n_kmers_skipped += 1
            return

        if n_variant_nodes is None:
            n_variant_nodes = sum(
                1 for n in nodes
                if not self.graph.is_linear_ref_node_or_linear_ref_dummy_node(n))
        if n_variant_nodes >= self._max_variant_nodes:
            self._n_skipped_due_to_max_variant_nodes += 1
            return

        if self._include_reverse_complements and rev_hash is None:
            if callable(kmer_string):
                kmer_string = kmer_string()
            rev_hash = kmer_to_hash_fast(letter_sequence_to_numeric(
                reverse_complement_string(kmer_string)), self.k)

        self._unique_kmers_added.add(hash_)
        self._kmer_frequencies[hash_] += 1

        if self.haplotype_matrix is not None:
            af = self.haplotype_matrix.get_allele_frequency_for_nodes(
                nodes, self.node_to_variants, self.variant_to_nodes)
        elif allele_frequency is not None:
            af = allele_frequency
        else:
            af = min(self.graph.get_node_allele_frequency(n) for n in nodes)

        for node in nodes:
            if self._only_save_variant_nodes and node not in self._variant_nodes:
                continue
            if (self._only_store_nodes is not None
                    and node not in self._only_store_nodes):
                continue
            self._hashes.append(hash_)
            self._nodes.append(node)
            self._ref_offsets.append(self._current_ref_offset)
            self._allele_frequencies.append(af)
            if self._include_reverse_complements:
                self._hashes.append(rev_hash)
                self._nodes.append(node)
                self._ref_offsets.append(self._current_ref_offset)
                self._allele_frequencies.append(af)
            if self._only_save_one_node_per_kmer:
                break

        self._last_ref_pos_added = self._current_ref_offset
        self._kmers_found += 1
        if len(self.kmers_found) < 500:
            if callable(kmer_string):
                kmer_string = kmer_string()
            self.kmers_found.append(
                (kmer_string, nodes, self._current_ref_offset, hash_))
        self._n_kmers_added_current_position += 1

    # -- branch walk (positions near forks) --------------------------------

    def _emit_current_path(self):
        bases = [b for b in self._path_bases if b >= 0]  # drop dummies
        assert len(bases) == self.k
        hash_ = int(np.array(bases, dtype=np.uint64) @ self._pv)

        def make_string():
            return "".join(numeric_to_letter_sequence(
                np.array(bases, dtype=np.int8)).tolist())

        self._emit(hash_, set(self._path_nodes), make_string)

    def _walk_branches(self, node, offset, bases_left):
        """Enumerate every k-base path from (node, offset) with an explicit
        stack, in the reference recursion's visit order: the linear-ref arm
        first, depth-first, with the variant-node budget accumulating
        across sibling arms and branch fan-out collapsing to linear arms
        once the budget is spent (snp_kmer_finder.py:228-289)."""
        g = self.graph
        path_bases, path_nodes = self._path_bases, self._path_nodes
        stack = [(int(node), int(offset), int(bases_left), 0)]
        while stack:
            node, offset, bases_left, trunc = stack.pop()
            del path_bases[trunc:]
            del path_nodes[trunc:]
            if bases_left == 0:
                self._emit_current_path()
                continue
            if not g.is_linear_ref_node_or_linear_ref_dummy_node(node):
                self._n_variant_nodes_passed += 1
            size = g.get_node_size(node)
            if size == 0:
                path_bases.append(-1)
                path_nodes.append(node)
            take = min(bases_left, size - offset)
            if take > 0:
                s0 = g.seq_start[node] + offset
                path_bases.extend(g.sequence[s0:s0 + take].tolist())
                path_nodes.extend([node] * take)
                bases_left -= take
                if bases_left == 0:
                    self._emit_current_path()
                    continue
            next_nodes = [int(v) for v in g.get_edges(node)]
            if len(next_nodes) > 1:
                self._has_traversed_variant = True
            if next_nodes and not g.is_linear_ref_node_or_linear_ref_dummy_node(
                    next_nodes[0]):
                next_nodes.reverse()  # linear-ref arm first
            if (len(next_nodes) > 1
                    and self._n_variant_nodes_passed >= self._max_variant_nodes):
                next_nodes = [
                    v for v in next_nodes
                    if g.is_linear_ref_node_or_linear_ref_dummy_node(v)]
            snap = len(path_bases)
            for v in reversed(next_nodes):  # LIFO: first arm pops first
                stack.append((v, 0, bases_left, snap))

    def _reset_position_state(self, linear_ref_pos):
        self._n_paths_searched = 0
        self._n_variant_nodes_passed = 0
        self._current_ref_offset = linear_ref_pos
        self._has_traversed_variant = False
        self._n_kmers_added_current_position = 0

    def _find_all_variant_kmers_from_position(self, linear_ref_pos):
        self._reset_position_state(linear_ref_pos)
        # start one bp before to catch node beginnings (so a position at a
        # fork boundary explores every outgoing arm)
        if linear_ref_pos > 0:
            node = self.graph.get_node_at_ref_offset(linear_ref_pos - 1)
            offset = self.graph.get_node_offset_at_ref_offset(
                linear_ref_pos - 1) + 1
        else:
            node = self.graph.get_node_at_ref_offset(linear_ref_pos)
            offset = self.graph.get_node_offset_at_ref_offset(linear_ref_pos)
        self._path_bases = []
        self._path_nodes = []
        self._walk_branches(node, offset, self.k)

    def find_kmers_from_linear_ref_position(self, pos):
        self._find_all_variant_kmers_from_position(pos)

    # -- vectorized sweep ---------------------------------------------------

    def _sweep_arrays(self):
        """Precompute the bulk sweep inputs: the concatenated linear-ref
        base tape, every window hash (one sliding-window kernel pass), and
        the sorted 'special' ref offsets near which a window must take the
        branch walk: ends of ref nodes that fork, dead-end (chromosome
        tails), bridge into anything but the next ref node, or are
        zero-length — plus the end of the reference itself."""
        g = self.graph
        ref_nodes, cum, refseq = g.linear_ref_sequence()
        ref_len = len(refseq)

        if self._use_device is not None:
            use_device = self._use_device
        else:
            use_device = (ref_len >= self.DEVICE_TAPE_THRESHOLD
                          and self._device is not None
                          and str(self._device).startswith("cuda"))
        if use_device:
            # torch comes in here and not with the module's own imports
            import torch
            from .device import resolve_device
            from .ops.encode import sliding_hashes
            # K1 on a CUDA device (its plain twin on "cpu"): the hash at
            # every tape position, cut to the full windows
            codes = torch.from_numpy(refseq.astype(np.int8))
            hashes = sliding_hashes(
                codes.to(resolve_device(self._device)), self.k
            ).cpu().numpy().view(np.uint64)[:max(0, ref_len - self.k + 1)]
        else:
            hashes = sliding_window_hashes(refseq.astype(np.uint64), self.k)

        specials = linear_ref_specials(g)
        af_ref = g.allele_frequencies[ref_nodes]
        return ref_nodes, cum, refseq, hashes, specials, af_ref

    def _emit_simple_window(self, pos, hash_, rev_hash, node_ids, af,
                            refseq):
        """Emit one fork-free window straight from the sweep arrays: the
        single DFS path is the reference window itself, its node set is
        the contiguous ref-node span, and zero variant nodes are touched."""
        self._reset_position_state(pos)

        def make_string():
            return "".join(numeric_to_letter_sequence(
                refseq[pos:pos + self.k]).tolist())

        self._emit(hash_, set(node_ids), make_string, rev_hash=rev_hash,
                   n_variant_nodes=0, allele_frequency=af)

    def find_kmers(self, _force_branch_walk=False):
        if self.reference is not None:
            logging.warning("Finding kmers on linear reference, not graph")
            self.find_kmers_on_linear_reference()
            return self.get_flat_kmers()

        g = self.graph
        if self._end_position is None:
            self._end_position = g.linear_ref_length()

        positions = []
        for i in range(self._start_position // self.spacing,
                       g.linear_ref_length() // self.spacing):
            pos = i * self.spacing
            if self._end_position is not None and pos >= self._end_position:
                break
            positions.append(pos)
        if not positions:
            return self.get_flat_kmers()

        ref_nodes, cum, refseq, hashes, specials, af_ref = self._sweep_arrays()
        pos_arr = np.asarray(positions, dtype=np.int64)
        k = self.k
        # a window [p, p+k) is 'simple' (single path = the ref window) iff
        # it contains no special offset s with p <= s < p+k
        n_specials_before = np.searchsorted(specials, pos_arr, side="left")
        n_specials_into = np.searchsorted(specials, pos_arr + k, side="left")
        simple = (n_specials_into == n_specials_before)
        if _force_branch_walk:
            simple[:] = False
        # node span per simple window (contiguous ref nodes, path order)
        i0 = np.searchsorted(cum, pos_arr, side="right") - 1
        i1 = np.searchsorted(cum, pos_arr + k - 1, side="right") - 1
        i1 = np.minimum(i1, len(ref_nodes) - 1)

        rev_hashes = None
        if (self._whitelist is not None
                or self._include_reverse_complements) and len(hashes):
            # len(hashes) == 0 (linear ref shorter than k) means every
            # window contains the end-of-reference special -> nothing is
            # simple and rev_hashes is never consumed; indexing the
            # empty array would crash. Simple windows otherwise satisfy
            # p + k <= ref_len, so pos_arr is always in range — the
            # minimum() only covers the 0-placeholders of non-simple rows
            safe = np.where(simple, pos_arr, 0)
            rev_hashes = kmer_hashes_to_reverse_complement_hash(
                hashes[np.minimum(safe, max(0, len(hashes) - 1))], k)

        haplo = self.haplotype_matrix is not None
        # batch-vectorized emission is valid when every filter that is
        # stateful-per-row is either inactive or expressible on arrays;
        # otherwise fork-free windows go one-by-one through _emit
        use_batch = (self._whitelist is None
                     and self._skip_kmers_with_nodes is None
                     and not self._only_add_variant_kmers
                     and not self.pruning
                     and not haplo
                     and not self._only_save_variant_nodes
                     and self._only_store_nodes is None
                     and self._max_kmers_same_position >= 1)
        j = 0
        n_pos = len(positions)
        while j < n_pos:
            if not simple[j]:
                self._find_all_variant_kmers_from_position(positions[j])
                j += 1
                continue
            if not use_batch:
                pos = positions[j]
                a, b = int(i0[j]), int(i1[j])
                node_ids = [int(v) for v in ref_nodes[a:b + 1]]
                af = None if haplo else float(af_ref[a:b + 1].min())
                rev = None if rev_hashes is None else int(rev_hashes[j])
                self._emit_simple_window(pos, int(hashes[pos]), rev,
                                         node_ids, af, refseq)
                j += 1
                continue
            je = j
            while je < n_pos and simple[je]:
                je += 1
            self._emit_simple_batch(
                pos_arr[j:je], hashes, i0[j:je], i1[j:je], ref_nodes,
                af_ref, refseq,
                None if rev_hashes is None else rev_hashes[j:je])
            j = je
        return self.get_flat_kmers()

    def _emit_simple_batch(self, pos_b, all_hashes, i0_b, i1_b, ref_nodes,
                           af_ref, refseq, rev_b):
        """Vectorized emission of a contiguous run of fork-free windows.

        Exactly equivalent to running each window through ``_emit`` under
        the batch-eligible flag combination: the only live stateful filter
        is the kmer-frequency cap, kept exact by a tight dict loop in
        position order (increment only for rows that pass, as the
        reference increments after all checks, snp_kmer_finder.py:162-167);
        the variant-node cap is the constant ``0 >= max_variant_nodes``
        here because fork-free windows touch only linear-ref nodes."""
        n = len(pos_b)
        h_b = all_hashes[pos_b]
        k = self.k
        rc = self._include_reverse_complements
        maxf = self._max_frequency
        freq = self._kmer_frequencies
        ok = np.ones(n, dtype=bool)

        if 0 >= self._max_variant_nodes:
            # constant-fail variant cap: read-only frequency pass for the
            # skip counters, nothing emitted
            for h in h_b.tolist():
                if freq[h] >= maxf:
                    self._n_skipped_due_to_frequency += 1
                else:
                    self._n_skipped_due_to_max_variant_nodes += 1
            self._n_paths_searched = 1
            self._n_kmers_added_current_position = 0
            self._current_ref_offset = int(pos_b[-1])
            self._has_traversed_variant = False
            return

        for t, h in enumerate(h_b.tolist()):
            c = freq[h]
            if c >= maxf:
                ok[t] = False
            else:
                freq[h] = c + 1
        n_ok = int(ok.sum())
        self._n_skipped_due_to_frequency += n - n_ok
        self._kmers_found += n_ok
        # per-position counters end at the LAST position's values, as if
        # each window had gone through _emit (_n_paths_searched: a
        # fork-free position searches exactly one path)
        self._n_paths_searched = 1
        self._n_kmers_added_current_position = 1 if bool(ok[-1]) else 0
        self._has_traversed_variant = False
        self._current_ref_offset = int(pos_b[-1])
        if n_ok:
            self._last_ref_pos_added = int(pos_b[np.nonzero(ok)[0][-1]])

        if len(self.kmers_found) < 500:
            for t in np.nonzero(ok)[0][:500 - len(self.kmers_found)]:
                p = int(pos_b[t])
                s = "".join(numeric_to_letter_sequence(
                    refseq[p:p + k]).tolist())
                node_set = set(
                    int(v) for v in ref_nodes[int(i0_b[t]):int(i1_b[t]) + 1])
                self.kmers_found.append((s, node_set, p, int(h_b[t])))

        multi = ok & (i1_b > i0_b)
        single = ok & ~multi
        span = (i1_b - i0_b + 1).astype(np.int64)
        if self._only_save_one_node_per_kmer:
            span = np.ones_like(span)
        mult = 2 if rc else 1
        rows_per = np.where(ok, span * mult, 0)
        starts = np.concatenate([[0], np.cumsum(rows_per)])
        total = int(starts[-1])
        out_h = np.empty(total, np.uint64)
        out_n = np.empty(total, np.uint32)
        out_o = np.empty(total, np.uint64)
        out_af = np.empty(total, np.float32)

        s_idx = np.nonzero(single)[0]
        s_start = starts[s_idx]
        out_h[s_start] = h_b[s_idx]
        out_n[s_start] = ref_nodes[i0_b[s_idx]]
        out_o[s_start] = pos_b[s_idx]
        out_af[s_start] = af_ref[i0_b[s_idx]]
        if rc:
            out_h[s_start + 1] = rev_b[s_idx]
            out_n[s_start + 1] = out_n[s_start]
            out_o[s_start + 1] = out_o[s_start]
            out_af[s_start + 1] = out_af[s_start]

        for t in np.nonzero(multi)[0]:
            a, b = int(i0_b[t]), int(i1_b[t])
            # python-set iteration order is the emission contract
            nodes_ordered = list(set(int(v) for v in ref_nodes[a:b + 1]))
            if self._only_save_one_node_per_kmer:
                nodes_ordered = nodes_ordered[:1]
            af = np.float32(af_ref[a:b + 1].min())
            p, h = int(pos_b[t]), h_b[t]
            st = int(starts[t])
            for node in nodes_ordered:
                out_h[st] = h
                out_n[st] = node
                out_o[st] = p
                out_af[st] = af
                st += 1
                if rc:
                    out_h[st] = rev_b[t]
                    out_n[st] = node
                    out_o[st] = p
                    out_af[st] = af
                    st += 1

        self._flush_rows()
        self._row_chunks.append((out_h, out_n, out_o, out_af))

    # -- output / linear mode ----------------------------------------------

    def _flush_rows(self):
        """Move pending list-rows into the ordered chunk list."""
        if self._hashes is not None and len(self._hashes):
            self._row_chunks.append(
                (np.array(self._hashes, dtype=np.uint64),
                 np.array(self._nodes, np.uint32),
                 np.array(self._ref_offsets, np.uint64),
                 np.array(self._allele_frequencies, np.single)))
            self._hashes, self._nodes = [], []
            self._ref_offsets, self._allele_frequencies = [], []

    def get_flat_kmers(self, v=None):
        tail = (np.array(self._hashes, dtype=np.uint64),
                np.array(self._nodes, np.uint32),
                np.array(self._ref_offsets, np.uint64),
                np.array(self._allele_frequencies, np.single))
        if not self._row_chunks:
            return FlatKmers(*tail)
        parts = self._row_chunks + [tail]
        return FlatKmers(*(np.concatenate([p[i] for p in parts])
                           for i in range(4)))

    def find_kmers_on_linear_reference(self):
        if self._end_position is None:
            # whole reference (the reference impl crashes here when no
            # interval is given, snp_kmer_finder.py:301; evident intent)
            self._end_position = max(0, len(self.reference) - self.k)
        seq = str(self.reference[self._start_position:
                                 self._end_position + self.k])
        assert len(seq) > 0, "No reference sequence in range"
        kmers = ReadKmers.get_kmers_from_read_dynamic(seq, power_array(self.k))
        kmers = kmers[::self.spacing]
        self._hashes = kmers
        self._nodes = np.zeros(len(kmers)) + 1
        self._ref_offsets = np.arange(
            self._start_position, self._start_position + len(seq),
            self.spacing)[:len(kmers)]
        self._allele_frequencies = np.zeros(len(kmers)) + 1.0


class IndelKmerFinder(SnpKmerFinder):
    """Vestigial subclass kept for API parity (reference
    indel_kmer_finder.py:3-13)."""
