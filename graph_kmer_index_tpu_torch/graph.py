"""Array-backed pangenome graph model (replaces the external ``obgraph``
package the reference depends on — see SURVEY.md L0 and the interface used
throughout the reference's kmer_finder.py, snp_kmer_finder.py,
critical_graph_paths.py). The port's copy of
graph_kmer_index_tpu/graph.py.

Design: everything is a flat numpy array indexed by node id (dense up to
max node id), so the whole graph ships to device as a handful of arrays:

- ``node_sizes[v]``            length of node v's sequence (0 = dummy node)
- ``sequence`` / ``seq_start`` concatenated 2-bit numeric bases, CSR offsets
- ``edge_targets``/``edge_index`` CSR adjacency preserving insertion order
  (edge order matters: it determines DFS emission order, reference
  kmer_finder.py:406)
- ``linear_ref_mask``          node is on the linear reference path
- ``ref_dummy_mask``           zero-length node bridging two *adjacent*
  linear-ref nodes (the reference allele of an insertion); these count as
  "linear ref or linear ref dummy" nodes (reference
  is_linear_ref_node_or_linear_ref_dummy_node semantics, pinned by
  tests/test_kmer_finder.py:test_max_variant_nodes and
  tests/test_critical_graph_paths.py:test4/test5)
- ``node_to_ref_offset[v]``    reference coordinate where v starts (exact
  cumulative for ref nodes; attachment offset for variant nodes)
"""
from __future__ import annotations


import numpy as np

from .hashing import letter_sequence_to_numeric, numeric_to_letter_sequence


class Graph:
    properties = {
        "node_sizes", "sequence", "seq_start", "edge_targets", "edge_index",
        "linear_ref_mask", "ref_dummy_mask", "node_to_ref_offset",
        "allele_frequencies", "chromosome_start_nodes_array",
    }

    def __init__(self, node_sizes, sequence, seq_start, edge_targets,
                 edge_index, linear_ref_mask, ref_dummy_mask,
                 node_to_ref_offset, allele_frequencies,
                 chromosome_start_nodes_array, chromosome_names=None):
        self.node_sizes = node_sizes
        self.sequence = sequence
        self.seq_start = seq_start
        self.edge_targets = edge_targets
        self.edge_index = edge_index
        self.linear_ref_mask = linear_ref_mask
        self.ref_dummy_mask = ref_dummy_mask
        self.node_to_ref_offset = node_to_ref_offset
        self.allele_frequencies = allele_frequencies
        self.chromosome_start_nodes_array = chromosome_start_nodes_array
        # optional, parallel to chromosome_start_nodes_array: the VCF/FASTA
        # chromosome names ("1", "chr1", "X", ...) for offset conversion
        self.chromosome_names = (None if chromosome_names is None
                                 else [str(c) for c in chromosome_names])

        self._ref_nodes_in_order = None
        self._ref_cum_offsets = None
        self._reverse_edge_index = None
        self._reverse_edge_targets = None

    # -- construction -------------------------------------------------------

    @classmethod
    def from_dicts(cls, node_sequences: dict, edges: dict, linear_ref_nodes,
                   allele_frequencies: dict | None = None,
                   chromosome_start_nodes=None, chromosome_names=None):
        """Build from literals, same shape as the reference's test fixtures
        (e.g. tests/test_kmer_finder.py:12-16): ``{node: "ACGT..."}``,
        ``{node: [next, ...]}``, ``[ref nodes in reference-path order]``.
        """
        max_id = max(node_sequences.keys())
        n = max_id + 1
        node_sizes = np.zeros(n, dtype=np.uint32)
        items = sorted(node_sequences.items())
        for node, s in items:
            node_sizes[node] = len(s)
        seq_start = np.zeros(n + 1, dtype=np.int64)
        seq_start[1:] = np.cumsum(node_sizes)
        # encode node-ordered SLABS of ~64 Mb (placing by seq_start is
        # then the identity): per-node encoding costs a python call per
        # node (~1 s per 300k nodes at chromosome scale), while one
        # whole-genome call would materialize a joined str + an 8 B/base
        # u64 transient (letter_sequence_to_numeric returns u64) — ~35
        # bytes/base peak at 3 Gb. Non-str sequences (bytes / numeric
        # arrays, which letter_sequence_to_numeric accepts per node)
        # flush the slab and encode individually.
        from .utils.hugepages import hp_empty
        sequence = hp_empty(int(seq_start[-1]), np.int8)
        _SLAB = 1 << 26
        buf: list[str] = []
        blen = wpos = 0

        def _flush():
            nonlocal buf, blen, wpos
            if blen:
                sequence[wpos:wpos + blen] = letter_sequence_to_numeric(
                    "".join(buf)).astype(np.int8)
                wpos += blen
                buf, blen = [], 0

        for _node, s in items:
            if isinstance(s, str):
                buf.append(s)
                blen += len(s)
                if blen >= _SLAB:
                    _flush()
            elif len(s):
                _flush()
                sequence[wpos:wpos + len(s)] = \
                    letter_sequence_to_numeric(s).astype(np.int8)
                wpos += len(s)
        _flush()
        assert wpos == seq_start[-1]

        edge_index = np.zeros(n + 1, dtype=np.int64)
        counts = np.zeros(n, dtype=np.int64)
        for node, targets in edges.items():
            counts[node] = len(targets)
        edge_index[1:] = np.cumsum(counts)
        edge_targets = np.zeros(edge_index[-1], dtype=np.int32)
        for node, targets in edges.items():
            edge_targets[edge_index[node]:edge_index[node + 1]] = targets

        linear_ref_nodes = list(linear_ref_nodes)
        linear_ref_mask = np.zeros(n, dtype=bool)
        linear_ref_mask[linear_ref_nodes] = True

        # linear-ref dummy nodes: zero-length nodes bridging two adjacent
        # ref nodes (u -> d -> v with v immediately after u on the ref path)
        ref_next = {u: v for u, v in zip(linear_ref_nodes, linear_ref_nodes[1:])}
        ref_dummy_mask = np.zeros(n, dtype=bool)
        candidates = np.nonzero((node_sizes == 0) & ~linear_ref_mask)[0]
        if len(candidates):  # pred map only when dummies can exist
            preds: dict[int, list[int]] = {}
            for u, targets in edges.items():
                for v in targets:
                    preds.setdefault(int(v), []).append(int(u))
            for node in candidates:
                outs = edge_targets[edge_index[node]:edge_index[node + 1]]
                for u in preds.get(int(node), ()):
                    if linear_ref_mask[u] and any(
                            ref_next.get(u) == v for v in outs):
                        ref_dummy_mask[node] = True
                        break

        node_to_ref_offset = cls._compute_ref_offsets(
            n, node_sizes, edge_targets, edge_index,
            linear_ref_mask, linear_ref_nodes)

        af = np.ones(n, dtype=np.float64)
        if allele_frequencies:
            for node, f in allele_frequencies.items():
                af[node] = f

        if chromosome_start_nodes is None:
            chromosome_start_nodes = [linear_ref_nodes[0]]
        return cls(node_sizes, sequence, seq_start, edge_targets, edge_index,
                   linear_ref_mask, ref_dummy_mask, node_to_ref_offset,
                   af, np.asarray(chromosome_start_nodes, dtype=np.int32),
                   chromosome_names=chromosome_names)

    @staticmethod
    def _compute_ref_offsets(n, node_sizes, edge_targets, edge_index,
                             linear_ref_mask, linear_ref_nodes):
        # exact cumulative offsets along the ref path; variant nodes get
        # the attachment offset max(pred_offset + pred_size). Computed by
        # vectorized max-relaxation over the non-ref-target edges: ref
        # offsets are fixed by the cumsum, so relaxation reaches the topo
        # fixpoint in (longest non-ref chain) rounds — 1-2 for SNP/indel
        # graphs — instead of a python Kahn walk over the whole ref chain
        off = np.zeros(n, dtype=np.int64)
        lr = np.asarray(linear_ref_nodes, dtype=np.int64)
        sizes_lr = node_sizes[lr].astype(np.int64)
        off[lr] = np.cumsum(sizes_lr) - sizes_lr

        src = np.repeat(np.arange(n, dtype=np.int64),
                        np.diff(edge_index))
        nonref = ~linear_ref_mask[edge_targets]
        src_nr = src[nonref]
        dst_nr = edge_targets[nonref].astype(np.int64)
        sz_nr = node_sizes[src_nr].astype(np.int64)
        for _ in range(n + 1):
            new = off.copy()
            np.maximum.at(new, dst_nr, off[src_nr] + sz_nr)
            if np.array_equal(new, off):
                break
            off = new
        return off

    # -- basic accessors (interface mirrored from obgraph usage) ------------

    @property
    def nodes(self):
        """Node-size array; the reference uses ``graph.nodes[node]`` as the
        node length and ``len(graph.nodes)`` as node count
        (snp_kmer_finder.py:243, :89)."""
        return self.node_sizes

    def n_nodes(self):
        return len(self.node_sizes)

    def max_node_id(self):
        return len(self.node_sizes) - 1

    def get_first_node(self):
        return int(self.chromosome_start_nodes_array[0])

    @property
    def chromosome_start_nodes(self):
        return {i: int(v) for i, v in enumerate(self.chromosome_start_nodes_array)}

    def get_node_size(self, node):
        return int(self.node_sizes[node])

    def get_edges(self, node):
        return self.edge_targets[self.edge_index[node]:self.edge_index[node + 1]]

    def get_numeric_node_sequence(self, node):
        return self.sequence[self.seq_start[node]:self.seq_start[node] +
                             self.node_sizes[node]]

    def get_numeric_base_sequence(self, node, offset):
        return int(self.sequence[self.seq_start[node] + offset])

    def get_node_sequence(self, node):
        return "".join(numeric_to_letter_sequence(
            self.get_numeric_node_sequence(node)).tolist())

    def get_node_subsequence(self, node, start, end):
        return "".join(numeric_to_letter_sequence(
            self.sequence[self.seq_start[node] + int(start):
                          self.seq_start[node] + int(end)]).tolist())

    def linear_ref_nodes(self):
        return set(np.nonzero(self.linear_ref_mask)[0].tolist())

    def is_linear_ref_node_or_linear_ref_dummy_node(self, node):
        return bool(self.linear_ref_mask[node] or self.ref_dummy_mask[node])

    def make_linear_ref_node_and_ref_dummy_node_index(self):
        return  # always precomputed here; kept for API parity

    def get_node_allele_frequency(self, node):
        return float(self.allele_frequencies[node])

    def get_node_allele_frequencies(self, nodes):
        return self.allele_frequencies[np.asarray(nodes, dtype=np.int64)]

    # -- reverse edges -------------------------------------------------------

    def _build_reverse(self):
        n = len(self.node_sizes)
        counts = np.zeros(n, dtype=np.int64)
        np.add.at(counts, self.edge_targets, 1)
        rindex = np.zeros(n + 1, dtype=np.int64)
        rindex[1:] = np.cumsum(counts)
        rtargets = np.zeros(len(self.edge_targets), dtype=np.int32)
        fill = rindex[:-1].copy()
        for u in range(n):
            for v in self.edge_targets[self.edge_index[u]:self.edge_index[u + 1]]:
                rtargets[fill[v]] = u
                fill[v] += 1
        self._reverse_edge_index = rindex
        self._reverse_edge_targets = rtargets

    def get_reverse_edges(self, node):
        if self._reverse_edge_index is None:
            self._build_reverse()
        return self._reverse_edge_targets[
            self._reverse_edge_index[node]:self._reverse_edge_index[node + 1]]

    def get_reverse_edges_hashtable(self):
        """node -> array of predecessors (reference
        critical_graph_paths.py:46 uses ``reverse_edges[node]``)."""
        if self._reverse_edge_index is None:
            self._build_reverse()
        graph = self

        class _Rev:
            def __getitem__(self, node):
                return graph.get_reverse_edges(node)
        return _Rev()

    def n_in_edges(self, node):
        if self._reverse_edge_index is None:
            self._build_reverse()
        return int(self._reverse_edge_index[node + 1] -
                   self._reverse_edge_index[node])

    # -- linear reference coordinates ----------------------------------------

    def _ref_index(self):
        if self._ref_nodes_in_order is None:
            ref = np.nonzero(self.linear_ref_mask)[0]
            order = np.argsort(self.node_to_ref_offset[ref], kind="stable")
            self._ref_nodes_in_order = ref[order]
            sizes = self.node_sizes[self._ref_nodes_in_order].astype(np.int64)
            self._ref_cum_offsets = np.concatenate(
                [[0], np.cumsum(sizes)])
        return self._ref_nodes_in_order, self._ref_cum_offsets

    def linear_ref_length(self):
        return int(self._ref_index()[1][-1])

    def linear_ref_sequence(self):
        """(ref_nodes_in_order, cumulative_offsets, concatenated numeric
        reference bases), cached — the bulk-sweep view of the linear
        reference used by SnpKmerFinder and the batched variant-signature
        selector."""
        if getattr(self, "_ref_seq_cache", None) is None:
            ref_nodes, cum = self._ref_index()
            ref_nodes = np.asarray(ref_nodes)
            parts = [self.sequence[self.seq_start[v]:
                                   self.seq_start[v] + self.node_sizes[v]]
                     for v in ref_nodes]
            refseq = (np.concatenate(parts) if parts
                      else np.zeros(0, dtype=np.int8))
            self._ref_seq_cache = (ref_nodes, cum, refseq)
        return self._ref_seq_cache

    def get_node_at_ref_offset(self, ref_offset):
        nodes, cum = self._ref_index()
        i = np.searchsorted(cum, ref_offset, side="right") - 1
        i = min(max(int(i), 0), len(nodes) - 1)
        return int(nodes[i])

    def get_node_offset_at_ref_offset(self, ref_offset):
        nodes, cum = self._ref_index()
        i = np.searchsorted(cum, ref_offset, side="right") - 1
        i = min(max(int(i), 0), len(nodes) - 1)
        return int(ref_offset - cum[i])

    def _chromosome_index(self, chromosome):
        """Index into chromosome_start_nodes_array for a VCF-style
        chromosome identifier. Resolution order: stored chromosome names
        (exact, then with/without a 'chr' prefix), then numeric 1-based
        ('1' = first chromosome — VCF numbering, NOT array index), then
        index 0 for single-chromosome graphs."""
        starts = self.chromosome_start_nodes_array
        c = str(chromosome)
        s = c[3:] if c.startswith("chr") else c
        names = self.chromosome_names
        if names:
            for cand in (c, s if c.startswith("chr") else "chr" + c):
                if cand in names:
                    return names.index(cand)
        if s.isdigit() and 1 <= int(s) <= len(starts):
            return int(s) - 1
        if len(starts) == 1:
            return 0
        raise ValueError(
            f"cannot resolve chromosome {chromosome!r} on a "
            f"{len(starts)}-chromosome graph (known names: {names})")

    def convert_chromosome_ref_offset_to_graph_ref_offset(self, ref_offset,
                                                          chromosome):
        starts = self.chromosome_start_nodes_array
        base = int(self.node_to_ref_offset[
            starts[self._chromosome_index(chromosome)]])
        return base + int(ref_offset)

    def get_node_at_chromosome_and_chromosome_offset(self, chromosome, offset):
        return self.get_node_at_ref_offset(
            self.convert_chromosome_ref_offset_to_graph_ref_offset(offset, chromosome))

    def get_node_offset_at_chromosome_and_chromosome_offset(self, chromosome, offset):
        return self.get_node_offset_at_ref_offset(
            self.convert_chromosome_ref_offset_to_graph_ref_offset(offset, chromosome))

    # -- serialization -------------------------------------------------------

    def to_file(self, file_name):
        extra = {}
        if self.chromosome_names is not None:
            extra["chromosome_names"] = np.asarray(self.chromosome_names)
        np.savez(file_name, **{p: getattr(self, p) for p in self.properties},
                 **extra)

    @classmethod
    def from_file(cls, file_name):
        try:
            data = np.load(file_name)
        except FileNotFoundError:
            data = np.load(str(file_name) + ".npz")
        names = (list(data["chromosome_names"])
                 if "chromosome_names" in data.files else None)
        return cls(**{p: data[p] for p in cls.properties},
                   chromosome_names=names)


class PositionId:
    """Unique integer id per (node, offset) graph position; replaces
    ``obgraph.position_id.PositionId`` (used in reference
    kmer_finder.py:109-126 for FlatKmers v='1' ref offsets).

    id = start_id[node] + offset with start ids from cumsum(sizes + 1), so
    zero-length (dummy) nodes still get distinct ids.
    """

    def __init__(self, start_ids):
        self._start_ids = start_ids

    @classmethod
    def from_graph(cls, graph: Graph):
        sizes = graph.node_sizes.astype(np.int64)
        start_ids = np.zeros(len(sizes) + 1, dtype=np.int64)
        start_ids[1:] = np.cumsum(sizes + 1)
        return cls(start_ids[:-1])

    def get(self, nodes, offsets):
        nodes = np.asarray(nodes, dtype=np.int64)
        offsets = np.asarray(offsets, dtype=np.int64)
        return (self._start_ids[nodes] + offsets).astype(np.uint64)


class VariantToNodes:
    """ref_node/var_node arrays per VCF variant (replaces
    obgraph.variant_to_nodes.VariantToNodes)."""
    properties = {"ref_nodes", "var_nodes"}

    def __init__(self, ref_nodes=None, var_nodes=None):
        self.ref_nodes = ref_nodes
        self.var_nodes = var_nodes

    def __iter__(self):
        return zip(self.ref_nodes, self.var_nodes)

    def __len__(self):
        return len(self.ref_nodes)

    def to_file(self, file_name):
        np.savez(file_name, ref_nodes=self.ref_nodes, var_nodes=self.var_nodes)

    @classmethod
    def from_file(cls, file_name):
        try:
            data = np.load(file_name)
        except FileNotFoundError:
            data = np.load(str(file_name) + ".npz")
        return cls(data["ref_nodes"], data["var_nodes"])
