"""DenseKmerFinder — enumerate ALL k-mers over all bounded-variant paths
of a pangenome graph.

The port's copy of graph_kmer_index_tpu/finder.py: a device-first inversion
of the reference's recursive per-base DFS (kmer_finder.py:37-434): the host walks
the graph in *spans* (maximal runs of window positions whose covered
node-set is constant), appending only compact span descriptors and a base
tape; ALL hashing happens afterwards in one batched sliding-window kernel
(ops.encode.sliding_hashes, kernel K1, on the finder's CUDA device;
hashing.sliding_window_hashes on the host otherwise), and rows are expanded with vectorized
repeat/gather. Per-base Python work is confined to window build-up near
bubbles; long linear stretches cost O(1) descriptors.

Output is bit-identical to the reference, including row ORDER (pinned by
reference tests/test_kmer_finder.py:test_case1):

- one row per (window, unique node in window), nodes ascending
  (kmer_finder.py:134,151-161);
- window node-set = nodes of all path elements from the element of the
  window's first base through its last, dummy (zero-length) nodes between
  them included (kmer_finder.py:261-266,419-434); the first full window of
  a search includes everything from the search start;
- DFS follows graph edge order; at ``max_variant_nodes`` distinct variant
  nodes in the window, only the linear-ref arm is followed
  (kmer_finder.py:383-417);
- traversal state dedup on (node, offset, frozenset(window nodes))
  (kmer_finder.py:311-319), here interval-compressed per (node, node-set);
- searches stop at critical positions (next window would be single-path),
  which are the segment/shard boundaries (kmer_finder.py:333-340).
"""
from __future__ import annotations

import numpy as np

from .containers import NpList
from .critical_paths import CriticalGraphPaths
from .flat_kmers import FlatKmers, FlatKmers2
from .graph import Graph, PositionId
from .hashing import sliding_window_hashes

# device hashing kicks in above this tape size
_DEVICE_TAPE_THRESHOLD = 1 << 20


class _TreatedIntervals:
    """(node, frozenset(window nodes)) -> set of treated offset intervals.

    Interval-compressed equivalent of the reference's per-base
    ``_positions_treated`` set (kmer_finder.py:311-319): a span insert/query
    costs O(#intervals) instead of O(#bases).
    """

    __slots__ = ("_map",)

    def __init__(self):
        self._map: dict = {}

    def first_hit(self, node, fs, o1, o2, exempt=None):
        """Smallest treated offset in [o1, o2] (skipping ``exempt``), or None."""
        intervals = self._map.get((node, fs))
        if not intervals:
            return None
        candidate = o1
        while candidate <= o2:
            best = None
            for a, b in intervals:
                if b >= candidate and a <= o2:
                    p = max(a, candidate)
                    if best is None or p < best:
                        best = p
            if best is None:
                return None
            if best == exempt:
                candidate = best + 1
                continue
            return best
        return None

    def add(self, node, fs, o1, o2):
        if o2 < o1:
            return
        self._map.setdefault((node, fs), []).append((o1, o2))


def _dedup_span_nodes(raw_nl, raw_nodes, af_table, only_save_one=False,
                      only_store_nodes=None):
    """Vectorized per-span node-set resolution shared by the host and
    device finalize paths: dedup ascending, min allele frequency,
    only_save_one/only_store filters — semantics of the reference's
    per-kmer _add_kmer (kmer_finder.py:128-168).

    raw_nl[i] = length of span i's raw node list; raw_nodes = the
    concatenated lists. Returns (nl, ns, span_nodes, s_af): per-span
    deduped list lengths, exclusive starts, concatenated deduped node
    lists, and per-span min allele frequency (over the RAW list).
    """
    raw_nl = np.asarray(raw_nl, dtype=np.int64)
    n_spans = len(raw_nl)
    span_id = np.repeat(np.arange(n_spans), raw_nl)
    af_raw = af_table[raw_nodes]
    seg_starts = np.concatenate([[0], np.cumsum(raw_nl)[:-1]])
    s_af = np.minimum.reduceat(af_raw, seg_starts) \
        if len(af_raw) else np.zeros(0)
    order = np.lexsort((raw_nodes, span_id))
    sid = span_id[order]
    vals = raw_nodes[order]
    first = np.ones(len(vals), dtype=bool)
    first[1:] = (sid[1:] != sid[:-1]) | (vals[1:] != vals[:-1])
    u_sid = sid[first]
    u_vals = vals[first]
    if only_save_one:
        keep1 = np.ones(len(u_sid), dtype=bool)
        keep1[1:] = u_sid[1:] != u_sid[:-1]
        u_sid, u_vals = u_sid[keep1], u_vals[keep1]
    if only_store_nodes is not None:
        allowed = np.array(sorted(only_store_nodes), dtype=np.int64)
        keep2 = np.isin(u_vals, allowed)
        u_sid, u_vals = u_sid[keep2], u_vals[keep2]
    nl = np.bincount(u_sid, minlength=n_spans).astype(np.int64)
    ns = np.concatenate([[0], np.cumsum(nl)[:-1]])
    return nl, ns, u_vals, s_af


class DenseKmerFinder:
    """Find all k-mers in a graph (API-compatible with the reference class,
    kmer_finder.py:37-105)."""

    def __init__(self, graph: Graph, k: int, critical_graph_paths=None,
                 position_id=None, only_save_one_node_per_kmer=False,
                 max_variant_nodes=4, only_store_variant_nodes=False,
                 start_at_critical_path_number=None,
                 stop_at_critical_path_number=None,
                 whitelist=None, only_store_nodes=None,
                 only_follow_nodes=None, use_device=None, device="cuda"):
        """``use_device``/``device``: where the vectorized finalize hashes
        its tape. ``use_device=True`` hashes on ``device`` (required
        then); ``False`` on the host; ``None`` on ``device`` when it is a
        CUDA device and the tape has at least ``_DEVICE_TAPE_THRESHOLD``
        bases, else on the host. The default device is the card, as the
        JAX package picks the accelerator: a large tape on a machine
        without one raises (pass ``device="cpu"`` to hash it on the
        host)."""
        if only_store_variant_nodes:
            # dead flag in the reference too: kmer_finder.py:75 asserts
            # an undefined name (NameError) and no code ever applies the
            # filter. Fail loudly rather than silently emitting
            # unfiltered rows; only_store_nodes covers the use case.
            raise NotImplementedError(
                "only_store_variant_nodes is non-functional in the "
                "reference (kmer_finder.py:74-76 asserts an undefined "
                "name and never filters); pass only_store_nodes with "
                "the variant node ids instead")
        self._graph = graph
        self._k = k
        self._only_save_one_node_per_kmer = only_save_one_node_per_kmer
        self._max_variant_nodes = max_variant_nodes
        self._critical_graph_paths = critical_graph_paths
        self._position_id = position_id
        self._start_at_critical_path_number = start_at_critical_path_number
        self._stop_at_critical_path_number = stop_at_critical_path_number
        self._whitelist = whitelist
        self._only_store_nodes = only_store_nodes
        self._only_follow_nodes = only_follow_nodes
        self._use_device = use_device
        self._device = device

        # per-branch path state (truncated on DFS backtrack)
        self._elem_nodes = NpList(dtype=np.int32)   # node per path element
        self._elem_bases = NpList(dtype=np.int8)    # base per element (-1 dummy)
        self._ne_pos = NpList(dtype=np.int64)       # element index per nonempty base
        self._ne_bases = NpList(dtype=np.int8)      # nonempty base stream
        self._blk_node = NpList(dtype=np.int32)     # path blocks: node ids
        self._blk_first = NpList(dtype=np.int64)    # path blocks: first element

        # emission state (append-only, global across the find() call)
        self._tape = NpList(dtype=np.int8)
        self._span_tape_start = NpList(dtype=np.int64)
        self._span_n_windows = NpList(dtype=np.int32)
        self._span_node = NpList(dtype=np.int32)
        self._span_first_offset = NpList(dtype=np.int32)
        self._span_af = NpList(dtype=np.float64)
        self._span_nodes_start = NpList(dtype=np.int64)
        self._span_nodes_len = NpList(dtype=np.int32)
        self._span_nodes = NpList(dtype=np.int32)   # concatenated node lists

        self._treated = _TreatedIntervals()
        self._early_stop = False
        self._n_nodes_skipped_because_too_complex = 0
        self._n_skipped_whitelist = 0

        # whether the last find() ran in the native C++ span walker
        self.used_native_walker = False
        self._finalized = None
        self._kmers_found_dbg = []
        self._kmers_found_explicit = False
        self._kmers_found_fresh = False
        self.results = []

    # -- public API -----------------------------------------------------

    @property
    def kmers_found(self):
        """Debug list of the first ~500 found windows (reference
        kmer_finder.py ``kmers_found``). In the whitelist-free case it
        rebuilds from the first few spans only (cap-bounded, cached) —
        reading a debug list must not trigger the multi-GB row expansion
        the lazy finalize avoids; with a whitelist the list is
        win_ok-filtered, so the full finalize runs. An explicitly
        assigned value (reference plain-attribute semantics) is returned
        as-is until the next find()."""
        if self._kmers_found_explicit:
            return self._kmers_found_dbg
        if self._finalized is None and self._whitelist is None:
            if not self._kmers_found_fresh:
                self._rebuild_kmers_found_debug()
                self._kmers_found_fresh = True
            return self._kmers_found_dbg
        self._results()
        return self._kmers_found_dbg

    @kmers_found.setter
    def kmers_found(self, value):
        # reference API compatibility: kmers_found is a plain mutable
        # attribute there (callers may reset it between chunks)
        self._kmers_found_dbg = value
        self._kmers_found_explicit = True

    def find(self, use_native=None):
        """Full-graph enumeration from critical starting points
        (reference kmer_finder.py:179-244). The traversal control plane
        runs in the native C++ span walker when available (identical span
        stream, differential-tested); Python otherwise."""
        if self._critical_graph_paths is None:
            self._critical_graph_paths = CriticalGraphPaths.from_graph(
                self._graph, self._k)
        cgp = self._critical_graph_paths
        n_paths = len(cgp)

        # All worklist/seen-point construction is vectorized: a chunked
        # find constructs one finder per critical-path chunk, so anything
        # O(n_paths) here multiplies by the chunk count (quadratic at
        # chromosome scale).
        seen_nodes, seen_offsets = cgp.reversed_points()

        stop_at_node = None
        if (self._stop_at_critical_path_number is not None
                and self._stop_at_critical_path_number < n_paths):
            # == list(cgp)[::-1][-stop-1][0], i.e. path-order entry `stop`
            stop_at_node = int(cgp.nodes[self._stop_at_critical_path_number])

        # worklist: path-order slice [start:], reversed (the walk consumes
        # from the back, reference kmer_finder.py:190-221 ordering).
        # Clamp negative starts to 0: the old tuple code only sliced for
        # start > 0, so a negative value meant "full worklist".
        lo = max(0, int(self._start_at_critical_path_number or 0))
        n_wl = max(0, n_paths - lo)
        extra = None
        if not self._start_at_critical_path_number:
            first = self._graph.get_first_node()
            if self._graph.get_node_size(first) <= self._k:
                extra = (int(first), 0)
        wl_nodes = np.empty(n_wl + (extra is not None), dtype=np.int64)
        wl_offsets = np.empty_like(wl_nodes)
        if n_wl:
            wl_nodes[:n_wl] = seen_nodes[:n_wl]
            wl_offsets[:n_wl] = seen_offsets[:n_wl]
        if extra is not None:
            wl_nodes[n_wl], wl_offsets[n_wl] = extra

        # finalization (span stream -> expanded rows) is LAZY: _results()
        # runs it on first access. Span-only consumers (the pooled find's
        # workers return compact tapes for the parent's device expansion)
        # never pay for row expansion — which is mostly multi-GB output
        # buffer population at chromosome scale, ~4x the walk itself.
        self._finalized = None
        self._kmers_found_explicit = False
        self._kmers_found_fresh = False

        if use_native is None:
            use_native = True
        self.used_native_walker = bool(
            use_native and self._find_native((wl_nodes, wl_offsets),
                                             (seen_nodes, seen_offsets),
                                             stop_at_node))
        if self.used_native_walker:
            return

        self._starting_points = list(zip(wl_nodes.tolist(),
                                         wl_offsets.tolist()))
        self._starting_points_set = set(zip(cgp.nodes.tolist(),
                                            cgp.offsets.tolist()))
        while self._starting_points:
            critical_node, critical_offset = self._starting_points.pop()
            if stop_at_node is not None and stop_at_node == critical_node:
                break
            self._start_search(critical_node, critical_offset)

    def _find_native(self, worklist, seen_points, stop_at_node,
                     early_stop=False) -> bool:
        """Run the C++ span walker; load its span stream into the
        emission buffers. False => caller uses the Python walker."""
        from . import native
        if not native.available():
            return False
        cgp = self._critical_graph_paths
        n = self._graph.n_nodes()
        crit = cgp.dense_index(n)  # cached across chunked-find calls
        res = native.walk(
            self._graph, crit, self._k, self._max_variant_nodes,
            worklist=worklist, seen_points=seen_points,
            stop_at_node=-1 if stop_at_node is None else int(stop_at_node),
            early_stop=early_stop,
            only_follow_nodes=self._only_follow_nodes)
        if res is None:
            return False
        tape, ts, nw, s_node, s_off, nl, span_nodes = res
        self._tape.extend(tape)
        self._span_tape_start.extend(ts)
        self._span_n_windows.extend(nw)
        self._span_node.extend(s_node)
        self._span_first_offset.extend(s_off)
        self._span_nodes_len.extend(nl)
        self._span_nodes.extend(span_nodes)
        return True

    def find_only_kmers_starting_at_position(self, node, offset,
                                             use_native=None):
        """Early-stop mode: emit the first full window of every DFS branch
        from (node, offset) (reference kmer_finder.py:170-177)."""
        self._early_stop = True
        self._kmers_found_explicit = False
        self._kmers_found_fresh = False
        self._critical_graph_paths = CriticalGraphPaths.empty()
        self._starting_points = []
        self._starting_points_set = set()
        self._crit_node, self._crit_offset = int(node), int(offset)

        if use_native is None:
            use_native = True
        if use_native and self._find_native([(int(node), int(offset))], [],
                                            None, early_stop=True):
            self._finalize()
            return

        self._reset_branch_state()
        self._search(int(node), int(offset))
        self._finalize()

    def get_flat_kmers(self, v="2"):
        kmers, nodes, start_nodes, start_offsets, af = self._results()
        if v in ("0", "1"):
            if v == "1":
                if self._position_id is None:
                    self._position_id = PositionId.from_graph(self._graph)
                ref_offsets = self._position_id.get(start_nodes, start_offsets)
            else:
                ref_offsets = (self._graph.node_to_ref_offset[start_nodes]
                               + start_offsets)
            return FlatKmers(kmers, nodes, ref_offsets, af)
        return FlatKmers2(kmers, start_nodes, start_offsets, nodes, af)

    def get_found_kmers_and_nodes(self):
        kmers, nodes, *_ = self._results()
        return kmers, nodes

    # -- search loop ------------------------------------------------------

    def _reset_branch_state(self):
        for lst in (self._elem_nodes, self._elem_bases, self._ne_pos,
                    self._ne_bases, self._blk_node, self._blk_first):
            lst.set_n_elements(0)

    def _start_search(self, critical_node, critical_offset):
        self._crit_node = critical_node
        self._crit_offset = critical_offset
        self._reset_branch_state()
        offset = critical_offset
        if offset >= self._k - 1:
            offset -= self._k - 1
        self._search(critical_node, offset)

    def _search(self, node, offset):
        """Iterative DFS: explicit stack of (node, offset, state snapshot)."""
        stack = [(node, offset, self._snapshot())]
        while stack:
            cur_node, cur_offset, snap = stack.pop()
            self._restore(snap)
            status = self._process_entry(cur_node, cur_offset)
            if status != "CONT":
                continue
            children = self._next_nodes(cur_node)
            if children:
                snap = self._snapshot()
                for child in reversed(children):
                    stack.append((child, 0, snap))

    def _snapshot(self):
        return (len(self._elem_nodes), len(self._ne_pos), len(self._blk_node))

    def _restore(self, snap):
        n_elems, n_ne, n_blk = snap
        self._elem_nodes.set_n_elements(n_elems)
        self._elem_bases.set_n_elements(n_elems)
        self._ne_pos.set_n_elements(n_ne)
        self._ne_bases.set_n_elements(n_ne)
        self._blk_node.set_n_elements(n_blk)
        self._blk_first.set_n_elements(n_blk)

    # -- node processing ----------------------------------------------------

    def _process_entry(self, node, offset):
        g = self._graph
        size = g.get_node_size(node)

        if offset == 0 and size == 0:
            # dummy node: sentinel element, no hash digits
            # (reference kmer_finder.py:261-266)
            self._blk_node.append(node)
            self._blk_first.append(len(self._elem_nodes))
            self._elem_nodes.append(node)
            self._elem_bases.append(-1)
            return "CONT"

        self._blk_node.append(node)
        self._blk_first.append(len(self._elem_nodes))

        while offset < size:
            if len(self._ne_pos) < self._k:
                if len(self._elem_nodes) == len(self._ne_pos):
                    # no dummy elements in path => the per-base treated
                    # check can't fire during build-up; take the bulk path
                    status, offset = self._bulk_buildup(node, offset, size)
                else:
                    status = self._step_base(node, offset)
                    offset += 1
            else:
                status = self._process_run(node, offset)
                offset = size
            if status != "CONT":
                return status
        return "CONT"

    def _bulk_buildup(self, node, offset, size):
        """Vectorized build-up: append all bases of this node needed to
        fill the window in one shot (same semantics as m calls to
        _step_base when the path holds no dummy elements)."""
        g = self._graph
        k = self._k
        m = min(k - len(self._ne_pos), size - offset)

        # stop before an in-node critical position (reference per-base
        # is_critical(node, offset+1) check, kmer_finder.py:333-340)
        stop_at = None
        c = self._critical_offset_of(node)
        if (c is not None and offset < c <= offset + m
                and not (node == self._crit_node and c == self._crit_offset)):
            m = c - offset
            stop_at = c
        if m <= 0:
            if stop_at is not None:
                self._queue_starting_point(node, stop_at)
                return "STOP", offset
            return "CONT", offset

        bases = np.asarray(
            g.sequence[g.seq_start[node] + offset:
                       g.seq_start[node] + offset + m])
        elem0 = len(self._elem_nodes)
        self._elem_nodes.extend(np.full(m, node, dtype=np.int32))
        self._elem_bases.extend(bases)
        self._ne_pos.extend(np.arange(elem0, elem0 + m, dtype=np.int64))
        self._ne_bases.extend(bases)

        fs = frozenset(self._blk_node.get_nparray().tolist())
        # the window-completing base must run the same treated check as
        # _step_base (len(elem_nodes)==k fires it there); earlier bulk
        # bases can't fire it because m = min(k - len, ...) means only
        # the last base can bring the path length to k
        if len(self._elem_nodes) >= k:
            last = offset + m - 1
            exempt = (last if (node == self._crit_node
                               and last == self._crit_offset) else None)
            if self._treated.first_hit(node, fs, last, last, exempt) is not None:
                # per-base semantics: the pruned base itself is NOT added
                if m > 1:
                    self._treated.add(node, fs, offset, last - 1)
                return "PRUNE", offset + m
        self._treated.add(node, fs, offset, offset + m - 1)

        status = "CONT"
        if len(self._ne_pos) >= k:
            # the last appended base completed the first window
            self._emit_span(node, offset + m - 1, 1, block_from=0,
                            t_first=len(self._ne_pos) - 1)
            if self._early_stop:
                status = "EARLY"
        if status == "CONT" and stop_at is not None:
            self._queue_starting_point(node, stop_at)
            status = "STOP"
        return status, offset + m

    def _step_base(self, node, offset):
        """One build-up base (window not yet full); exact per-base semantics
        of the reference loop (kmer_finder.py:268-342)."""
        g = self._graph
        base = g.get_numeric_base_sequence(node, offset)
        elem_idx = len(self._elem_nodes)
        self._elem_nodes.append(node)
        self._elem_bases.append(base)
        self._ne_pos.append(elem_idx)
        self._ne_bases.append(base)
        t = len(self._ne_pos) - 1  # index of this nonempty base

        # window start pointer: build-up => everything since search start
        fs = frozenset(self._blk_node.get_nparray().tolist())
        exempt = (offset if (node == self._crit_node
                             and offset == self._crit_offset) else None)
        if len(self._elem_nodes) >= self._k:
            hit = self._treated.first_hit(node, fs, offset, offset, exempt)
            if hit is not None:
                return "PRUNE"
        self._treated.add(node, fs, offset, offset)

        if t >= self._k - 1:
            self._emit_span(node, offset, 1, block_from=0, t_first=t)
            if self._early_stop:
                return "EARLY"

        if ((node != self._crit_node or offset + 1 != self._crit_offset)
                and self._critical_graph_paths.is_critical(node, offset + 1)):
            self._queue_starting_point(node, offset + 1)
            return "STOP"
        return "CONT"

    def _process_run(self, node, o_start):
        """Window already full: process offsets [o_start, node end) in
        constant-node-set subruns. Replaces both the reference's sliding
        per-base loop and its long-node ``np.convolve`` fast path
        (kmer_finder.py:272-273,349-381) with span descriptors."""
        g = self._graph
        size = g.get_node_size(node)
        k = self._k

        # critical position inside this node => stop before it
        process_end = size
        stop_at = None
        c = self._critical_offset_of(node)
        if (c is not None and o_start + 1 <= c <= size
                and not (node == self._crit_node and c == self._crit_offset)):
            process_end = c
            stop_at = c
        n = process_end - o_start
        if n <= 0:
            if stop_at is not None:
                self._queue_starting_point(node, stop_at)
                return "STOP"
            return "CONT"

        bases = np.asarray(
            g.sequence[g.seq_start[node] + o_start:
                       g.seq_start[node] + process_end])
        t0 = len(self._ne_pos)
        elem0 = len(self._elem_nodes)
        self._elem_nodes.extend(np.full(n, node, dtype=np.int32))
        self._elem_bases.extend(bases)
        self._ne_pos.extend(np.arange(elem0, elem0 + n, dtype=np.int64))
        self._ne_bases.extend(bases)

        # window-start elements and their path blocks
        ne_pos = self._ne_pos.get_nparray()
        starts = ne_pos[t0 - k + 1: t0 - k + 1 + n]
        blk_first = self._blk_first.get_nparray()
        b = np.searchsorted(blk_first, starts, side="right") - 1
        boundaries = np.flatnonzero(np.diff(b)) + 1
        group_starts = np.concatenate([[0], boundaries])
        group_ends = np.concatenate([boundaries, [n]])

        blk_nodes = self._blk_node.get_nparray()
        for ga, gb in zip(group_starts, group_ends):
            bb = int(b[ga])
            fs = frozenset(blk_nodes[bb:].tolist())
            o1 = o_start + int(ga)
            o2 = o_start + int(gb) - 1
            exempt = (self._crit_offset
                      if (node == self._crit_node
                          and o1 <= self._crit_offset <= o2) else None)
            hit = self._treated.first_hit(node, fs, o1, o2, exempt)
            emit_end = (hit - 1) if hit is not None else o2
            self._treated.add(node, fs, o1, emit_end)
            if emit_end >= o1:
                self._emit_span(node, o1, emit_end - o1 + 1,
                                block_from=bb, t_first=t0 + int(ga))
            if hit is not None:
                return "PRUNE"

        if stop_at is not None:
            self._queue_starting_point(node, stop_at)
            return "STOP"
        return "CONT"

    def _critical_offset_of(self, node):
        cgp = self._critical_graph_paths
        if cgp is None or len(cgp) == 0:
            return None
        if cgp._index is None:
            cgp._make_index()
        if node >= len(cgp._index):
            return None
        off = int(cgp._index[node])
        return off if off >= 0 else None

    def _queue_starting_point(self, node, offset):
        if (node, offset) not in self._starting_points_set:
            self._starting_points.append((node, offset))
            self._starting_points_set.add((node, offset))

    # -- edges ----------------------------------------------------------------

    def _next_nodes(self, node):
        """Successors to follow, with the max-variant-nodes clamp
        (reference kmer_finder.py:383-417)."""
        g = self._graph
        next_nodes = [int(v) for v in g.get_edges(node)]
        if not next_nodes:
            return []
        force_follow = False
        if self._only_follow_nodes is not None:
            restricted = [v for v in next_nodes if v in self._only_follow_nodes]
            if restricted:
                next_nodes = restricted
                force_follow = True

        # variant nodes currently in the window
        blk_nodes = self._blk_node.get_nparray()
        bb = self._current_window_block()
        window_nodes = blk_nodes[bb:]
        n_variant = sum(
            1 for v in set(window_nodes.tolist())
            if not g.is_linear_ref_node_or_linear_ref_dummy_node(v))

        if not force_follow and n_variant >= self._max_variant_nodes:
            self._n_nodes_skipped_because_too_complex += len(next_nodes)
            next_nodes = [v for v in next_nodes
                          if g.is_linear_ref_node_or_linear_ref_dummy_node(v)]
            assert len(next_nodes) == 1, (
                f"Not 1 linear ref next node from node {node}: {next_nodes}")
            self._n_nodes_skipped_because_too_complex -= len(next_nodes)
        return next_nodes

    def _current_window_block(self):
        """Index of the path block containing the current window start."""
        k = self._k
        if len(self._ne_pos) < k:
            return 0
        start_elem = self._ne_pos[len(self._ne_pos) - k]
        # NB: reference pointer after processing base t is ne_pos[t-k+1]
        blk_first = self._blk_first.get_nparray()
        return int(np.searchsorted(blk_first, start_elem, side="right") - 1)

    # -- emission --------------------------------------------------------------

    def _emit_span(self, node, first_offset, n_windows, block_from, t_first):
        """Record a span descriptor. The window node set is stored RAW
        (path blocks from ``block_from``); dedup, allele-frequency min and
        the only_save_one/only_store filters are applied vectorized over
        all spans at once in _finalize (the reference does all of that
        per-kmer in _add_kmer, kmer_finder.py:128-168)."""
        k = self._k
        blk_nodes = self._blk_node.get_nparray()
        raw_nodes = blk_nodes[block_from:]

        ne_bases = self._ne_bases.get_nparray()
        tape_slice = ne_bases[t_first - k + 1: t_first + n_windows]
        self._span_tape_start.append(len(self._tape))
        self._tape.extend(tape_slice)
        self._span_n_windows.append(n_windows)
        self._span_node.append(node)
        self._span_first_offset.append(first_offset)
        self._span_nodes_start.append(len(self._span_nodes))
        self._span_nodes_len.append(len(raw_nodes))
        self._span_nodes.extend(raw_nodes.astype(np.int32))

    # -- finalize: batched hashing + row expansion ------------------------------

    def _rebuild_kmers_found_debug(self, cap=500):
        """Reconstruct the kmers_found debug list (first ``cap`` windows,
        python-path semantics) after a native finalize — cheap: only the
        first few spans are visited."""
        k = self._k
        tape = self._tape.get_nparray()
        ts = self._span_tape_start.get_nparray()
        nw = self._span_n_windows.get_nparray()
        s_node = self._span_node.get_nparray()
        raw_nl = self._span_nodes_len.get_nparray()
        raw_nodes = self._span_nodes.get_nparray()
        out: list = []
        pos = 0
        for sp in range(len(ts)):
            raw = raw_nodes[pos: pos + raw_nl[sp]]
            pos += raw_nl[sp]
            if len(out) >= cap:
                break
            uniq = sorted(set(raw.tolist()))
            if self._only_save_one_node_per_kmer:
                uniq = uniq[:1]
            if self._only_store_nodes is not None:
                uniq = [v for v in uniq if v in self._only_store_nodes]
            span_tape = np.maximum(
                tape[ts[sp]: ts[sp] + k - 1 + nw[sp]], 0).astype(np.uint64)
            hashes = sliding_window_hashes(span_tape, k)
            for w in range(int(nw[sp])):
                if len(out) >= cap:
                    break
                out.append((None, set(uniq), int(s_node[sp]),
                            int(hashes[w])))
        self._kmers_found_dbg = out

    def _finalize_small(self):
        """Scalar finalize for tiny searches (the per-candidate early-stop
        calls inside UniqueVariantKmersFinder): identical semantics to the
        vectorized path, but plain python loops — below ~32 spans the
        numpy fixed overhead dominates. Equality with the vector path is
        pinned by tests (force_path=...)."""
        k = self._k
        tape = self._tape.get_nparray()
        hashes = sliding_window_hashes(
            np.maximum(tape, 0).astype(np.uint64), k)
        ts = self._span_tape_start.get_nparray()
        nw = self._span_n_windows.get_nparray()
        s_node = self._span_node.get_nparray()
        s_off = self._span_first_offset.get_nparray()
        raw_nl = self._span_nodes_len.get_nparray()
        raw_nodes = self._span_nodes.get_nparray()
        af_table = self._graph.allele_frequencies
        n_spans = len(ts)

        win_kmers = np.concatenate(
            [hashes[ts[sp]: ts[sp] + nw[sp]] for sp in range(n_spans)])
        ok = self._whitelist_mask(win_kmers)

        out_kmers: list = []
        out_nodes: list = []
        out_sn: list = []
        out_so: list = []
        out_af: list = []
        kmers_found: list = []
        wi = 0
        pos = 0
        for sp in range(n_spans):
            raw = raw_nodes[pos: pos + raw_nl[sp]]
            pos += raw_nl[sp]
            af = float(af_table[raw].min())
            uniq = sorted(set(raw.tolist()))
            if self._only_save_one_node_per_kmer:
                uniq = uniq[:1]
            if self._only_store_nodes is not None:
                uniq = [v for v in uniq if v in self._only_store_nodes]
            node_sp = int(s_node[sp])
            off_sp = int(s_off[sp])
            for w in range(int(nw[sp])):
                good = bool(ok[wi])
                kmer = int(win_kmers[wi])
                wi += 1
                if not good:
                    continue
                for v in uniq:
                    out_kmers.append(kmer)
                    out_nodes.append(int(v))
                    out_sn.append(node_sp)
                    out_so.append(off_sp + w)
                    out_af.append(af)
                if len(kmers_found) < 500:
                    kmers_found.append((None, set(uniq), node_sp, kmer))

        self._finalized = (
            np.array(out_kmers, dtype=np.uint64).astype(np.int64),
            np.array(out_nodes, dtype=np.int32),
            np.array(out_sn, dtype=np.int32),
            np.array(out_so, dtype=np.int64).astype(np.int16),
            np.array(out_af, dtype=np.float64))
        self._kmers_found_dbg = kmers_found

    # below this span count the scalar finalize path beats numpy overhead
    _SMALL_FINALIZE_SPANS = 32

    def _finalize(self, force_path=None):
        k = self._k
        tape = self._tape.get_nparray()
        n_spans = len(self._span_tape_start)
        if n_spans == 0:
            empty = (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int32),
                     np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.int16),
                     np.zeros(0, dtype=np.float64))
            self._finalized = empty
            return

        if force_path == "small" or (force_path is None
                                     and n_spans <= self._SMALL_FINALIZE_SPANS
                                     and len(tape) <= 4096):
            self._finalize_small()
            return

        if (force_path == "native"
                or (force_path is None and self._whitelist is None
                    and self._use_device is not True)):
            from . import native
            res = native.finalize_rows(
                tape, k,
                self._span_tape_start.get_nparray(),
                self._span_n_windows.get_nparray(),
                self._span_node.get_nparray(),
                self._span_first_offset.get_nparray(),
                self._span_nodes_len.get_nparray(),
                self._span_nodes.get_nparray(),
                self._graph.allele_frequencies,
                only_save_one=self._only_save_one_node_per_kmer,
                only_store_nodes=self._only_store_nodes)
            if res is not None:
                kmers, nodes, start_nodes, start_offsets, af = res
                self._finalized = (kmers, nodes,
                                   start_nodes, start_offsets, af)
                self._rebuild_kmers_found_debug()
                return

        if self._use_device is not None:
            use_device = self._use_device
        else:
            use_device = (len(tape) >= _DEVICE_TAPE_THRESHOLD
                          and self._device is not None
                          and str(self._device).startswith("cuda"))
        if use_device:
            # torch comes in here and not with the module: the pooled
            # find's workers walk and finalize on the host
            import torch
            from .device import resolve_device
            from .ops.encode import sliding_hashes
            # K1 on a CUDA device (its plain twin on "cpu"): the hash at
            # every tape position, the tail windows reading zeros
            codes = torch.from_numpy(np.maximum(tape, 0).astype(np.int8))
            all_hashes = sliding_hashes(
                codes.to(resolve_device(self._device)), k
            ).cpu().numpy().view(np.uint64)
        else:
            all_hashes = sliding_window_hashes(
                np.maximum(tape, 0).astype(np.uint64), k)
            all_hashes = np.concatenate(
                [all_hashes, np.zeros(k - 1, dtype=np.uint64)])[:len(tape)] \
                if len(tape) else all_hashes

        ts = self._span_tape_start.get_nparray()
        nw = self._span_n_windows.get_nparray().astype(np.int64)
        s_node = self._span_node.get_nparray()
        s_off = self._span_first_offset.get_nparray()
        raw_nl = self._span_nodes_len.get_nparray().astype(np.int64)
        raw_nodes = self._span_nodes.get_nparray()

        nl, ns, span_nodes, s_af = _dedup_span_nodes(
            raw_nl, raw_nodes, self._graph.allele_frequencies,
            self._only_save_one_node_per_kmer, self._only_store_nodes)

        # per-window arrays (window order == emission order)
        win_span = np.repeat(np.arange(n_spans), nw)
        total_windows = len(win_span)
        win_local = np.arange(total_windows) - np.repeat(
            np.concatenate([[0], np.cumsum(nw)[:-1]]), nw)
        win_kmer = all_hashes[ts[win_span] + win_local]
        win_ok = self._whitelist_mask(win_kmer)

        # row expansion: one row per (window, node in span node list)
        rows_per_window = nl[win_span]
        row_win = np.repeat(np.arange(total_windows), rows_per_window)
        total_rows = len(row_win)
        row_local = np.arange(total_rows) - np.repeat(
            np.concatenate([[0], np.cumsum(rows_per_window)[:-1]]),
            rows_per_window)
        row_span = win_span[row_win]

        keep = win_ok[row_win]
        kmers = win_kmer[row_win][keep].astype(np.int64)
        nodes = span_nodes[ns[row_span] + row_local][keep].astype(np.int32)
        start_nodes = s_node[row_span][keep].astype(np.int32)
        start_offsets = (s_off[row_span] + win_local[row_win])[keep].astype(np.int16)
        af = s_af[row_span][keep]

        self._finalized = (kmers, nodes, start_nodes, start_offsets, af)

        # debug/testing aid mirroring reference kmers_found (first 500).
        # Apply the same only_save_one_node_per_kmer / only_store_nodes
        # filtering as _rebuild_kmers_found_debug so the list is
        # path-independent.
        self._kmers_found_dbg = []
        for w in range(total_windows):
            if len(self._kmers_found_dbg) >= 500:
                break
            if not win_ok[w]:
                continue
            sp = win_span[w]
            uniq = sorted(set(span_nodes[ns[sp]: ns[sp] + nl[sp]].tolist()))
            if self._only_save_one_node_per_kmer:
                uniq = uniq[:1]
            if self._only_store_nodes is not None:
                uniq = [v for v in uniq if v in self._only_store_nodes]
            self._kmers_found_dbg.append(
                (None, set(uniq), int(s_node[sp]), int(win_kmer[w])))

    def _whitelist_mask(self, kmers):
        if self._whitelist is None:
            return np.ones(len(kmers), dtype=bool)
        wl = self._whitelist
        if hasattr(wl, "has_kmers"):
            kw = {}
            # host-mode finders (e.g. forked pool workers) must not
            # initialize an accelerator backend for the whitelist query
            if self._use_device is False:
                try:
                    kw = {"backend": "native"}
                    mask = np.asarray(wl.has_kmers(
                        kmers.astype(np.uint64), **kw), dtype=bool)
                except TypeError:
                    mask = np.asarray(wl.has_kmers(kmers.astype(np.uint64)),
                                      dtype=bool)
            else:
                mask = np.asarray(wl.has_kmers(kmers.astype(np.uint64)),
                                  dtype=bool)
        else:
            mask = np.array([int(h) in wl for h in kmers], dtype=bool)
        self._n_skipped_whitelist += int((~mask).sum())
        return mask

    def _results(self):
        if self._finalized is None:
            self._finalize()
        return self._finalized
