// Native span-walker: the DenseKmerFinder graph-traversal control plane.
//
// Function-by-function mirror of graph_kmer_index_tpu/finder.py
// (_search/_process_entry/_step_base/_process_run/_next_nodes/_emit_span
// and the _TreatedIntervals dedup), which itself implements the reference
// semantics (kmer_finder.py:179-434). Emits the same span descriptors +
// base tape in the same order; hashing and row expansion stay in
// Python/JAX (_finalize). Differential tests assert byte equality with
// the Python walker on random graphs.
//
// Plain C ABI for ctypes; one opaque result handle per run.

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <unordered_set>
#include <vector>
#include <algorithm>

namespace {

struct Graph {
    int64_t n_nodes;
    const uint32_t* node_sizes;
    const int64_t* seq_start;
    const int8_t* sequence;
    const int64_t* edge_index;
    const int32_t* edge_targets;
    const uint8_t* is_ref;        // linear-ref or ref-dummy mask
    const int32_t* crit_index;    // per-node critical offset, -1 = none
};

struct SetKey {
    int32_t node;
    std::vector<int32_t> members;  // sorted unique window nodes
    bool operator==(const SetKey& o) const {
        return node == o.node && members == o.members;
    }
};

struct SetKeyHash {
    size_t operator()(const SetKey& k) const {
        uint64_t h = 1469598103934665603ull ^ (uint64_t)k.node;
        for (int32_t v : k.members) {
            h ^= (uint64_t)(uint32_t)v;
            h *= 1099511628211ull;
        }
        return (size_t)h;
    }
};

struct Walker {
    Graph g;
    int32_t k;
    int32_t max_variant_nodes;
    bool early_stop = false;  // emit first full window per branch, stop
                              // (find_only_kmers_starting_at_position)
    std::unordered_set<int32_t> only_follow;  // empty = unrestricted

    // per-branch state (truncated on DFS backtrack)
    std::vector<int32_t> elem_nodes;
    std::vector<int8_t> elem_bases;
    std::vector<int64_t> ne_pos;
    std::vector<int8_t> ne_bases;
    std::vector<int32_t> blk_node;
    std::vector<int64_t> blk_first;

    // emission buffers (append-only, global)
    std::vector<int8_t> tape;
    std::vector<int64_t> span_tape_start;
    std::vector<int32_t> span_n_windows;
    std::vector<int32_t> span_node;
    std::vector<int32_t> span_first_offset;
    std::vector<int32_t> span_nodes_len;
    std::vector<int32_t> span_nodes;

    // treated intervals: (node, window-node-set) -> interval set.
    // Flat open-addressed table (linear probing, interned member arena,
    // first interval inline in the slot, rare multi-interval keys spill
    // to side lists): the std::unordered_map<SetKey, vector> formulation
    // cost ~4us per treated_add on allocation-heavy hosts — several
    // pointer-chasing cache misses per op; this is 1 contiguous probe
    // and usually an inline merge.
    struct TSlot {
        uint64_t fp = 0;
        int64_t mem_off = 0;          // arena can exceed 2^31 entries
        int32_t node = -1;            // -1 = empty slot
        int32_t mem_len = 0;
        int32_t o1 = 1, o2 = 0;       // inline interval; o1 > o2 = none
        int32_t spill = -1;
    };
    std::vector<TSlot> tslots = std::vector<TSlot>(1u << 17);
    size_t tcount = 0;
    std::vector<int32_t> tarena;
    std::vector<std::vector<std::pair<int32_t, int32_t>>> tspill;

    static uint64_t fp_of(const SetKey& k) {
        // NOT plain FNV: `node` is premultiplied so the very common
        // members==[node] key doesn't cancel to a constant (basis ^ node
        // ^ node), and a splitmix64 finalizer disperses into the LOW bits
        // the power-of-two slot mask keeps (FNV's low bits are weak).
        uint64_t h = 1469598103934665603ull
                     ^ ((uint64_t)(uint32_t)k.node * 0x9E3779B97F4A7C15ull);
        for (int32_t v : k.members) {
            h ^= (uint64_t)(uint32_t)v;
            h *= 1099511628211ull;
        }
        h ^= h >> 30; h *= 0xBF58476D1CE4E5B9ull;
        h ^= h >> 27; h *= 0x94D049BB133111EBull;
        h ^= h >> 31;
        return h;
    }

    TSlot* tfind(const SetKey& key, uint64_t fp) {
        size_t mask = tslots.size() - 1;
        size_t i = (size_t)fp & mask;
        while (true) {
            TSlot& s = tslots[i];
            if (s.node == -1) return nullptr;
            if (s.fp == fp && s.node == key.node
                && s.mem_len == (int32_t)key.members.size()
                && std::equal(key.members.begin(), key.members.end(),
                              tarena.begin() + s.mem_off))
                return &s;
            i = (i + 1) & mask;
        }
    }

    void tgrow() {
        std::vector<TSlot> old;
        old.swap(tslots);
        tslots.assign(old.size() * 2, TSlot{});
        size_t mask = tslots.size() - 1;
        for (const TSlot& s : old) {
            if (s.node == -1) continue;
            size_t i = (size_t)s.fp & mask;
            while (tslots[i].node != -1) i = (i + 1) & mask;
            tslots[i] = s;
        }
    }

    TSlot* tinsert(const SetKey& key, uint64_t fp) {  // key known absent
        if (tcount * 10 >= tslots.size() * 7) tgrow();
        size_t mask = tslots.size() - 1;
        size_t i = (size_t)fp & mask;
        while (tslots[i].node != -1) i = (i + 1) & mask;
        TSlot& s = tslots[i];
        s.fp = fp;
        s.node = key.node;
        s.mem_off = (int64_t)tarena.size();
        s.mem_len = (int32_t)key.members.size();
        tarena.insert(tarena.end(), key.members.begin(), key.members.end());
        ++tcount;
        return &s;
    }

    // worklist
    std::vector<std::pair<int32_t, int32_t>> starting_points;
    std::unordered_set<int64_t> seen;

    int32_t crit_node = -1, crit_offset = -1;

    // step_base builds the same (node, whole-block-set) key for every
    // base of a node (the dominant per-base cost was rebuilding+sorting
    // it each call): cache it, invalidated by a generation counter
    // bumped on any blk_node mutation
    uint64_t blk_gen = 0;
    SetKey cached_key0;
    uint64_t cached_gen = ~0ull;
    int32_t cached_node = -1;

    const SetKey& key0(int32_t node) {
        if (cached_gen != blk_gen || cached_node != node) {
            cached_key0 = make_key(node, 0);
            cached_gen = blk_gen;
            cached_node = node;
        }
        return cached_key0;
    }

    static int64_t pkey(int32_t node, int32_t offset) {
        return ((int64_t)node << 32) | (int64_t)(uint32_t)offset;
    }

    int32_t critical_offset_of(int32_t node) const {
        if (g.crit_index == nullptr || node >= g.n_nodes) return -1;
        return g.crit_index[node];
    }

    void queue_starting_point(int32_t node, int32_t offset) {
        int64_t key = pkey(node, offset);
        if (seen.insert(key).second)
            starting_points.emplace_back(node, offset);
    }

    SetKey make_key(int32_t node, size_t block_from) const {
        SetKey key;
        key.node = node;
        key.members.assign(blk_node.begin() + block_from, blk_node.end());
        std::sort(key.members.begin(), key.members.end());
        key.members.erase(std::unique(key.members.begin(), key.members.end()),
                          key.members.end());
        return key;
    }

    // smallest treated offset in [o1,o2] skipping `exempt` (-1 = none)
    int32_t first_hit(const SetKey& key, int32_t o1, int32_t o2,
                      int32_t exempt) {
        TSlot* s = tfind(key, fp_of(key));
        if (s == nullptr) return -1;
        int32_t candidate = o1;
        while (candidate <= o2) {
            int32_t best = INT32_MAX;
            auto consider = [&](int32_t a, int32_t b) {
                if (b >= candidate && a <= o2) {
                    int32_t p = std::max(a, candidate);
                    if (p < best) best = p;
                }
            };
            if (s->o1 <= s->o2) consider(s->o1, s->o2);
            if (s->spill >= 0)
                for (const auto& iv : tspill[s->spill])
                    consider(iv.first, iv.second);
            if (best == INT32_MAX) return -1;
            if (best == exempt) { candidate = best + 1; continue; }
            return best;
        }
        return -1;
    }

    void treated_add(const SetKey& key, int32_t o1, int32_t o2) {
        if (o2 < o1) return;
        uint64_t fp = fp_of(key);
        TSlot* s = tfind(key, fp);
        if (s == nullptr) s = tinsert(key, fp);
        // merge with the LAST added interval when contiguous/overlapping
        // (the per-base path adds [o,o] for consecutive offsets), else
        // append — first_hit scans all of them, so this is equivalence-
        // preserving compaction
        if (s->spill >= 0 && !tspill[s->spill].empty()) {
            auto& b = tspill[s->spill].back();
            if (o1 <= b.second + 1 && b.first <= o2 + 1) {
                b.first = std::min(b.first, o1);
                b.second = std::max(b.second, o2);
            } else {
                tspill[s->spill].emplace_back(o1, o2);
            }
            return;
        }
        if (s->o1 > s->o2) { s->o1 = o1; s->o2 = o2; return; }
        if (o1 <= s->o2 + 1 && s->o1 <= o2 + 1) {
            s->o1 = std::min(s->o1, o1);
            s->o2 = std::max(s->o2, o2);
            return;
        }
        if (s->spill < 0) {
            s->spill = (int32_t)tspill.size();
            tspill.emplace_back();
        }
        tspill[s->spill].emplace_back(o1, o2);
    }

    void emit_span(int32_t node, int32_t first_offset, int32_t n_windows,
                   size_t block_from, int64_t t_first) {
        span_tape_start.push_back((int64_t)tape.size());
        tape.insert(tape.end(),
                    ne_bases.begin() + (t_first - k + 1),
                    ne_bases.begin() + (t_first + n_windows));
        span_n_windows.push_back(n_windows);
        span_node.push_back(node);
        span_first_offset.push_back(first_offset);
        span_nodes_len.push_back((int32_t)(blk_node.size() - block_from));
        span_nodes.insert(span_nodes.end(), blk_node.begin() + block_from,
                          blk_node.end());
    }

    // finder.py _step_base (exact per-base semantics)
    // returns 0=CONT 1=STOP/PRUNE
    int step_base(int32_t node, int32_t offset) {
        int8_t base = g.sequence[g.seq_start[node] + offset];
        int64_t elem_idx = (int64_t)elem_nodes.size();
        elem_nodes.push_back(node);
        elem_bases.push_back(base);
        ne_pos.push_back(elem_idx);
        ne_bases.push_back(base);
        int64_t t = (int64_t)ne_pos.size() - 1;

        const SetKey& key = key0(node);
        int32_t exempt = (node == crit_node && offset == crit_offset)
                             ? offset : -1;
        if ((int64_t)elem_nodes.size() >= k) {
            if (first_hit(key, offset, offset, exempt) >= 0) return 1;
        }
        treated_add(key, offset, offset);

        if (t >= k - 1) {
            emit_span(node, offset, 1, 0, t);
            if (early_stop) return 1;  // "EARLY": stop this branch
        }

        if (!(node == crit_node && offset + 1 == crit_offset)
            && critical_offset_of(node) == offset + 1 ) {
            queue_starting_point(node, offset + 1);
            return 1;
        }
        return 0;
    }

    // finder.py _process_run
    int process_run(int32_t node, int32_t o_start) {
        int32_t size = (int32_t)g.node_sizes[node];
        int32_t process_end = size;
        int32_t stop_at = -1;
        int32_t c = critical_offset_of(node);
        if (c >= 0 && o_start + 1 <= c && c <= size
            && !(node == crit_node && c == crit_offset)) {
            process_end = c;
            stop_at = c;
        }
        int32_t n = process_end - o_start;
        if (n <= 0) {
            if (stop_at >= 0) { queue_starting_point(node, stop_at); return 1; }
            return 0;  // CONT (unreachable in practice; mirrors python)
        }

        int64_t t0 = (int64_t)ne_pos.size();
        int64_t elem0 = (int64_t)elem_nodes.size();
        const int8_t* bases = g.sequence + g.seq_start[node] + o_start;
        for (int32_t i = 0; i < n; ++i) {
            elem_nodes.push_back(node);
            elem_bases.push_back(bases[i]);
            ne_pos.push_back(elem0 + i);
            ne_bases.push_back(bases[i]);
        }

        // group window starts by containing path block
        // b(i) = index of last blk_first <= ne_pos[t0-k+1+i]
        size_t gi = 0;
        while (gi < (size_t)n) {
            int64_t start_elem = ne_pos[t0 - k + 1 + gi];
            size_t bb = (size_t)(std::upper_bound(blk_first.begin(),
                                                  blk_first.end(), start_elem)
                                 - blk_first.begin()) - 1;
            // group extent: windows whose start elem stays in block bb
            size_t ge = gi + 1;
            while (ge < (size_t)n) {
                int64_t se = ne_pos[t0 - k + 1 + ge];
                size_t b2 = (size_t)(std::upper_bound(blk_first.begin(),
                                                      blk_first.end(), se)
                                     - blk_first.begin()) - 1;
                if (b2 != bb) break;
                ++ge;
            }
            SetKey key = make_key(node, bb);
            int32_t o1 = o_start + (int32_t)gi;
            int32_t o2 = o_start + (int32_t)ge - 1;
            int32_t exempt = (node == crit_node && o1 <= crit_offset
                              && crit_offset <= o2) ? crit_offset : -1;
            int32_t hit = first_hit(key, o1, o2, exempt);
            int32_t emit_end = (hit >= 0) ? hit - 1 : o2;
            treated_add(key, o1, emit_end);
            if (emit_end >= o1)
                emit_span(node, o1, emit_end - o1 + 1, bb,
                          t0 + (int64_t)gi);
            if (hit >= 0) return 1;  // PRUNE
            gi = ge;
        }

        if (stop_at >= 0) { queue_starting_point(node, stop_at); return 1; }
        return 0;
    }

    // finder.py _process_entry; returns 0=CONT else stop
    int process_entry(int32_t node, int32_t offset) {
        int32_t size = (int32_t)g.node_sizes[node];
        if (offset == 0 && size == 0) {
            ++blk_gen;
            blk_node.push_back(node);
            blk_first.push_back((int64_t)elem_nodes.size());
            elem_nodes.push_back(node);
            elem_bases.push_back(-1);
            return 0;
        }
        ++blk_gen;
        blk_node.push_back(node);
        blk_first.push_back((int64_t)elem_nodes.size());
        while (offset < size) {
            if ((int64_t)ne_pos.size() < k) {
                if (step_base(node, offset)) return 1;
                ++offset;
            } else {
                return process_run(node, offset) ? 1 : 0;
            }
        }
        return 0;
    }

    size_t current_window_block() const {
        if ((int64_t)ne_pos.size() < k) return 0;
        int64_t start_elem = ne_pos[ne_pos.size() - k];
        return (size_t)(std::upper_bound(blk_first.begin(), blk_first.end(),
                                         start_elem) - blk_first.begin()) - 1;
    }

    // finder.py _next_nodes; returns false on a python-level assertion
    bool next_nodes(int32_t node, std::vector<int32_t>& out) {
        out.clear();
        for (int64_t e = g.edge_index[node]; e < g.edge_index[node + 1]; ++e)
            out.push_back(g.edge_targets[e]);
        if (out.empty()) return true;

        bool force_follow = false;
        if (!only_follow.empty()) {
            std::vector<int32_t> restricted;
            for (int32_t v : out)
                if (only_follow.count(v)) restricted.push_back(v);
            if (!restricted.empty()) {
                out.swap(restricted);
                force_follow = true;
            }
        }
        if (force_follow) return true;

        size_t bb = current_window_block();
        std::vector<int32_t> uniq(blk_node.begin() + bb, blk_node.end());
        std::sort(uniq.begin(), uniq.end());
        uniq.erase(std::unique(uniq.begin(), uniq.end()), uniq.end());
        int32_t n_variant = 0;
        for (int32_t v : uniq)
            if (!g.is_ref[v]) ++n_variant;

        if (n_variant >= max_variant_nodes) {
            std::vector<int32_t> ref_only;
            for (int32_t v : out)
                if (g.is_ref[v]) ref_only.push_back(v);
            if (ref_only.size() != 1) return false;  // assertion in python
            out.swap(ref_only);
        }
        return true;
    }

    struct Snap { size_t n_elems, n_ne, n_blk; };

    void restore(const Snap& s) {
        elem_nodes.resize(s.n_elems);
        elem_bases.resize(s.n_elems);
        ne_pos.resize(s.n_ne);
        ne_bases.resize(s.n_ne);
        ++blk_gen;
        blk_node.resize(s.n_blk);
        blk_first.resize(s.n_blk);
    }

    // finder.py _search: iterative DFS; returns false on python-level
    // assertion failure (caller falls back)
    bool search(int32_t node, int32_t offset) {
        struct Entry { int32_t node, offset; Snap snap; };
        std::vector<Entry> stack;
        stack.push_back({node, offset, {elem_nodes.size(), ne_pos.size(),
                                        blk_node.size()}});
        std::vector<int32_t> children;
        while (!stack.empty()) {
            Entry e = stack.back();
            stack.pop_back();
            restore(e.snap);
            if (process_entry(e.node, e.offset)) continue;
            if (!next_nodes(e.node, children)) return false;
            if (!children.empty()) {
                Snap snap{elem_nodes.size(), ne_pos.size(), blk_node.size()};
                for (auto it = children.rbegin(); it != children.rend(); ++it)
                    stack.push_back({*it, 0, snap});
            }
        }
        return true;
    }

    bool run(const int64_t* wl_nodes, const int64_t* wl_offsets,
             int64_t n_wl, const int64_t* seen_nodes,
             const int64_t* seen_offsets, int64_t n_seen,
             int64_t stop_at_node, int32_t do_early_stop,
             const int64_t* follow_nodes, int64_t n_follow) {
        early_stop = (do_early_stop != 0);
        for (int64_t i = 0; i < n_follow; ++i)
            only_follow.insert((int32_t)follow_nodes[i]);
        for (int64_t i = 0; i < n_seen; ++i)
            seen.insert(pkey((int32_t)seen_nodes[i],
                             (int32_t)seen_offsets[i]));
        starting_points.reserve((size_t)n_wl);
        for (int64_t i = 0; i < n_wl; ++i)
            starting_points.emplace_back((int32_t)wl_nodes[i],
                                         (int32_t)wl_offsets[i]);
        while (!starting_points.empty()) {
            auto [cnode, coffset] = starting_points.back();
            starting_points.pop_back();
            if (stop_at_node >= 0 && cnode == (int32_t)stop_at_node) break;
            // _start_search
            crit_node = cnode;
            crit_offset = coffset;
            elem_nodes.clear(); elem_bases.clear();
            ne_pos.clear(); ne_bases.clear();
            ++blk_gen;
            blk_node.clear(); blk_first.clear();
            int32_t offset = coffset;
            // early-stop searches start at the exact position
            // (find_only_kmers_starting_at_position calls _search
            // directly, finder.py:176-186); full find() backs up k-1
            if (!early_stop && offset >= k - 1) offset -= k - 1;
            if (!search(cnode, offset)) return false;
        }
        return true;
    }
};

}  // namespace

extern "C" {

void* gki_walk_run(
    int64_t n_nodes, const uint32_t* node_sizes, const int64_t* seq_start,
    const int8_t* sequence, const int64_t* edge_index,
    const int32_t* edge_targets, const uint8_t* is_ref,
    const int32_t* crit_index, int32_t k, int32_t max_variant_nodes,
    const int64_t* wl_nodes, const int64_t* wl_offsets, int64_t n_wl,
    const int64_t* seen_nodes, const int64_t* seen_offsets, int64_t n_seen,
    int64_t stop_at_node, int32_t early_stop,
    const int64_t* follow_nodes, int64_t n_follow,
    int64_t* out_sizes /* [n_spans, tape_len, span_nodes_len] */) {
    Walker* w = new Walker();
    w->g = Graph{n_nodes, node_sizes, seq_start, sequence, edge_index,
                 edge_targets, is_ref, crit_index};
    w->k = k;
    w->max_variant_nodes = max_variant_nodes;
    if (!w->run(wl_nodes, wl_offsets, n_wl, seen_nodes, seen_offsets,
                n_seen, stop_at_node, early_stop, follow_nodes, n_follow)) {
        delete w;
        out_sizes[0] = -1;
        return nullptr;
    }
    out_sizes[0] = (int64_t)w->span_node.size();
    out_sizes[1] = (int64_t)w->tape.size();
    out_sizes[2] = (int64_t)w->span_nodes.size();
    return w;
}

void gki_walk_fetch(void* handle, int8_t* tape, int64_t* span_tape_start,
                    int32_t* span_n_windows, int32_t* span_node,
                    int32_t* span_first_offset, int32_t* span_nodes_len,
                    int32_t* span_nodes) {
    Walker* w = (Walker*)handle;
    memcpy(tape, w->tape.data(), w->tape.size());
    memcpy(span_tape_start, w->span_tape_start.data(),
           w->span_tape_start.size() * 8);
    memcpy(span_n_windows, w->span_n_windows.data(),
           w->span_n_windows.size() * 4);
    memcpy(span_node, w->span_node.data(), w->span_node.size() * 4);
    memcpy(span_first_offset, w->span_first_offset.data(),
           w->span_first_offset.size() * 4);
    memcpy(span_nodes_len, w->span_nodes_len.data(),
           w->span_nodes_len.size() * 4);
    memcpy(span_nodes, w->span_nodes.data(), w->span_nodes.size() * 4);
    delete w;
}

void gki_walk_free(void* handle) { delete (Walker*)handle; }

}  // extern "C"

// ---------------------------------------------------------------------------
// Native finalize: span stream -> FlatKmers rows (the row-expansion half
// of finder._finalize, minus whitelist masking which needs index queries).
// Per span: ascending-unique node set, min allele frequency over the RAW
// path nodes, only_save_one / only_store filters, one row per
// (window, node). Bit-identical to the python vector path (fuzz-pinned).
//
// Two-phase count/fill protocol: count computes the per-span filtered
// node sets + exact row total; fill writes rows straight into the
// caller's (numpy) buffers. No result vectors, no fetch memcpy — on
// this sandboxed host first-touch page faults run at ~22 MB/s, so every
// avoidable copy of the ~25B/row output is worth ~1s per 2.5M rows.
// ---------------------------------------------------------------------------

namespace {
struct FinalizePlan {
    std::vector<int32_t> uniq;      // concatenated per-span filtered sets
    std::vector<int64_t> uniq_start;  // n_spans+1
    std::vector<double> span_af;    // per-span min allele frequency
};
}  // namespace

extern "C" {

void* gki_finalize_count(
    const int32_t* nw, const int32_t* raw_nl, const int32_t* raw_nodes,
    int64_t n_spans, const double* af_table,
    int32_t only_save_one, const int32_t* store_filter, int64_t n_store,
    int64_t* out_n_rows) {
    FinalizePlan* p = new FinalizePlan();
    p->uniq_start.resize((size_t)n_spans + 1);
    p->span_af.resize((size_t)n_spans);
    p->uniq.reserve((size_t)n_spans * 2);
    std::vector<int32_t> uniq;
    int64_t pos = 0, n_rows = 0;
    for (int64_t sp = 0; sp < n_spans; ++sp) {
        const int32_t* raw = raw_nodes + pos;
        int32_t nraw = raw_nl[sp] > 0 ? raw_nl[sp] : 0;  // defensive:
        // a negative length would make uniq.assign UB and desync pos
        pos += nraw;
        double af = 1e300;
        uniq.assign(raw, raw + nraw);
        for (int32_t i = 0; i < nraw; ++i)
            af = std::min(af, af_table[raw[i]]);
        std::sort(uniq.begin(), uniq.end());
        uniq.erase(std::unique(uniq.begin(), uniq.end()), uniq.end());
        if (only_save_one && uniq.size() > 1) uniq.resize(1);
        if (n_store >= 0) {
            size_t w = 0;
            for (int32_t v : uniq)
                if (std::binary_search(store_filter, store_filter + n_store,
                                       v))
                    uniq[w++] = v;
            uniq.resize(w);
        }
        p->uniq_start[sp] = (int64_t)p->uniq.size();
        p->uniq.insert(p->uniq.end(), uniq.begin(), uniq.end());
        p->span_af[sp] = af;
        // same nw <= 0 skip as fill: count and fill MUST agree on the
        // row total or fill overruns the caller-sized buffers
        if (nw[sp] > 0)
            n_rows += (int64_t)uniq.size() * nw[sp];
    }
    p->uniq_start[n_spans] = (int64_t)p->uniq.size();
    *out_n_rows = n_rows;
    return p;
}

void gki_finalize_fill(
    void* plan, const int8_t* tape, int64_t n_tape, int32_t k,
    const int64_t* ts, const int32_t* nw, const int32_t* s_node,
    const int32_t* s_off, int64_t n_spans,
    uint64_t* kmers, int32_t* nodes, int32_t* start_nodes,
    int16_t* start_offsets, double* af) {
    FinalizePlan* p = (FinalizePlan*)plan;
    const int32_t top = 2 * (k - 1);
    int64_t row = 0;
    for (int64_t sp = 0; sp < n_spans; ++sp) {
        const int32_t* uq = p->uniq.data() + p->uniq_start[sp];
        int32_t nuq = (int32_t)(p->uniq_start[sp + 1] - p->uniq_start[sp]);
        if (nuq == 0 || nw[sp] <= 0) continue;
        double span_af = p->span_af[sp];
        int32_t node_sp = s_node[sp];
        int32_t off_sp = s_off[sp];
        // rolling hash over this span's tape slice (slices are disjoint,
        // so per-span re-init costs the same total tape reads as one
        // whole-tape pass and skips the 8B/base hash buffer)
        const int8_t* t = tape + ts[sp];
        uint64_t h = 0;
        for (int32_t i = 0; i < k; ++i)
            h |= ((uint64_t)(uint8_t)t[i]) << (2 * i);
        for (int32_t w = 0; w < nw[sp]; ++w) {
            if (w > 0)
                h = (h >> 2) | (((uint64_t)(uint8_t)t[w + k - 1]) << top);
            int16_t so = (int16_t)(off_sp + w);
            for (int32_t i = 0; i < nuq; ++i) {
                kmers[row] = h;
                nodes[row] = uq[i];
                start_nodes[row] = node_sp;
                start_offsets[row] = so;
                af[row] = span_af;
                ++row;
            }
        }
    }
    (void)n_tape;
    delete p;
}

// Release a count plan whose fill never ran (e.g. the caller's output
// allocation failed); fill consumes the plan itself.
void gki_finalize_free(void* plan) { delete (FinalizePlan*)plan; }

}  // extern "C"
