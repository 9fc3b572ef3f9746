// Native host-side runtime kernels for graph_kmer_index_tpu.
//
// These are the CPU equivalents of the reference's native layer (SURVEY.md
// L6): cython_kmer_index.pyx (batched bucket lookup), the external
// kmer_mapper package (map-to-node-counts / membership), and the hot
// letter->2bit / rolling-hash loops. The TPU device path (ops/) is the
// production path; this library serves host-side streaming (FASTA
// ingestion, CPU fallback lookup) without Python-loop overhead.
//
// Plain C ABI, loaded via ctypes (no pybind11 in the image).

#include <cstdint>
#include <cstring>

extern "C" {

// ASCII -> 2-bit encode (a/A=0 c/C=1 g/G=2 t/T=3, others 0); returns n.
// Mirrors reference flat_kmers.py:134-145.
namespace {
struct EncodeTable {
    int8_t t[256];
    EncodeTable() {
        memset(t, 0, sizeof(t));
        t[(unsigned char)'c'] = t[(unsigned char)'C'] = 1;
        t[(unsigned char)'g'] = t[(unsigned char)'G'] = 2;
        t[(unsigned char)'t'] = t[(unsigned char)'T'] = 3;
    }
};
}  // namespace

int64_t gki_encode_ascii(const char* seq, int64_t n, int8_t* out) {
    // C++11 magic static: thread-safe one-time init (the host thread
    // pool calls these kernels concurrently with the GIL released; a
    // plain bool guard was a data race)
    static const EncodeTable table;
    for (int64_t i = 0; i < n; ++i)
        out[i] = table.t[(unsigned char)seq[i]];
    return n;
}

// Rolling sliding-window hashes, first-base-LSB convention
// (hash = sum base[i] * 4^i, reference kmer_hashing.py:8-9). Writes
// n - k + 1 hashes; O(n) via the reference's own rolling update rule
// (kmer_finder.py:27-31): h' = (h - first)/4 + new*4^(k-1).
int64_t gki_sliding_hashes(const int8_t* seq, int64_t n, int32_t k,
                           uint64_t* out) {
    if (n < k) return 0;
    uint64_t h = 0;
    for (int32_t i = 0; i < k; ++i)
        h |= ((uint64_t)seq[i]) << (2 * i);
    out[0] = h;
    const int32_t top = 2 * (k - 1);
    for (int64_t i = 1; i + k <= n; ++i) {
        h = (h >> 2) | (((uint64_t)seq[i + k - 1]) << top);
        out[i] = h;
    }
    return n - k + 1;
}

// Batched bucket lookup — the CythonKmerIndex.get contract
// (cython_kmer_index.pyx:22-109): two passes over each query's bucket
// rows; skip queries whose bucket has > hit_cap rows and rows with
// frequency > freq_cap. Pass 1 (count_only=1) returns the total number
// of surviving hits; pass 2 fills the (5, n_hits) row-major output
// [node, ref_offset, query_index, frequency, 1000*allele_frequency].
//
// Each lookup comes in two starts-table widths: int64 (legacy host
// builds / old npz files) and int32 (the device build's native layout —
// row counts are < 2^31 everywhere, reference_kmer_index.py:89, and the
// int32->int64 widening of a production-modulo table is a 3.6 GB copy
// that costs more than the lookup itself).
}  // extern "C" (templates cannot carry C linkage)

#include <algorithm>
#include <thread>
#include <vector>

namespace {
// one bucket run's frequency computation: rows [i, j) share a hash
// bucket; distinct (kmer, ref_offset) pairs are counted per kmer and
// written back to every member row (reference set_frequencies
// semantics, collision_free_kmer_index.py:267-293; uint16 wrap matches
// the numpy/device casts)
void bucket_run_frequencies(const uint64_t* kmers, const uint64_t* ros,
                            int64_t i, int64_t j, uint16_t* out,
                            std::vector<int64_t>& scratch) {
    if (j - i == 1) {  // dominant case: <1 row per bucket on average
        out[i] = 1;
        return;
    }
    scratch.clear();
    for (int64_t r = i; r < j; ++r) scratch.push_back(r);
    std::sort(scratch.begin(), scratch.end(),
              [&](int64_t a, int64_t b) {
                  if (kmers[a] != kmers[b]) return kmers[a] < kmers[b];
                  return ros[a] < ros[b];
              });
    size_t g = 0;  // start of the current kmer group in scratch
    while (g < scratch.size()) {
        size_t e = g;
        int64_t distinct = 0;
        uint64_t prev_ro = 0;
        const uint64_t km = kmers[scratch[g]];
        while (e < scratch.size() && kmers[scratch[e]] == km) {
            uint64_t ro = ros[scratch[e]];
            if (e == g || ro != prev_ro) ++distinct;
            prev_ro = ro;
            ++e;
        }
        for (size_t r = g; r < e; ++r)
            out[scratch[r]] = (uint16_t)distinct;
        g = e;
    }
}
}  // namespace

extern "C" {

// frequency[row] = #distinct ref offsets among rows with the same kmer,
// for rows already sorted by hash bucket (the index build's layout:
// equal kmers always share a bucket, so each bucket run is an
// independent subproblem — a linear pass with tiny per-run sorts
// instead of a global n-log-n sort). Verifies the bucket order while
// scanning; returns 0 on success, -1 if rows are not bucket-ordered
// (caller falls back to the sorting path).
int32_t gki_frequencies_bucket_ordered(
    const uint64_t* kmers, const uint64_t* ref_offsets, int64_t n,
    uint64_t modulo, uint16_t* out, int32_t n_threads) {
    if (modulo == 0) return -1;
    if (n == 0) return 0;
    if (n_threads < 1) n_threads = 1;
    std::vector<std::thread> threads;
    std::vector<int32_t> oks((size_t)n_threads, 1);
    auto worker = [&](int32_t t) {
        int64_t lo = n * t / n_threads, hi = n * (t + 1) / n_threads;
        // align both ends forward to bucket-run boundaries (thread t
        // owns runs STARTING in [lo, hi))
        while (lo > 0 && lo < n &&
               kmers[lo] % modulo == kmers[lo - 1] % modulo) ++lo;
        while (hi > 0 && hi < n &&
               kmers[hi] % modulo == kmers[hi - 1] % modulo) ++hi;
        std::vector<int64_t> scratch;
        int64_t i = lo;
        while (i < hi) {
            const uint64_t b = kmers[i] % modulo;
            if (i > 0 && b < kmers[i - 1] % modulo) {  // order violated
                oks[(size_t)t] = 0;
                return;
            }
            int64_t j = i + 1;
            while (j < hi && kmers[j] % modulo == b) ++j;
            bucket_run_frequencies(kmers, ref_offsets, i, j, out, scratch);
            i = j;
        }
    };
    if (n_threads == 1) {
        worker(0);
    } else {
        for (int32_t t = 0; t < n_threads; ++t)
            threads.emplace_back(worker, t);
        for (auto& th : threads) th.join();
    }
    for (int32_t ok : oks)
        if (!ok) return -1;
    return 0;
}

}  // extern "C"

namespace {
template <typename StartT>
int64_t bucket_lookup_impl(
    const uint64_t* kmers, int64_t n_kmers,
    const uint64_t* table_kmers,
    const uint32_t* table_nodes,
    const uint64_t* table_ref_offsets,
    const uint16_t* table_frequencies,
    const float* table_allele_frequencies,
    const StartT* starts_tbl, const uint32_t* sizes_tbl,
    uint64_t modulo, int64_t hit_cap, int64_t freq_cap,
    int32_t count_only, uint64_t* out, int64_t out_capacity) {
    int64_t n_hits = 0;
    for (int64_t q = 0; q < n_kmers; ++q) {
        uint64_t kmer = kmers[q];
        uint64_t bucket = kmer % modulo;
        int64_t start = starts_tbl[bucket];
        int64_t sz = sizes_tbl[bucket];
        if (sz > hit_cap) continue;
        for (int64_t r = start; r < start + sz; ++r) {
            if (table_kmers[r] != kmer) continue;
            if ((int64_t)table_frequencies[r] > freq_cap) continue;
            if (!count_only) {
                if (n_hits >= out_capacity) return -1;
                out[0 * out_capacity + n_hits] = table_nodes[r];
                out[1 * out_capacity + n_hits] = table_ref_offsets[r];
                out[2 * out_capacity + n_hits] = (uint64_t)q;
                out[3 * out_capacity + n_hits] = table_frequencies[r];
                // clamp before the float->unsigned cast: out-of-range
                // (negative/NaN from a corrupt index file) conversion
                // to uint64 is UB and platform-dependent
                float af1000 = table_allele_frequencies[r] * 1000.0f;
                out[4 * out_capacity + n_hits] =
                    (af1000 >= 0.0f)
                        ? (af1000 <= 1.8e19f ? (uint64_t)af1000 : ~0ULL)
                        : 0;
            }
            ++n_hits;
        }
    }
    return n_hits;
}

// kmer_mapper.map_kmers_to_graph_index equivalent: node hit counts.
template <typename StartT>
void map_kmers_impl(
    const uint64_t* kmers, int64_t n_kmers,
    const uint64_t* table_kmers, const uint32_t* table_nodes,
    const StartT* starts_tbl, const uint32_t* sizes_tbl,
    uint64_t modulo, int64_t max_node_id, int64_t* counts /* size max+1 */) {
    for (int64_t q = 0; q < n_kmers; ++q) {
        uint64_t kmer = kmers[q];
        uint64_t bucket = kmer % modulo;
        int64_t start = starts_tbl[bucket];
        int64_t sz = sizes_tbl[bucket];
        for (int64_t r = start; r < start + sz; ++r) {
            if (table_kmers[r] == kmer && table_nodes[r] <= max_node_id)
                ++counts[table_nodes[r]];
        }
    }
}

// kmer_mapper.in_graph_index equivalent: membership mask.
template <typename StartT>
void has_kmers_impl(
    const uint64_t* kmers, int64_t n_kmers,
    const uint64_t* table_kmers,
    const StartT* starts_tbl, const uint32_t* sizes_tbl,
    uint64_t modulo, uint8_t* out) {
    for (int64_t q = 0; q < n_kmers; ++q) {
        uint64_t kmer = kmers[q];
        uint64_t bucket = kmer % modulo;
        int64_t start = starts_tbl[bucket];
        int64_t sz = sizes_tbl[bucket];
        uint8_t hit = 0;
        for (int64_t r = start; r < start + sz && !hit; ++r)
            hit = (table_kmers[r] == kmer);
        out[q] = hit;
    }
}
}  // namespace

extern "C" {

int64_t gki_bucket_lookup(
    const uint64_t* kmers, int64_t n_kmers,
    const uint64_t* table_kmers, const uint32_t* table_nodes,
    const uint64_t* table_ref_offsets, const uint16_t* table_frequencies,
    const float* table_allele_frequencies,
    const int64_t* starts_tbl, const uint32_t* sizes_tbl,
    uint64_t modulo, int64_t hit_cap, int64_t freq_cap,
    int32_t count_only, uint64_t* out, int64_t out_capacity) {
    return bucket_lookup_impl(kmers, n_kmers, table_kmers, table_nodes,
                              table_ref_offsets, table_frequencies,
                              table_allele_frequencies, starts_tbl, sizes_tbl,
                              modulo, hit_cap, freq_cap, count_only, out,
                              out_capacity);
}

int64_t gki_bucket_lookup32(
    const uint64_t* kmers, int64_t n_kmers,
    const uint64_t* table_kmers, const uint32_t* table_nodes,
    const uint64_t* table_ref_offsets, const uint16_t* table_frequencies,
    const float* table_allele_frequencies,
    const int32_t* starts_tbl, const uint32_t* sizes_tbl,
    uint64_t modulo, int64_t hit_cap, int64_t freq_cap,
    int32_t count_only, uint64_t* out, int64_t out_capacity) {
    return bucket_lookup_impl(kmers, n_kmers, table_kmers, table_nodes,
                              table_ref_offsets, table_frequencies,
                              table_allele_frequencies, starts_tbl, sizes_tbl,
                              modulo, hit_cap, freq_cap, count_only, out,
                              out_capacity);
}

void gki_map_kmers(
    const uint64_t* kmers, int64_t n_kmers,
    const uint64_t* table_kmers, const uint32_t* table_nodes,
    const int64_t* starts_tbl, const uint32_t* sizes_tbl,
    uint64_t modulo, int64_t max_node_id, int64_t* counts) {
    map_kmers_impl(kmers, n_kmers, table_kmers, table_nodes, starts_tbl,
                   sizes_tbl, modulo, max_node_id, counts);
}

void gki_map_kmers32(
    const uint64_t* kmers, int64_t n_kmers,
    const uint64_t* table_kmers, const uint32_t* table_nodes,
    const int32_t* starts_tbl, const uint32_t* sizes_tbl,
    uint64_t modulo, int64_t max_node_id, int64_t* counts) {
    map_kmers_impl(kmers, n_kmers, table_kmers, table_nodes, starts_tbl,
                   sizes_tbl, modulo, max_node_id, counts);
}

void gki_has_kmers(
    const uint64_t* kmers, int64_t n_kmers,
    const uint64_t* table_kmers,
    const int64_t* starts_tbl, const uint32_t* sizes_tbl,
    uint64_t modulo, uint8_t* out) {
    has_kmers_impl(kmers, n_kmers, table_kmers, starts_tbl, sizes_tbl,
                   modulo, out);
}

void gki_has_kmers32(
    const uint64_t* kmers, int64_t n_kmers,
    const uint64_t* table_kmers,
    const int32_t* starts_tbl, const uint32_t* sizes_tbl,
    uint64_t modulo, uint8_t* out) {
    has_kmers_impl(kmers, n_kmers, table_kmers, starts_tbl, sizes_tbl,
                   modulo, out);
}

// FASTA/FASTQ streaming: scan a buffer of text, 2-bit-encode every
// sequence line into `out`, recording per-read (start, length) pairs.
// FASTQ records are tracked statefully: the line after a '+' separator
// is a quality line and is skipped even when its first character is not
// a marker (quality strings routinely start with arbitrary ASCII).
// Returns number of reads, or -1 if capacity exceeded.
int64_t gki_fasta_encode(
    const char* text, int64_t n_text,
    int8_t* out, int64_t out_capacity,
    int64_t* read_starts, int64_t* read_lens, int64_t max_reads) {
    int64_t n_reads = 0;
    int64_t out_pos = 0;
    int64_t i = 0;
    int skip_quality = 0;  // set after a FASTQ '+' separator line
    while (i < n_text) {
        // line [i, j)
        int64_t j = i;
        while (j < n_text && text[j] != '\n') ++j;
        // strip whitespace from both ends and skip lines that are empty
        // afterwards WITHOUT touching the quality state — mirrors the
        // python fallback's `l = l.strip(); if not l: continue`
        // (read_kmers.py), so CRLF files and blank lines agree between
        // the two paths
        int64_t b = i, e = j;
        while (b < e && (text[b] == ' ' || text[b] == '\t' ||
                         text[b] == '\r' || text[b] == '\v' ||
                         text[b] == '\f')) ++b;
        while (e > b && (text[e - 1] == ' ' || text[e - 1] == '\t' ||
                         text[e - 1] == '\r' || text[e - 1] == '\v' ||
                         text[e - 1] == '\f')) --e;
        if (e > b) {
            char c0 = text[b];
            if (skip_quality) {
                skip_quality = 0;  // quality line: drop regardless of c0
            } else if (c0 == '+') {
                skip_quality = 1;
            } else if (c0 != '>' && c0 != '@') {
                int64_t len = e - b;
                if (out_pos + len > out_capacity || n_reads >= max_reads)
                    return -1;
                gki_encode_ascii(text + b, len, out + out_pos);
                read_starts[n_reads] = out_pos;
                read_lens[n_reads] = len;
                out_pos += len;
                ++n_reads;
            }
        }
        i = j + 1;
    }
    return n_reads;
}


// ---------------------------------------------------------------------------
// Packed-record lookup (host mirror of ops/lookup.py): one 32-byte
// record per internal-modulo bucket [k0, node0|size<<32, k1,
// node1-or-start]. One cache miss per query for buckets of size <= 2
// (vs 2-3 dependent misses for the bucket-pointer chase), hidden
// further by a software-prefetch pipeline.
// ---------------------------------------------------------------------------

static const uint64_t GKI_EMPTY = ~0ULL;

// Counting-sort rows by internal bucket and fill the record table.
// rec must hold 4*modulo2 u64 (caller-allocated); rows_kmers/rows_nodes
// hold the bucket-sorted rows; scratch must hold modulo2+1 i64.
void gki_build_packed(
    const uint64_t* kmers, const uint32_t* nodes, int64_t n,
    uint64_t modulo2, uint64_t* rec,
    uint64_t* rows_kmers, uint32_t* rows_nodes, int64_t* scratch) {
    int64_t* counts = scratch;  // modulo2 + 1
    for (uint64_t b = 0; b <= modulo2; ++b) counts[b] = 0;
    for (int64_t i = 0; i < n; ++i) ++counts[kmers[i] % modulo2 + 1];
    for (uint64_t b = 0; b < modulo2; ++b) counts[b + 1] += counts[b];
    // stable scatter into bucket order
    for (int64_t i = 0; i < n; ++i) {
        uint64_t b = kmers[i] % modulo2;
        int64_t pos = counts[b]++;
        rows_kmers[pos] = kmers[i];
        rows_nodes[pos] = nodes[i];
    }
    // counts[b] now = end offset of bucket b; start = end of b-1
    for (uint64_t b = 0; b < modulo2; ++b) {
        int64_t start = b ? counts[b - 1] : 0;
        int64_t sz = counts[b] - start;
        uint64_t* r = rec + 4 * b;
        if (sz == 0) {
            r[0] = GKI_EMPTY; r[1] = 0; r[2] = GKI_EMPTY; r[3] = 0;
            continue;
        }
        r[0] = rows_kmers[start];
        r[1] = (uint64_t)rows_nodes[start] | ((uint64_t)sz << 32);
        if (sz == 2) {
            r[2] = rows_kmers[start + 1];
            r[3] = (uint64_t)rows_nodes[start + 1];
        } else {
            r[2] = GKI_EMPTY;
            r[3] = (uint64_t)start;  // deep: scan start row
        }
    }
}

// map_kmers on the packed layout with a prefetch pipeline.
void gki_packed_map_kmers(
    const uint64_t* kmers, int64_t n_kmers,
    const uint64_t* rec, const uint64_t* rows_kmers,
    const uint32_t* rows_nodes, uint64_t modulo2,
    int64_t* counts, int64_t n_nodes) {
    const int64_t AHEAD = 16;
    for (int64_t q = 0; q < n_kmers; ++q) {
        if (q + AHEAD < n_kmers)
            __builtin_prefetch(rec + 4 * (kmers[q + AHEAD] % modulo2));
        uint64_t kmer = kmers[q];
        if (kmer == GKI_EMPTY) continue;  // sentinel collides with the
        // empty-slot marker; legit hashes are < 4^31 (k <= 31)
        const uint64_t* r = rec + 4 * (kmer % modulo2);
        int64_t sz = (int64_t)(r[1] >> 32);
        if (sz <= 2) {
            if (r[0] == kmer) {
                int64_t node = (int64_t)(r[1] & 0xFFFFFFFFULL);
                if (node < n_nodes) ++counts[node];
            }
            if (sz == 2 && r[2] == kmer) {
                int64_t node = (int64_t)r[3];
                if (node < n_nodes) ++counts[node];
            }
        } else {
            int64_t start = (int64_t)r[3];
            for (int64_t i = start; i < start + sz; ++i)
                if (rows_kmers[i] == kmer && rows_nodes[i] < n_nodes)
                    ++counts[rows_nodes[i]];
        }
    }
}

// membership on the packed layout.
void gki_packed_has_kmers(
    const uint64_t* kmers, int64_t n_kmers,
    const uint64_t* rec, const uint64_t* rows_kmers,
    uint64_t modulo2, uint8_t* out) {
    const int64_t AHEAD = 16;
    for (int64_t q = 0; q < n_kmers; ++q) {
        if (q + AHEAD < n_kmers)
            __builtin_prefetch(rec + 4 * (kmers[q + AHEAD] % modulo2));
        uint64_t kmer = kmers[q];
        if (kmer == GKI_EMPTY) { out[q] = 0; continue; }  // see map above
        const uint64_t* r = rec + 4 * (kmer % modulo2);
        int64_t sz = (int64_t)(r[1] >> 32);
        uint8_t hit = (r[0] == kmer) | (r[2] == kmer);
        if (!hit && sz > 2) {
            int64_t start = (int64_t)r[3];
            for (int64_t i = start; i < start + sz && !hit; ++i)
                hit = (rows_kmers[i] == kmer);
        }
        out[q] = hit;
    }
}

}  // extern "C"

