// K2: the whole packed lookup of a query batch in one launch: record
// decode, lane counts / lane membership, and the bucket scan of every
// query that the record alone cannot answer.
//
// Replaces the XLA programs of graph_kmer_index_tpu/ops/lookup.py that
// serve map/has on the packed tables: the decode head
// (_decode_group_rows/_packed_decode, _lane_counts, the decode halves of
// _counts_decode_packed and _member_decode_packed) and the programs the
// head's class byte fed (_compact_overflow with _overflow_scan_counts /
// _overflow_scan_member, and _compact_masked_unique with _ultra_rows /
// _fixup_membership). XLA needs static shapes, so there the head
// classified and later programs scanned compacted lists; here one block
// does both. The table is one 32-byte record per internal bucket (int32
// lanes):
//   [k0_lo, k0_hi, node0, ~(size | dup2 << 30), k1_lo, k1_hi,
//    node1 or start row, spare]
// with all-ones (-1) lanes for an empty slot, so an empty size lane reads
// as size 0 and an empty key never matches a hash (< 2^62). ks / ns are
// the rows' k-mers and nodes sorted by bucket; a bucket of size > 2, or a
// "dup2" bucket (one k-mer twice), keeps its first row in lane 6.
//
// A block takes a tile of kThreads queries, one a thread:
//   1. b = q mod modulo2; the record's two 16-byte loads.
//   2. Counts mode: a query whose bucket has size <= 2 and is no matched
//      dup2 bucket is answered by the lanes: a lane hit adds one to the
//      int64 count of its node (nodes >= n_nodes are dropped). Equal
//      nodes of a warp are added once: neighbouring queries are
//      neighbouring windows of one read and hit the same node.
//      Membership mode: hit = k0 or k1 matched; a miss in a bucket of
//      size <= 2 is final.
//   3. Most tiles end there. Where a query is left, every such query
//      goes into a hash table of the block in shared memory, keyed by the
//      k-mer, which counts its multiplicity in the tile: a deep bucket,
//      and an "ultra" bucket of hundreds of rows (poly-A) just the same,
//      is then scanned once per distinct k-mer of the tile, not once per
//      query. A warp scans one bucket, 32 neighbouring rows of ks a pass;
//      in counts mode each matching row adds the multiplicity to the
//      count of its node (equal nodes of a pass added once), in
//      membership mode the scan stops at the first match and every query
//      of that k-mer reads the result back.
// Queries at index >= n_valid are padding: no hit, no count.
//
// Bound on this card: bytes. Per query 8 bytes of query and one random
// 32-byte record (a full sector), plus one byte of hit or the counts
// written once, plus the scanned rows. The random record reads are what
// the kernel waits for: on an H100 its rate was the same for a table of
// 1.3 GB and of 9.6 GB, with 1, 2 or 4 queries a thread (four made a
// block wait at its barrier for the slowest of four times as many
// loads), and with the 64-bit remainder by a run-time divisor replaced
// by a multiply-high. What the design does about it: no class byte, no
// second pass over the queries and no trip to the host for the queries
// the lanes cannot answer, and atomics only after aggregation in the
// warp or the block.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the block's table: a power of two >= 2 * kThreads, so it stays half empty
constexpr int kSlotBits = 9;
constexpr int kSlots = 1 << kSlotBits;
static_assert(kSlots >= 2 * kThreads,
              "the block's table must stay half empty");
constexpr uint32_t kDup2 = 1u << 30;
constexpr unsigned long long kEmpty = ~0ULL;  // no k-mer: hashes are < 2^62
constexpr unsigned kFull = 0xffffffffu;

struct BlockTable {
  unsigned long long key[kSlots];
  uint32_t start[kSlots];
  uint32_t size[kSlots];
  // counts mode: the k-mer's multiplicity in the tile; membership mode:
  // nonzero once a row of its bucket matched
  uint32_t mult[kSlots];
};

// Insert one pending query; returns its slot.
__device__ __forceinline__ int table_insert(BlockTable& t,
                                            unsigned long long key,
                                            uint32_t start, uint32_t size,
                                            bool count) {
  uint32_t slot = static_cast<uint32_t>(
      (key * 0x9E3779B97F4A7C15ULL) >> (64 - kSlotBits));
  for (;;) {
    const unsigned long long prev = atomicCAS(&t.key[slot], kEmpty, key);
    if (prev == kEmpty) {
      t.start[slot] = start;
      t.size[slot] = size;
    }
    if (prev == kEmpty || prev == key) {
      if (count) atomicAdd(&t.mult[slot], 1u);
      return static_cast<int>(slot);
    }
    slot = (slot + 1) & (kSlots - 1);
  }
}

template <bool kCounts>
__global__ void __launch_bounds__(kThreads)
packed_lookup_kernel(const int4* __restrict__ records,
                     const long long* __restrict__ queries, long long n_q,
                     long long n_valid, unsigned long long modulo2,
                     const long long* __restrict__ ks,
                     const long long* __restrict__ ns, long long n_rows,
                     unsigned long long* __restrict__ counts,
                     long long n_nodes, uint8_t* __restrict__ hit_out) {
  __shared__ BlockTable table;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + tid;

  const bool valid = i < n_valid;
  unsigned long long key = 0;
  int4 r0 = make_int4(-1, -1, -1, -1);
  int4 r1 = r0;
  if (valid) {
    key = static_cast<unsigned long long>(__ldcs(queries + i));
    const unsigned long long b = key % modulo2;
    r0 = __ldg(records + 2 * b);
    r1 = __ldg(records + 2 * b + 1);
  }

  // the lanes' answer; a pending query is one the bucket scan must finish
  const uint32_t lo = static_cast<uint32_t>(key);
  const uint32_t hi = static_cast<uint32_t>(key >> 32);
  const uint32_t raw = ~static_cast<uint32_t>(r0.w);
  const bool dup2 = raw >= kDup2;
  const uint32_t sz = raw & (kDup2 - 1);
  const bool hit0 = valid && static_cast<uint32_t>(r0.x) == lo &&
                    static_cast<uint32_t>(r0.y) == hi;
  const bool hit1 = valid && static_cast<uint32_t>(r1.x) == lo &&
                    static_cast<uint32_t>(r1.y) == hi;
  const bool pending = valid && (kCounts ? (sz > 2 || (dup2 && hit0))
                                         : (sz > 2 && !(hit0 || hit1)));
  if (kCounts) {
    const uint32_t node = hit0 ? static_cast<uint32_t>(r0.z)
                               : static_cast<uint32_t>(r1.z);
    const bool take = (hit0 || hit1) && !pending &&
                      static_cast<long long>(node) < n_nodes;
    const unsigned peers =
        __match_any_sync(kFull, node) & __ballot_sync(kFull, take);
    if (take && lane == __ffs(peers) - 1) {
      atomicAdd(counts + node,
                static_cast<unsigned long long>(__popc(peers)));
    }
  } else if (!pending && i < n_q) {
    hit_out[i] = (hit0 || hit1) ? 1 : 0;
  }
  // most tiles end here: the table is set up only where a query needs it
  if (!__syncthreads_or(pending)) return;

  for (int s = tid; s < kSlots; s += kThreads) {
    table.key[s] = kEmpty;
    table.mult[s] = 0;
  }
  __syncthreads();
  int slot = -1;
  if (pending) {
    slot = table_insert(table, key, static_cast<uint32_t>(r1.z), sz, kCounts);
  }
  __syncthreads();

  // one warp per distinct pending k-mer of the tile
  for (int c = tid >> 5; c < kSlots / 32; c += kWarps) {
    unsigned todo = __ballot_sync(kFull, table.key[c * 32 + lane] != kEmpty);
    while (todo) {
      const int s = c * 32 + __ffs(todo) - 1;
      todo &= todo - 1;
      const unsigned long long want = table.key[s];
      const long long first = table.start[s];
      const uint32_t size = table.size[s];
      const unsigned long long mult = table.mult[s];
      for (uint32_t r = 0; r < size; r += 32) {
        const long long row = first + r + lane;
        const bool match = r + lane < size && row < n_rows &&
                           static_cast<unsigned long long>(ks[row]) == want;
        if (kCounts) {
          const long long node = match ? ns[row] : -1;
          const bool take = match && node >= 0 && node < n_nodes;
          const unsigned peers =
              __match_any_sync(kFull, node) & __ballot_sync(kFull, take);
          if (take && lane == __ffs(peers) - 1) {
            atomicAdd(counts + node, mult * __popc(peers));
          }
        } else if (__any_sync(kFull, match)) {
          if (lane == 0) table.mult[s] = 1;
          break;
        }
      }
    }
  }
  if (kCounts) return;
  __syncthreads();
  if (slot >= 0) hit_out[i] = table.mult[slot] ? 1 : 0;
}

}  // namespace

// counts_mode != 0: counts mode (counts: n_nodes zeroed int64; hit_out
// unused), else membership mode (hit_out: n_q bytes, every one written;
// counts unused). ks and ns hold n_rows rows each.
extern "C" int gki_packed_lookup(const void* records, const void* queries,
                                 long long n_q, long long n_valid,
                                 unsigned long long modulo2, const void* ks,
                                 const void* ns, long long n_rows,
                                 void* counts, long long n_nodes,
                                 void* hit_out, int counts_mode,
                                 void* stream) {
  if (n_q <= 0) return 0;
  const unsigned int blocks =
      static_cast<unsigned int>((n_q + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (counts_mode) {
    packed_lookup_kernel<true><<<blocks, kThreads, 0, st>>>(
        static_cast<const int4*>(records),
        static_cast<const long long*>(queries), n_q, n_valid, modulo2,
        static_cast<const long long*>(ks), static_cast<const long long*>(ns),
        n_rows, static_cast<unsigned long long*>(counts), n_nodes, nullptr);
  } else {
    packed_lookup_kernel<false><<<blocks, kThreads, 0, st>>>(
        static_cast<const int4*>(records),
        static_cast<const long long*>(queries), n_q, n_valid, modulo2,
        static_cast<const long long*>(ks), static_cast<const long long*>(ns),
        n_rows, nullptr, 0, static_cast<uint8_t*>(hit_out));
  }
  return static_cast<int>(cudaGetLastError());
}
