// K2: packed-record decode + lane counts / lane membership.
//
// Replaces the XLA decode head of graph_kmer_index_tpu/ops/lookup.py:
// _decode_group_rows/_packed_decode, _lane_counts, and the decode halves
// of _counts_decode_packed and _member_decode_packed. The table is one
// 32-byte record per internal bucket b (int32 lanes):
//   [k0_lo, k0_hi, node0, ~(size | dup2 << 30), k1_lo, k1_hi,
//    node1 or start row, spare]
// with all-ones (-1) lanes for an empty slot, so an empty size lane reads
// as size 0 and an empty key never matches a hash (< 2^62).
//
// One thread per query:
//   b = q % modulo2; load the record as two 16-byte loads; decode the
//   size and the dup2 flag; compare k0 and k1;
//   counts mode: class = ultra (size > SCAN_CAP), deep (size > 2, or a
//     dup2 bucket whose k0 matched) or lane-resolved; a lane hit adds one
//     to the int64 count of its node (nodes >= n_nodes are dropped);
//   membership mode: hit = k0 or k1 matched; a miss is ultra or deep by
//     the same size rules, else final.
// The class byte sends deep and ultra queries to the plain-torch
// follow-ups (bucket scan, per-unique resolution). Queries at index
// >= n_valid are padding: class 0, no hit, no count.
//
// Bound on this card: one random 32-byte record read per query (a full
// 32-byte sector, so no wasted DRAM bytes) plus one atomic per lane hit.
// The TPU path gathered a 512-byte group row and selected lanes with a
// masked sum because its gathers were row-granular; here the record
// itself is gathered, and counts aggregate by atomics instead of the
// TPU's sort-based _aggregate_counts_sorted.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kDup2 = 1u << 30;
constexpr uint32_t kScanCap = 256;

__global__ void packed_decode_kernel(const int4* __restrict__ records,
                                     const long long* __restrict__ queries,
                                     long long n_q, long long n_valid,
                                     long long modulo2,
                                     unsigned long long* __restrict__ counts,
                                     long long n_nodes,
                                     uint8_t* __restrict__ hit_out,
                                     uint8_t* __restrict__ cls_out) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_q) return;
  uint8_t cls = 0;
  uint8_t hit = 0;
  if (i < n_valid) {
    const unsigned long long key =
        static_cast<unsigned long long>(queries[i]);
    const unsigned long long b =
        key % static_cast<unsigned long long>(modulo2);
    const int4 r0 = __ldg(records + 2 * b);
    const int4 r1 = __ldg(records + 2 * b + 1);
    const uint32_t lo = static_cast<uint32_t>(key);
    const uint32_t hi = static_cast<uint32_t>(key >> 32);
    const uint32_t raw = ~static_cast<uint32_t>(r0.w);
    const bool dup2 = raw >= kDup2;
    const uint32_t sz = raw & (kDup2 - 1);
    const bool hit0 = static_cast<uint32_t>(r0.x) == lo &&
                      static_cast<uint32_t>(r0.y) == hi;
    const bool hit1 = static_cast<uint32_t>(r1.x) == lo &&
                      static_cast<uint32_t>(r1.y) == hi;
    if (counts != nullptr) {
      const bool ultra = sz > kScanCap;
      const bool deep = !ultra && (sz > 2 || (dup2 && hit0));
      cls = ultra ? 2 : (deep ? 1 : 0);
      if (cls == 0 && (hit0 || hit1)) {
        const uint32_t node = hit0 ? static_cast<uint32_t>(r0.z)
                                   : static_cast<uint32_t>(r1.z);
        if (static_cast<long long>(node) < n_nodes) {
          atomicAdd(counts + node, 1ULL);
        }
      }
    } else {
      hit = (hit0 || hit1) ? 1 : 0;
      if (!hit) cls = sz > kScanCap ? 2 : (sz > 2 ? 1 : 0);
    }
  }
  if (hit_out != nullptr) hit_out[i] = hit;
  cls_out[i] = cls;
}

}  // namespace

// counts != nullptr selects counts mode, else membership mode (hit_out
// must then be non-null).
extern "C" int gki_packed_decode(const void* records, const void* queries,
                                 long long n_q, long long n_valid,
                                 long long modulo2, void* counts,
                                 long long n_nodes, void* hit_out,
                                 void* cls_out, void* stream) {
  if (n_q <= 0) return 0;
  const long long blocks = (n_q + kThreads - 1) / kThreads;
  packed_decode_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(records),
      static_cast<const long long*>(queries), n_q, n_valid, modulo2,
      static_cast<unsigned long long*>(counts), n_nodes,
      static_cast<uint8_t*>(hit_out), static_cast<uint8_t*>(cls_out));
  return static_cast<int>(cudaGetLastError());
}
