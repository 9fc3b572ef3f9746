// K1: sliding-window k-mer hash of a 2-bit base tape.
//
// Replaces graph_kmer_index_tpu/ops/encode.py:_hash_kernel (the Pallas
// kernel behind sliding_hashes_pallas) and its XLA twins sliding_hashes /
// sliding_hashes_u32. out[i] = sum_{j<k} seq[i+j] << 2j, first base least
// significant, windows running past n read zeros; k in 1..31, so the hash
// fits 62 bits and is stored as int64.
//
// Bound on this card: bytes. Each base costs 1 byte in and 8 bytes out,
// no arithmetic to speak of, so the ceiling is device-memory bandwidth.
// Design: one block stages a tile of TILE bases plus a 32-base halo in
// shared memory with coalesced loads; each thread owns PER_THREAD
// consecutive positions, packs its first window from shared memory and
// rolls the next ones (h >> 2 | next << 2(k-1)). The TPU kernel's lane
// rolls, halo rows and (lo, hi) u32 split exist only because that chip
// emulates uint64; Hopper has native 64-bit integer ops, so none of it
// is carried over.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;
constexpr int kHalo = 32;  // >= k for every k <= 31

__global__ void sliding_hash_kernel(const uint8_t* __restrict__ seq,
                                    long long* __restrict__ out,
                                    long long n, int k) {
  __shared__ uint8_t tile[kTile + kHalo];
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  for (int t = threadIdx.x; t < kTile + kHalo; t += kThreads) {
    const long long p = base + t;
    tile[t] = p < n ? seq[p] : 0;
  }
  __syncthreads();

  const int off = threadIdx.x * kPerThread;
  unsigned long long h = 0;
  for (int j = 0; j < k; ++j) {
    h |= static_cast<unsigned long long>(tile[off + j]) << (2 * j);
  }
  const int top = 2 * (k - 1);
  const long long p = base + off;
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    if (p + r < n) out[p + r] = static_cast<long long>(h);
    h = (h >> 2) |
        (static_cast<unsigned long long>(tile[off + r + k]) << top);
  }
}

}  // namespace

extern "C" int gki_sliding_hash(const void* seq, void* out, long long n,
                                int k, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kTile - 1) / kTile;
  sliding_hash_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seq), static_cast<long long*>(out), n, k);
  return static_cast<int>(cudaGetLastError());
}
