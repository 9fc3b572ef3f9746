// K3: sliding-window 2-bit packing of a base tape, P16 or P8.
//
// Replaces graph_kmer_index_tpu/ops/encode.py:_pack_kernel (the Pallas
// kernel behind _sliding_pack_pallas, sliding_p16_pallas and
// sliding_p8_pallas). out[i] = sum_{t<m} seq[i+t] << 2t, first base least
// significant, windows running past n reading zeros, with m = min(k, 16)
// stored as uint32 (P16) or m = min(k, 8) stored as uint16 (P8). The
// wrapper hands in int32 / int16 tensors, which hold the same bits. The
// full k-mer hash derives from this stream outside the kernel
// (ops/encode.py: p16_to_lanes, p8_to_lanes, combine_lanes).
//
// Bound on this card: bytes. Each base costs 1 byte in and 4 (P16) or 2
// (P8) bytes out, against K1's 1 + 8, and no arithmetic to speak of, so
// the ceiling is device-memory bandwidth.
// Design: K1's. One block stages a tile of kTile bases plus a 16-base halo
// in shared memory with coalesced loads; each thread owns kPerThread
// consecutive positions, packs its first window from shared memory, rolls
// the next ones in u32 (p >> 2 | next << 2(m-1)) and writes its outputs
// as one vector store (16 bytes for P16, 8 for P8). The TPU kernel's lane
// rolls and 128-column halo rows are not carried over.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;
constexpr int kHalo = 16;  // >= m for every m <= 16

// Out is the stored lane type; Vec holds kPerThread of them.
template <typename Out, typename Vec>
__global__ void sliding_pack_kernel(const uint8_t* __restrict__ seq,
                                    Out* __restrict__ out, long long n,
                                    int m) {
  static_assert(sizeof(Vec) == kPerThread * sizeof(Out), "vector width");
  __shared__ uint8_t tile[kTile + kHalo];
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  for (int t = threadIdx.x; t < kTile + kHalo; t += kThreads) {
    const long long p = base + t;
    tile[t] = p < n ? seq[p] : 0;
  }
  __syncthreads();

  const int off = threadIdx.x * kPerThread;
  uint32_t w = 0;
  for (int j = 0; j < m; ++j) {
    w |= static_cast<uint32_t>(tile[off + j]) << (2 * j);
  }
  const int top = 2 * (m - 1);
  alignas(sizeof(Vec)) Out v[kPerThread];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    v[r] = static_cast<Out>(w);
    w = (w >> 2) | (static_cast<uint32_t>(tile[off + r + m]) << top);
  }
  const long long p = base + off;
  if (p + kPerThread <= n) {
    // out is a fresh allocation and p a multiple of kPerThread, so the
    // store is aligned to sizeof(Vec)
    *reinterpret_cast<Vec*>(out + p) = *reinterpret_cast<const Vec*>(v);
  } else {
    for (int r = 0; r < kPerThread; ++r) {
      if (p + r < n) out[p + r] = v[r];
    }
  }
}

}  // namespace

// out_bytes 4: P16 (m <= 16, uint32 lanes); out_bytes 2: P8 (m <= 8,
// uint16 lanes). out must be aligned to 4 * out_bytes.
extern "C" int gki_sliding_pack(const void* seq, void* out, long long n,
                                int m, int out_bytes, void* stream) {
  if (n <= 0) return 0;
  if (m < 1 || (out_bytes == 4 && m > 16) || (out_bytes == 2 && m > 8) ||
      (out_bytes != 4 && out_bytes != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned int blocks =
      static_cast<unsigned int>((n + kTile - 1) / kTile);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* in = static_cast<const uint8_t*>(seq);
  if (out_bytes == 4) {
    sliding_pack_kernel<uint32_t, uint4><<<blocks, kThreads, 0, s>>>(
        in, static_cast<uint32_t*>(out), n, m);
  } else {
    sliding_pack_kernel<uint16_t, uint2><<<blocks, kThreads, 0, s>>>(
        in, static_cast<uint16_t*>(out), n, m);
  }
  return static_cast<int>(cudaGetLastError());
}
