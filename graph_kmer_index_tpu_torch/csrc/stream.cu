// K4 stream_copy and K5 stream_sum: the device-memory bandwidth controls.
//
// K4 replaces benchmarks/bench_primitives.py:k_pallas_stream_copy (a pure
// copy of a float32 table: read n bytes, write n bytes), K5
// k_pallas_stream_sum (one float32 sum per block of rows plus a seed
// scalar: read n bytes, write one word per block). A bandwidth-bound
// kernel such as K1 or K3 is judged against the rates these two reach.
//
// Bound on this card: bytes, by construction. A control must fix its
// access size in source: K4 moves tiles of kTileBytes, K5 reads 16 bytes
// a thread a time.
// K4: no byte passes through a register. A block is one warp whose first
// lane walks the tiles blockIdx.x, blockIdx.x + gridDim.x, ...: the
// card's bulk asynchronous copy (cp.async.bulk, the 1-D form without a
// tensor map) brings a tile from device memory into a ring of kStages
// shared-memory tiles and reports its bytes to the stage's mbarrier; a
// second bulk copy sends the tile from shared memory to its place in the
// output, as one bulk group per tile. A stage is loaded again once the
// group that read it has finished reading (wait_group.read), one tile
// behind the newest store, so kStages - 1 loads and up to two stores are
// in flight per block. A last tile shorter than kTileBytes, and a table
// shorter than one tile, are copied at their own length (always whole
// 16-byte words). Tile, ring depth and blocks an SM are the fastest of
// the sizes that were timed on an H100; the kernel stays a few percent
// behind clone(), which copies with the card's copy engine, not a kernel.
// K5: one block per row block (the TPU kernel's grid step), kSumUnroll
// independent partial sums per thread, then a warp-shuffle reduction and
// one shared-memory pass over the warps' sums. The TPU kernel's SMEM seed
// scalar becomes a read of seed[0] by the thread that writes the sum.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileBytes = 32768;  // primitives.COPY_TILE_BYTES
constexpr long long kTile4 = kTileBytes / 16;  // float4 words a tile
constexpr int kStages = 3;  // tiles in the shared-memory ring
constexpr int kCopyBlocksPerSm = 2;
constexpr int kCopyThreads = 32;
static_assert(kTileBytes % 16 == 0, "a tile is whole 16-byte words");
static_assert(kStages >= 3, "the ring keeps a load and two stores in flight");
constexpr int kSumThreads = 1024;
constexpr int kSumUnroll = 4;
constexpr int kWarps = kSumThreads / 32;

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool barrier_passed(uint32_t bar,
                                               uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Announce the tile's bytes to the stage's barrier and start its load.
__device__ __forceinline__ void load_tile(uint32_t dst, const float4* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void store_tile(float4* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(src), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(kCopyThreads)
stream_copy_kernel(const float4* __restrict__ in, float4* __restrict__ out,
                   long long n4) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) unsigned long long full[kStages];
  if (threadIdx.x != 0) return;
  const long long n_tiles = (n4 + kTile4 - 1) / kTile4;
  // this block's tiles: first + i * step for i < mine
  const long long first = blockIdx.x;
  const long long step = gridDim.x;
  const long long mine = (n_tiles - first + step - 1) / step;
  auto tile_at = [&](long long i) { return (first + i * step) * kTile4; };
  auto tile_bytes = [&](long long i) {
    const long long left = n4 - tile_at(i);
    return static_cast<uint32_t>((left < kTile4 ? left : kTile4) * 16);
  };
  for (int s = 0; s < kStages; ++s) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(shared_address(&full[s])) : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  for (long long i = 0; i < kStages && i < mine; ++i) {
    load_tile(shared_address(ring + i * kTileBytes), in + tile_at(i),
              tile_bytes(i), shared_address(&full[i]));
  }
  for (long long i = 0; i < mine; ++i) {
    const int s = static_cast<int>(i % kStages);
    const uint32_t parity = static_cast<uint32_t>((i / kStages) & 1);
    while (!barrier_passed(shared_address(&full[s]), parity)) {
    }
    store_tile(out + tile_at(i), shared_address(ring + s * kTileBytes),
               tile_bytes(i));
    // the store before this one has read its stage: load that stage again
    const long long next = i - 1 + kStages;
    if (i >= 1 && next < mine) {
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      const int ps = static_cast<int>((i - 1) % kStages);
      load_tile(shared_address(ring + ps * kTileBytes), in + tile_at(next),
                tile_bytes(next), shared_address(&full[ps]));
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  return s;
}

__global__ void stream_sum_kernel(const float4* __restrict__ table,
                                  const int* __restrict__ seed,
                                  float* __restrict__ out,
                                  long long block4) {
  __shared__ float partial[kWarps];
  const float4* blk = table + static_cast<long long>(blockIdx.x) * block4;
  float acc[kSumUnroll] = {};
  long long i = threadIdx.x;
  for (; i + (kSumUnroll - 1) * kSumThreads < block4;
       i += kSumUnroll * kSumThreads) {
#pragma unroll
    for (int u = 0; u < kSumUnroll; ++u) {
      const float4 v = blk[i + u * kSumThreads];
      acc[u] += (v.x + v.y) + (v.z + v.w);
    }
  }
  for (; i < block4; i += kSumThreads) {
    const float4 v = blk[i];
    acc[0] += (v.x + v.y) + (v.z + v.w);
  }
  float s = 0.0f;
#pragma unroll
  for (int u = 0; u < kSumUnroll; ++u) s += acc[u];
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x < 32) {
    s = warp_sum(threadIdx.x < kWarps ? partial[threadIdx.x] : 0.0f);
    if (threadIdx.x == 0) {
      out[blockIdx.x] = s + static_cast<float>(seed[0]);
    }
  }
}

}  // namespace

// n4: number of float4 words; in and out 16-byte aligned.
extern "C" int gki_stream_copy(const void* in, void* out, long long n4,
                               void* stream) {
  if (n4 <= 0) return 0;
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (n4 + kTile4 - 1) / kTile4;  // a block per tile
  const long long cap = static_cast<long long>(sms) * kCopyBlocksPerSm;
  const unsigned int blocks =
      static_cast<unsigned int>(want < cap ? want : cap);
  const size_t shared = static_cast<size_t>(kStages) * kTileBytes;
  err = cudaFuncSetAttribute(stream_copy_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(shared));
  if (err != cudaSuccess) return static_cast<int>(err);
  stream_copy_kernel<<<blocks, kCopyThreads, shared,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(in), static_cast<float4*>(out), n4);
  return static_cast<int>(cudaGetLastError());
}

// n_blocks row blocks of block4 float4 words each; table 16-byte aligned,
// seed one int32 on the device, out n_blocks float32.
extern "C" int gki_stream_sum(const void* table, const void* seed,
                              void* out, long long n_blocks,
                              long long block4, void* stream) {
  if (n_blocks <= 0) return 0;
  stream_sum_kernel<<<static_cast<unsigned int>(n_blocks), kSumThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(table), static_cast<const int*>(seed),
      static_cast<float*>(out), block4);
  return static_cast<int>(cudaGetLastError());
}
