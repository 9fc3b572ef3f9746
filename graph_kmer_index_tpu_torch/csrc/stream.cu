// K4 stream_copy and K5 stream_sum: the device-memory bandwidth controls.
//
// K4 replaces benchmarks/bench_primitives.py:k_pallas_stream_copy (a pure
// copy of a float32 table: read n bytes, write n bytes), K5
// k_pallas_stream_sum (one float32 sum per block of rows plus a seed
// scalar: read n bytes, write one word per block). A bandwidth-bound
// kernel such as K1 or K3 is judged against the rates these two reach.
//
// Bound on this card: bytes, by construction. A control must fix its
// access width in source, so both read (and K4 writes) 16 bytes a thread
// a time; neighbouring threads touch neighbouring 16-byte words.
// K4: grid-stride over float4, kCopyUnroll loads in flight per thread
// before their stores, a grid of kCopyBlocksPerSm blocks per SM.
// K5: one block per row block (the TPU kernel's grid step), kSumUnroll
// independent partial sums per thread, then a warp-shuffle reduction and
// one shared-memory pass over the warps' sums. The TPU kernel's SMEM seed
// scalar becomes a read of seed[0] by the thread that writes the sum.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCopyThreads = 256;
constexpr int kCopyUnroll = 4;
constexpr int kCopyBlocksPerSm = 8;
constexpr int kSumThreads = 1024;
constexpr int kSumUnroll = 4;
constexpr int kWarps = kSumThreads / 32;

__global__ void stream_copy_kernel(const float4* __restrict__ in,
                                   float4* __restrict__ out, long long n4) {
  const long long stride = static_cast<long long>(gridDim.x) * kCopyThreads;
  long long i = static_cast<long long>(blockIdx.x) * kCopyThreads +
                threadIdx.x;
  for (; i + (kCopyUnroll - 1) * stride < n4; i += kCopyUnroll * stride) {
    float4 v[kCopyUnroll];
#pragma unroll
    for (int u = 0; u < kCopyUnroll; ++u) v[u] = in[i + u * stride];
#pragma unroll
    for (int u = 0; u < kCopyUnroll; ++u) out[i + u * stride] = v[u];
  }
  for (; i < n4; i += stride) out[i] = in[i];
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
  const long long want = (n4 + kCopyThreads - 1) / kCopyThreads;
  const long long cap = static_cast<long long>(sms) * kCopyBlocksPerSm;
  const unsigned int blocks =
      static_cast<unsigned int>(want < cap ? want : cap);
  stream_copy_kernel<<<blocks, kCopyThreads, 0,
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
