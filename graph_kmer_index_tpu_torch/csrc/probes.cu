// K6 gather_loop, K7 rmw_loop and K8 bcast_cmp: the lookup's probes.
//
// They replace the three Pallas probes of benchmarks/bench_primitives.py,
// which measure the building blocks of a bucket-scan lookup on the chip:
//   K6  k_pallas_gather_loop: per block of block_q int32 indices into an
//       (n_t, cols) int32 table, out[b] = sum of table[idx[i], 0], an
//       int32 sum that wraps (a dynamic gather);
//   K7  k_pallas_rmw_loop: zeroed (n_c, cols) int32 counts with
//       counts[idx[i], 0] += 1 (a read-modify-write count);
//   K8  k_pallas_bcast_cmp: every query (lo, hi) against every table entry
//       (tlo[j], thi[j]); cnt = number of matches, node = tnode of the
//       first matching j, else 0 (a broadcast key compare).
// An index outside the table counts nothing in K6 and K7 (the Pallas
// kernels leave it undefined; the plain twins in ops/primitives.py skip
// it the same way).
//
// Bound on this card: K6 and K7 by the bytes of their indices (16 MiB at
// the benchmark's size, 5 us of device memory time, where an empty launch
// of this grid already takes 2.7 us), K8 by integer compares (n_q x n_t
// pairs). What the designs do:
// - K6 and K7 read their indices as 16-byte vectors with a streaming hint
//   on a grid of one thread block an SM, all resident at once (both are
//   cooperative launches). A base that is not 16-byte aligned and a length
//   that is no whole vector are met with up to three scalar loads at
//   either end. A vector past the end reads as -1, an index that counts
//   nothing.
// - K6 gathers from shared memory, the counterpart of the TPU's VMEM-
//   resident table: the one column it reads (n_t int32; 16 KiB for the
//   benchmark's 4096 rows; the whole table is 2 MiB and does not fit). A
//   block that stages the column by itself waits 2.7 us for its 4096
//   strided sectors, whatever else is in flight; so the grid packs the
//   column once into a scratch, synchronises, and each block copies the
//   packed 16 KiB. A thread block then walks the index blocks blockIdx.x,
//   blockIdx.x + gridDim.x, ...: a uint32 accumulator (addition mod 2^32
//   is associative, so any order gives the int32 wrap of the sequential
//   sum), a warp-shuffle and block reduction.
// - K7 writes every byte of its output once, so the table needs no zeroing
//   beforehand. Each thread block builds a shared-memory histogram of the
//   n_c bins (atomicAdd) over a grid-stride share of the indices and
//   writes it to its row of a scratch; meanwhile it zeroes columns 1.. of
//   its own slice of output rows. After the grid's barrier each block sums
//   its slice of bins over all the scratch rows and writes column 0. No
//   global atomic.
// - K8 stages tlo, thi and tnode (3 x n_t int32; 6 KiB for 512 entries) in
//   shared memory, where every thread of a warp reads the same j (a
//   broadcast). Each thread keeps kCmpQ queries in registers and walks j
//   in order, so the first match wins.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // K8
constexpr int kCmpQ = 4;
constexpr int kGatherThreads = 1024;
constexpr int kGatherWarps = kGatherThreads / 32;
constexpr int kGatherVecs = 2;  // 16-byte index loads a thread makes an item
constexpr int kRmwThreads = 1024;
constexpr int kRmwVecs = 3;  // 16-byte index loads a thread has in flight

__device__ unsigned int warp_sum(unsigned int s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  return s;
}

// A run of n int32 at q as scalars up to the first 16-byte boundary (head),
// whole 16-byte vectors (nvec, from vec), and the scalars left over (tail).
struct Span {
  const int32_t* q;
  const int4* vec;
  long long nvec;
  int head;
  int tail;
};

__device__ __forceinline__ Span make_span(const int32_t* q, long long n) {
  long long head = ((16 - (reinterpret_cast<uintptr_t>(q) & 15)) & 15) >> 2;
  if (head > n) head = n;
  const long long body = n - head;
  return {q, reinterpret_cast<const int4*>(q + head), body >> 2,
          static_cast<int>(head), static_cast<int>(body & 3)};
}

// Vector v of the span, or four times -1 (no index) past its end.
__device__ __forceinline__ int4 load_vec(const Span& s, long long v) {
  return v < s.nvec ? __ldcs(s.vec + v) : make_int4(-1, -1, -1, -1);
}

// The scalars at the span's ends, one per thread tid: 0, 1 or 2 indices,
// -1 where the thread has none.
__device__ __forceinline__ int2 load_ends(const Span& s, int tid) {
  return make_int2(tid < s.head ? s.q[tid] : -1,
                   tid < s.tail ? s.q[s.head + 4 * s.nvec + tid] : -1);
}

__device__ __forceinline__ unsigned int pick(const int32_t* col0, int j,
                                             int n_t) {
  return static_cast<unsigned int>(j) < static_cast<unsigned int>(n_t)
             ? static_cast<unsigned int>(col0[j])
             : 0u;
}

// Index block blk as chunks of kGatherVecs * kGatherThreads vectors: this
// thread's kGatherVecs vectors of chunk number chunk.
__device__ __forceinline__ void load_chunk(const int32_t* idx, int block_q,
                                           long long blk, int chunk,
                                           int4 (&r)[kGatherVecs]) {
  const Span s = make_span(idx + blk * block_q, block_q);
#pragma unroll
  for (int u = 0; u < kGatherVecs; ++u) {
    r[u] = load_vec(s, (static_cast<long long>(chunk) * kGatherVecs + u) *
                               kGatherThreads +
                           threadIdx.x);
  }
}

__global__ void __launch_bounds__(kGatherThreads, 1)
    gather_loop_kernel(const int32_t* __restrict__ idx,
                       const int32_t* __restrict__ table, int n_t,
                       long long cols, int block_q, long long n_blocks,
                       int32_t* __restrict__ out, int32_t* scratch) {
  extern __shared__ __align__(16) int32_t col0[];  // whole 16-byte vectors
  __shared__ unsigned int partial[2][kGatherWarps];
  constexpr int kChunk = kGatherVecs * kGatherThreads;  // vectors
  const int tid = threadIdx.x;
  const long long n_grid = gridDim.x;
  // Column 0 into shared memory. Its words are a row (512 bytes) apart, a
  // 32-byte sector each, so the grid reads them once, a few rows a block,
  // into the scratch; after the grid's barrier every block takes the
  // packed column from there, 16 bytes a thread. No index load is made
  // before the barrier: the gathers wait for the column, and every load
  // in flight beside its rows made it later.
  for (long long r = tid * n_grid + blockIdx.x; r < n_t;
       r += kGatherThreads * n_grid) {
    __stcg(scratch + r, table[r * cols]);
  }
  // This block's work: the index blocks blockIdx.x, blockIdx.x + n_grid,
  // ..., each in `chunks` chunks (one where a block is 8192 indices); item
  // w is chunk w % chunks of the (w / chunks)-th of them. A thread loads
  // its vectors of the next item as soon as it has gathered the current
  // one's: deeper queues of loads made the launch slower.
  const int chunks = max(1, (block_q / 4 + kChunk - 1) / kChunk);
  const long long items =
      (n_blocks - blockIdx.x + n_grid - 1) / n_grid * chunks;  // >= 1
  auto load_item = [&](long long w, int4(&r)[kGatherVecs]) {
    load_chunk(idx, block_q, blockIdx.x + w / chunks * n_grid,
               static_cast<int>(w % chunks), r);
  };
  cooperative_groups::this_grid().sync();
  int4 cur[kGatherVecs];
  load_item(0, cur);
  for (int v = tid; v < (n_t + 3) / 4; v += kGatherThreads) {
    reinterpret_cast<int4*>(col0)[v] =
        __ldcg(reinterpret_cast<const int4*>(scratch) + v);
  }
  __syncthreads();
  long long blk = blockIdx.x;
  int chunk = 0;
  int round = 0;
  unsigned int acc = 0;
  for (long long w = 0; w < items; ++w) {
#pragma unroll
    for (int u = 0; u < kGatherVecs; ++u) {
      acc += pick(col0, cur[u].x, n_t) + pick(col0, cur[u].y, n_t) +
             pick(col0, cur[u].z, n_t) + pick(col0, cur[u].w, n_t);
    }
    if (w + 1 < items) load_item(w + 1, cur);
    if (++chunk < chunks) continue;
    // the index block is complete: its ends, then the block's sum
    const int2 ends = load_ends(make_span(idx + blk * block_q, block_q), tid);
    acc += pick(col0, ends.x, n_t) + pick(col0, ends.y, n_t);
    acc = warp_sum(acc);
    if ((tid & 31) == 0) partial[round][tid >> 5] = acc;
    __syncthreads();
    if (tid < 32) {
      acc = warp_sum(tid < kGatherWarps ? partial[round][tid] : 0u);
      if (tid == 0) out[blk] = static_cast<int32_t>(acc);
    }
    acc = 0;
    chunk = 0;
    round ^= 1;
    blk += n_grid;
  }
}

__device__ __forceinline__ void count(int32_t* hist, int j, int n_c) {
  if (static_cast<unsigned int>(j) < static_cast<unsigned int>(n_c)) {
    atomicAdd(&hist[j], 1);
  }
}

__global__ void __launch_bounds__(kRmwThreads, 1)
    rmw_loop_kernel(const int32_t* __restrict__ idx, long long n_q, int n_c,
                    long long cols, int32_t* __restrict__ counts,
                    int32_t* scratch) {
  extern __shared__ int32_t hist[];  // max(n_c, kRmwThreads) words
  const int tid = threadIdx.x;
  const int n_grid = gridDim.x;
  // this block's grid-stride share of the indices; its first vectors are
  // on their way while the histogram and the output rows are zeroed
  const Span s = make_span(idx, n_q);
  const long long stride = static_cast<long long>(n_grid) * kRmwThreads;
  long long v = static_cast<long long>(blockIdx.x) * kRmwThreads + tid;
  int4 cur[kRmwVecs];
#pragma unroll
  for (int u = 0; u < kRmwVecs; ++u) cur[u] = load_vec(s, v + u * stride);
  const int2 ends = blockIdx.x == 0 ? load_ends(s, tid) : make_int2(-1, -1);
  for (int r = tid; r < n_c; r += kRmwThreads) hist[r] = 0;

  // this block's slice of output rows: columns 1.. are zero whatever the
  // indices are, a warp a row
  const int per_block = (n_c + n_grid - 1) / n_grid;
  const int r0 = blockIdx.x * per_block;
  const int width = min(per_block, n_c - r0);  // <= 0: no row left
  for (int r = tid >> 5; r < width; r += kRmwThreads / 32) {
    int32_t* row = counts + static_cast<long long>(r0 + r) * cols;
    for (long long c = 1 + (tid & 31); c < cols; c += 32) row[c] = 0;
  }
  __syncthreads();

  count(hist, ends.x, n_c);
  count(hist, ends.y, n_c);
  for (; v < s.nvec; v += kRmwVecs * stride) {
    int4 nxt[kRmwVecs];
#pragma unroll
    for (int u = 0; u < kRmwVecs; ++u) {
      nxt[u] = load_vec(s, v + (kRmwVecs + u) * stride);
    }
#pragma unroll
    for (int u = 0; u < kRmwVecs; ++u) {
      count(hist, cur[u].x, n_c);
      count(hist, cur[u].y, n_c);
      count(hist, cur[u].z, n_c);
      count(hist, cur[u].w, n_c);
      cur[u] = nxt[u];
    }
  }
  __syncthreads();
  int32_t* mine = scratch + static_cast<long long>(blockIdx.x) * n_c;
  for (int r = tid; r < n_c; r += kRmwThreads) __stcg(mine + r, hist[r]);
  cooperative_groups::this_grid().sync();

  // column 0 of the slice: tile bins of it at a time, tile x lanes threads,
  // each the sum of every lanes-th scratch row; then one thread a bin
  if (width <= 0) return;
  const int tile = min(width, kRmwThreads);
  const int lanes = kRmwThreads / tile;
  const int w = tid % tile;
  const int lane = tid / tile;
  for (int base = 0; base < width; base += tile) {
    int sum = 0;
    if (lane < lanes && base + w < width) {
      const int32_t* bin = scratch + r0 + base + w;
#pragma unroll 4
      for (int g = lane; g < n_grid; g += lanes) {
        sum += __ldcg(bin + static_cast<long long>(g) * n_c);
      }
    }
    __syncthreads();  // the sums of the tile before have been read
    if (lane < lanes) hist[lane * tile + w] = sum;
    __syncthreads();
    if (tid < tile && base + tid < width) {
      int total = 0;
      for (int k = 0; k < lanes; ++k) total += hist[k * tile + tid];
      counts[static_cast<long long>(r0 + base + tid) * cols] = total;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    bcast_cmp_kernel(const int32_t* __restrict__ qlo,
                     const int32_t* __restrict__ qhi, long long n_q,
                     const int32_t* __restrict__ tlo,
                     const int32_t* __restrict__ thi,
                     const int32_t* __restrict__ tnode, int n_t,
                     int32_t* __restrict__ node_out,
                     int32_t* __restrict__ cnt_out) {
  extern __shared__ int32_t tab[];  // tlo | thi | tnode
  for (int r = threadIdx.x; r < n_t; r += kThreads) {
    tab[r] = tlo[r];
    tab[n_t + r] = thi[r];
    tab[2 * n_t + r] = tnode[r];
  }
  __syncthreads();
  const long long base =
      static_cast<long long>(blockIdx.x) * kThreads * kCmpQ + threadIdx.x;
  int32_t lo[kCmpQ], hi[kCmpQ], node[kCmpQ], cnt[kCmpQ];
#pragma unroll
  for (int u = 0; u < kCmpQ; ++u) {
    const long long i = base + u * kThreads;
    lo[u] = i < n_q ? qlo[i] : 0;
    hi[u] = i < n_q ? qhi[i] : 0;
    node[u] = 0;
    cnt[u] = 0;
  }
  for (int j = 0; j < n_t; ++j) {
    const int32_t a = tab[j], b = tab[n_t + j], c = tab[2 * n_t + j];
#pragma unroll
    for (int u = 0; u < kCmpQ; ++u) {
      const bool m = (lo[u] == a) & (hi[u] == b);
      node[u] = (m & (cnt[u] == 0)) ? c : node[u];
      cnt[u] += m;
    }
  }
#pragma unroll
  for (int u = 0; u < kCmpQ; ++u) {
    const long long i = base + u * kThreads;
    if (i < n_q) {
      node_out[i] = node[u];
      cnt_out[i] = cnt[u];
    }
  }
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return static_cast<int>(err);
}

}  // namespace

// Each kernel stages its table in dynamic shared memory, which the
// wrappers keep within 48 KiB. K6 has a few static words beside it, so
// where the two pass 48 KiB its limit is raised to what it asks for.

// idx: n_q int32 (n_q a multiple of block_q), 4-byte aligned; table: n_t
// rows of cols int32, row-major; out: n_q / block_q int32; scratch: n_t
// int32 rounded up to whole 16-byte vectors, 16-byte aligned, written and
// read back by this launch. A cooperative launch of at most a thread block
// an SM.
extern "C" int gki_gather_loop(const void* idx, const void* table,
                               long long n_q, int n_t, long long cols,
                               int block_q, void* out, void* scratch,
                               void* stream) {
  if (n_q <= 0) return 0;
  int sms = 0;
  const int err = sm_count(&sms);
  if (err != 0) return err;
  long long n_blocks = n_q / block_q;
  const size_t shared = (static_cast<size_t>(n_t) + 3) / 4 * sizeof(int4);
  if (shared + sizeof(unsigned int) * 2 * kGatherWarps > 48 * 1024) {
    const cudaError_t attr = cudaFuncSetAttribute(
        gather_loop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (attr != cudaSuccess) return static_cast<int>(attr);
  }
  void* args[] = {(void*)&idx,     (void*)&table,    (void*)&n_t,
                  (void*)&cols,    (void*)&block_q,  (void*)&n_blocks,
                  (void*)&out,     (void*)&scratch};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(gather_loop_kernel),
      dim3(static_cast<unsigned int>(n_blocks < sms ? n_blocks : sms)),
      dim3(kGatherThreads), args, shared, static_cast<cudaStream_t>(stream)));
}

// idx: n_q int32, 4-byte aligned; counts: n_c rows of cols int32,
// row-major, written whole (it need not be zeroed); scratch: n_grid rows of
// n_c int32, written and read back by this launch. n_grid thread blocks
// must be resident at once (one an SM): a cooperative launch, which the
// card refuses otherwise.
extern "C" int gki_rmw_loop(const void* idx, long long n_q, int n_c,
                            long long cols, void* counts, void* scratch,
                            int n_grid, void* stream) {
  const int words = n_c > kRmwThreads ? n_c : kRmwThreads;
  void* args[] = {(void*)&idx, (void*)&n_q,    (void*)&n_c,
                  (void*)&cols, (void*)&counts, (void*)&scratch};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(rmw_loop_kernel), dim3(n_grid),
      dim3(kRmwThreads), args, words * sizeof(int32_t),
      static_cast<cudaStream_t>(stream)));
}

// qlo, qhi, node, cnt: n_q int32 each; tlo, thi, tnode: n_t int32 each.
extern "C" int gki_bcast_cmp(const void* qlo, const void* qhi, long long n_q,
                             const void* tlo, const void* thi,
                             const void* tnode, int n_t, void* node,
                             void* cnt, void* stream) {
  if (n_q <= 0) return 0;
  const size_t shared = 3 * static_cast<size_t>(n_t) * sizeof(int32_t);
  const long long per_block = static_cast<long long>(kThreads) * kCmpQ;
  bcast_cmp_kernel<<<static_cast<unsigned int>((n_q + per_block - 1) /
                                               per_block),
                     kThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(qlo), static_cast<const int32_t*>(qhi),
      n_q, static_cast<const int32_t*>(tlo),
      static_cast<const int32_t*>(thi), static_cast<const int32_t*>(tnode),
      n_t, static_cast<int32_t*>(node), static_cast<int32_t*>(cnt));
  return static_cast<int>(cudaGetLastError());
}
