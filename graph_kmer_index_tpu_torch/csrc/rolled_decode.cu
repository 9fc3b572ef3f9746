// rolled_decode: a chunk of query hashes from its rolled form back to
// int64 on the card, after the form's copy to the card and before K2.
//
// Replaces no TPU kernel: the JAX package sends its queries whole. It is
// the card's half of the staging ring's rolled upload (ops/rolled.py); the
// host's half, and the form, are in csrc/host/rolled.cpp. The form sends a
// digit of 2 bits a query, and the whole hash and run direction of each
// query that does not roll from the one before it (an anchor), so the
// link and the host carry about a 21st of the raw bytes for read k-mers.
//
// Query i of a run that starts at anchor a, t = i - a steps on, with w
// digits a hash and the window of the last w digits d[i-w+1..i]:
//   forward:  h = (anchor >> 2t) | the top t digits of the window, in
//             place; for t >= w the window alone (d[i] highest)
//   reverse:  h = ((anchor << 2t) & M) | the last t digits, d[i] lowest;
//             for t >= w the window alone, its digits in reverse order
// A run's anchor and every query of it lie below 4^w (the encoder rolls
// nothing else), so a query w or more steps on depends on its window
// alone.
//
// A block takes a tile of kTile queries, kPerThread a thread, one in
// kThreads apart so that a warp writes 256 neighbouring bytes a step. It
// brings the tile's digit words (and the word before) into shared memory,
// and the keys of its anchors, from the one whose run the tile starts in:
// the form's tile table says where they begin and end. Each query finds
// its anchor by a binary search of those keys (a few steps: read k-mers
// have one anchor in 120) and reads the anchor's value only where it is
// fewer than w steps on.
//
// Bound on this card: bytes. The form read once (a quarter of a byte a
// query, 16 bytes an anchor) and 8 bytes a query written, over 3.35 TB/s:
// 0.52 ms for the 209 M queries of a 150 bp read file.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kTile = kThreads * kPerThread;  // csrc/host/rolled.cpp kTile
constexpr int kTileWords = kTile / 32;
static_assert(kTile == 2048, "the tile of the form");

// An anchor as the form holds it: csrc/host/rolled.cpp Anchor.
struct Anchor {
  uint64_t value;
  int32_t key;  // index << 1 | reverse
  int32_t zero;
};
static_assert(sizeof(Anchor) == 16, "an anchor record is 16 bytes");

__global__ void __launch_bounds__(kThreads)
rolled_decode_kernel(const uint64_t* __restrict__ words,
                     const int32_t* __restrict__ tiles,
                     const Anchor* __restrict__ anchors, long long n, int w,
                     uint64_t* __restrict__ out) {
  // the word before the tile, its kTileWords words, and a zero word that
  // a window ending on the tile's last query may touch
  __shared__ uint64_t s_words[kTileWords + 2];
  __shared__ int32_t s_keys[kTile + 1];
  const long long tile0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long n_words = (n + 31) / 32;
  for (int j = threadIdx.x; j < kTileWords + 2; j += kThreads) {
    const long long g = tile0 / 32 - 1 + j;
    s_words[j] = (g >= 0 && g < n_words) ? words[g] : 0;
  }
  // the anchor whose run the tile starts in, and the tile's own anchors
  const int first = tiles[blockIdx.x];
  const int lo = first > 0 ? first - 1 : 0;
  const int count = tiles[blockIdx.x + 1] - lo;
  for (int j = threadIdx.x; j < count; j += kThreads)
    s_keys[j] = anchors[lo + j].key;
  __syncthreads();

  const int width = 2 * w;
  const uint64_t mask = w == 32 ? ~0ULL : (1ULL << width) - 1;
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int local = r * kThreads + threadIdx.x;
    const long long i = tile0 + local;
    if (i >= n) break;
    // the last anchor at or before i
    int a = 0, b = count;
    while (b - a > 1) {
      const int mid = (a + b) >> 1;
      if ((s_keys[mid] >> 1) <= i) a = mid;
      else b = mid;
    }
    const int key = s_keys[a];
    const long long t = i - (key >> 1);
    uint64_t h;
    if (t == 0) {
      h = anchors[lo + a].value;
    } else {
      // bits [end - width, end) of the digits from s_words[0]'s bit 0
      const int end = 2 * (local + 1) + 64;
      const int start = end - width;
      const int sh = start & 63;
      const uint64_t first_word = s_words[start >> 6];
      const uint64_t window =
          (sh ? (first_word >> sh) | (s_words[(start >> 6) + 1] << (64 - sh))
              : first_word) & mask;
      if (!(key & 1)) {
        h = window;
        if (t < w) {
          const int kept = 2 * static_cast<int>(t);
          h = (h & (mask << (width - kept))) |
              (anchors[lo + a].value >> kept);
        }
      } else {
        // the window's digits in reverse order: reverse the bits, then
        // swap the two bits of each digit back
        uint64_t rev = __brevll(window);
        rev = ((rev >> 1) & 0x5555555555555555ULL) |
              ((rev & 0x5555555555555555ULL) << 1);
        h = rev >> (64 - width);
        if (t < w) {
          const int kept = 2 * static_cast<int>(t);
          h = (h & ((1ULL << kept) - 1)) |
              ((anchors[lo + a].value << kept) & mask);
        }
      }
    }
    out[i] = h;
  }
}

}  // namespace

// The n queries of one form at rolled (device memory, 8-byte aligned; the
// tile table and the anchors at their byte offsets) into out (n int64).
extern "C" int gki_rolled_decode(const void* rolled, long long n, int w,
                                 long long tiles_off, long long anchors_off,
                                 void* out, void* stream) {
  if (n <= 0) return 0;
  if (w < 1 || w > 32) return static_cast<int>(cudaErrorInvalidValue);
  const char* base = static_cast<const char*>(rolled);
  const unsigned int blocks =
      static_cast<unsigned int>((n + kTile - 1) / kTile);
  rolled_decode_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint64_t*>(base),
      reinterpret_cast<const int32_t*>(base + tiles_off),
      reinterpret_cast<const Anchor*>(base + anchors_off), n, w,
      static_cast<uint64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
