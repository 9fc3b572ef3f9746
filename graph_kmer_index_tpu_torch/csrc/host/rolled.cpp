// The rolled form of a chunk of query hashes: the host half of the
// staging ring's rolled upload (ops/rolled.py, ops/host_buffers.py; the
// card's half is csrc/rolled_decode.cu).
//
// The k-mers of a read strand, as hash_fasta_file and kmer_mapper lay
// them out, each roll from the one before by one base. With w digits of
// 2 bits (the k of the roll) and M = 4^w - 1:
//   forward:  h[i] = (h[i-1] >> 2) | b << (2w - 2)
//   reverse:  h[i] = ((h[i-1] << 2) & M) | b
// So a chunk goes to the card as one 2-bit digit b a query, plus the whole
// value of each query that does not roll from the one before it (an
// anchor), with the direction of the run that it starts. A query rolls
// only where it and the one before it are below 4^w and the roll holds
// exactly, so every 64-bit pattern comes back bit for bit, whatever the
// input; a width that does not fit costs anchors, never an answer.
//
// The form, in one buffer, each part 8-byte aligned:
//   digits   uint64[ceil(n / 32)]: query i's digit in bits 2 (i % 32) of
//            word i / 32 (0 for an anchor)
//   tiles    int32[ceil(n / kTile) + 1]: the number of anchors before each
//            tile of kTile queries, then all of them
//   anchors  16 bytes each, by index: the hash (uint64), the key
//            (int32: index << 1 | reverse) and 4 zero bytes
//
// gki_rolled_encode probes the chunk's first queries for the width (half
// the bit length of the largest, rounded up) and for the share of them
// that would be anchors; above one in kProbeShare it leaves the chunk to
// the caller's plain copy. Otherwise the chunk is cut into slices of
// kSlice queries, one a task, scanned by a pool of threads kept for the
// life of the process: each slice starts with an anchor, its digits go
// straight into the buffer, its anchors into the task's scratch. A task
// that ends its scan marks itself done, and whichever task holds the
// placing lock then moves every done slice's anchors and tile counts to
// their place in slice order, while the other threads go on scanning. The
// scan reads each hash once and tests the 32 queries of a digit word a step
// with AVX-512 (-march=native). On the 8 threads of an H100 80GB HBM3's
// host it runs at about 0.57-0.74 of the rate of a pure threaded read,
// 1.4-1.7 times that of a threaded copy. One request's 209 M queries (25
// calls) took it 33 ms in the median; with threads made for each call, as
// gki.cpp's callers make them, 70 ms; with the anchors placed in a second
// pass of the pool, 41 ms. Without AVX-512 every chunk is left to the
// plain copy: a scan a query at a time ran slower than the copy it would
// replace.

#include <cstdint>

#if defined(__AVX512F__) && defined(__BMI2__)
#include <immintrin.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstring>
#include <functional>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr int64_t kTile = 2048;      // queries a tile: rolled_decode.cu
constexpr int64_t kProbe = 4096;     // queries the probe reads
constexpr int64_t kProbeShare = 16;  // the probe's most anchors: 1 in 16
// queries a task scans: on an H100 80GB HBM3's host tasks of 2^15-2^17
// queries scan at 0.71-0.74 of a pure read's rate, of 2^14 at 0.66
constexpr int64_t kSlice = 64 * kTile;
// queries between checks of the anchors' room
constexpr int64_t kCheckEvery = kSlice / 2;
// queries the scan prefetches ahead: without, it runs at 0.46 of a pure
// read's rate on that host, with, 0.57-0.59 (2^10 and 2^11 read no better)
constexpr int64_t kAhead = 256;
constexpr int64_t kMaxQueries = int64_t(1) << 30;  // an index in a key

// A pool of worker threads kept for the life of the process. run() hands
// tasks 0..n-1 to the workers and the caller, and returns when all are
// done. A task is claimed from a ticket that holds the job's generation and
// the next task, so a worker that wakes late for one job never takes a task
// of the next; tasks are small, so one that wakes late holds up little.
class Pool {
 public:
  void run(int n_tasks, int n_threads, const std::function<void(int)>& fn) {
    std::lock_guard<std::mutex> one_job(run_mu_);
    while ((int)workers_.size() < n_threads - 1) {
      const int id = (int)workers_.size();
      workers_.emplace_back([this, id] { loop(id); });
      workers_.back().detach();
    }
    helpers_.store(n_threads - 1, std::memory_order_relaxed);
    job_.store(&fn, std::memory_order_relaxed);
    n_tasks_.store(n_tasks, std::memory_order_relaxed);
    finished_.store(0, std::memory_order_relaxed);
    const uint64_t gen = (ticket_.load() >> 32) + 1;
    {
      std::lock_guard<std::mutex> lk(mu_);
      ticket_.store(gen << 32);
    }
    wake_.notify_all();
    work(gen);
    std::unique_lock<std::mutex> lk(mu_);
    done_.wait(lk, [&] { return finished_.load() == n_tasks; });
  }

 private:
  // claim and run tasks of job gen until none is left
  void work(uint64_t gen) {
    for (;;) {
      uint64_t t = ticket_.load();
      if ((t >> 32) != gen) return;
      const std::function<void(int)>* fn =
          job_.load(std::memory_order_relaxed);
      const int n = n_tasks_.load(std::memory_order_relaxed);
      const int task = (int)(t & 0xFFFFFFFFu);
      if (task >= n) return;
      if (!ticket_.compare_exchange_weak(t, t + 1)) continue;
      (*fn)(task);
      if (finished_.fetch_add(1) + 1 == n) {
        std::lock_guard<std::mutex> lk(mu_);
        done_.notify_all();
      }
    }
  }

  // worker id takes part in the jobs of more than id + 1 threads
  void loop(int id) {
    uint64_t seen = 0;
    for (;;) {
      {
        std::unique_lock<std::mutex> lk(mu_);
        wake_.wait(lk, [&] { return (ticket_.load() >> 32) != seen; });
        seen = ticket_.load() >> 32;
      }
      if (id < helpers_.load(std::memory_order_relaxed)) work(seen);
    }
  }

  std::mutex run_mu_, mu_;
  std::condition_variable wake_, done_;
  std::vector<std::thread> workers_;
  std::atomic<const std::function<void(int)>*> job_{nullptr};
  std::atomic<int> n_tasks_{0}, finished_{0}, helpers_{0};
  std::atomic<uint64_t> ticket_{0};  // generation << 32 | next task
};

Pool& pool() {
  // never destroyed: its detached threads wait on it until the process
  // ends
  static std::mutex mu;
  static Pool* p = nullptr;
  static pid_t owner = 0;
  std::lock_guard<std::mutex> lk(mu);
  if (p == nullptr || owner != getpid()) {
    p = new Pool();
    owner = getpid();
  }
  return *p;
}

struct Roll {
  int w;
  uint64_t low;  // 4^(w-1) - 1: the bits a roll keeps
  int top;       // 2w - 2: where a forward roll puts its digit
  int width;     // 2w: a rolling hash is below 2^width

  explicit Roll(int w_)
      : w(w_), low((w_ == 32 ? ~0ULL : (1ULL << (2 * w_)) - 1) >> 2),
        top(2 * w_ - 2), width(2 * w_) {}
  bool fits(uint64_t x) const { return width == 64 || (x >> width) == 0; }
  bool forward(uint64_t prev, uint64_t cur) const {
    return fits(prev) && fits(cur) && (cur & low) == (prev >> 2);
  }
  bool reverse(uint64_t prev, uint64_t cur) const {
    return fits(prev) && fits(cur) && (cur >> 2) == (prev & low);
  }
};

// An anchor as the form holds it.
struct Anchor {
  uint64_t value;
  int32_t key;  // index << 1 | reverse
  int32_t zero;
};
static_assert(sizeof(Anchor) == 16, "an anchor record is 16 bytes");

struct alignas(64) Scratch {
  std::vector<Anchor> anchors;
  int64_t lo = 0, hi = 0;
};

// scratch of each task, reused from call to call
std::vector<Scratch>& scratch(int n) {
  static std::vector<Scratch> s;
  if ((int)s.size() < n) s.resize(n);
  return s;
}

// The 32 digits of a 64-bit word in reverse order.
uint64_t digits_reversed(uint64_t x) {
  x = __builtin_bswap64(x);
  x = ((x >> 4) & 0x0F0F0F0F0F0F0F0FULL) |
      ((x & 0x0F0F0F0F0F0F0F0FULL) << 4);
  return ((x >> 2) & 0x3333333333333333ULL) |
         ((x & 0x3333333333333333ULL) << 2);
}

// The digits of a word of 32 queries q[0..31] that all roll one way, for
// w >= 16: forward, the top w of them are the last query's hash and the
// rest the top digits of the hash w before it; reverse, the same with each
// hash's digits in reverse order.
uint64_t rolled_word(const uint64_t* q, const Roll& r, bool reverse) {
  const int w = r.w;
  if (!reverse)
    return w == 32 ? q[31]
                   : (q[31] << (64 - 2 * w)) | (q[31 - w] >> (4 * w - 64));
  return w == 32 ? digits_reversed(q[31])
                 : digits_reversed(q[31]) |
                       (digits_reversed(q[31 - w]) >> (2 * w));
}

// One word's 32 queries (c) and the queries before each (p), 8 a vector.
struct Word {
  __m512i c[4], p[4];
};

// Bit j: query j of the word rolls that way from the one before it, where
// both fit (a query and the one before it that fit need no test of it).
inline uint32_t roll_mask(const Word& v, bool reverse, __m512i low) {
  uint32_t m = 0;
  for (int k = 0; k < 4; ++k) {
    const __m512i x =
        reverse ? _mm512_xor_si512(_mm512_srli_epi64(v.c[k], 2), v.p[k])
                : _mm512_xor_si512(v.c[k], _mm512_srli_epi64(v.p[k], 2));
    m |= (uint32_t)_mm512_testn_epi64_mask(x, low) << (8 * k);
  }
  return m;
}

// Bit j: query j of the word fits.
inline uint32_t fit_mask(const Word& v, __m512i high) {
  uint32_t m = 0;
  for (int k = 0; k < 4; ++k)
    m |= (uint32_t)_mm512_testn_epi64_mask(v.c[k], high) << (8 * k);
  return m;
}

// Each query's digit of the given roll at bits 2j of the word: rotated from
// bit top (forward) or bit 0 (reverse) to its place.
inline uint64_t digit_word(const Word& v, bool reverse, const __m512i* place,
                           const __m512i* turn_f, const __m512i* turn_r) {
  __m512i acc = _mm512_setzero_si512();
  for (int k = 0; k < 4; ++k)
    acc = _mm512_ternarylogic_epi64(
        acc, _mm512_rolv_epi64(v.c[k], reverse ? turn_r[k] : turn_f[k]),
        place[k], 0xF8);  // acc | (rotated & place)
  return (uint64_t)_mm512_reduce_or_epi64(acc);
}

// Scan queries [lo, hi) of src (lo a multiple of 32): digits into words
// (which hold [lo, hi) from bit 0 of words[0]), anchors into sc. A step
// takes the 32 queries of one digit word and the mask of those that roll
// in the run's direction from the query before. Where all do, the word's
// digits are bits of its own hashes; else they are gathered query by query,
// each query that does not roll so is an anchor, and the word is walked run
// by run on the masks. A new run keeps the direction of the one before
// where the next query rolls that way (read strands follow strands of their
// own half), else takes the other where that holds. Stops early, leaving
// the form unfinished, once the chunk's anchors pass cap.
void scan_slice(const uint64_t* src, int64_t lo, int64_t hi, const Roll& r,
                uint64_t* words, Scratch& sc, std::atomic<int64_t>& total,
                int64_t cap) {
  sc.anchors.clear();
  bool rev = false;
  bool prev_fits = true;  // the query before the word fits
  size_t reported = 0;
  const __m512i low = _mm512_set1_epi64((long long)r.low);
  const __m512i high =
      _mm512_set1_epi64(r.width == 64 ? 0LL : (long long)(~0ULL << r.width));
  const __m512i low_high = _mm512_or_si512(low, high);
  const __m512i keep_r = _mm512_set1_epi64(
      r.width == 64 ? -1LL : (long long)~(3ULL << r.width));
  const __m512i above_digit = _mm512_set1_epi64((long long)~3ULL);
  // lane j of vector k: its digit goes to bits 2 (8k + j) of the word
  __m512i place[4], turn_f[4], turn_r[4];
  for (int k = 0; k < 4; ++k) {
    alignas(64) uint64_t pl[8], tf[8], tr[8];
    for (int j = 0; j < 8; ++j) {
      const int at = 2 * (8 * k + j);
      pl[j] = 3ULL << at;
      tf[j] = (uint64_t)((at - r.top + 64) % 64);
      tr[j] = (uint64_t)at;
    }
    place[k] = _mm512_load_si512(pl);
    turn_f[k] = _mm512_load_si512(tf);
    turn_r[k] = _mm512_load_si512(tr);
  }
  for (int64_t w0 = lo; w0 < hi; w0 += 32) {
    const uint64_t* q = src + w0;
    const int lanes = (int)std::min<int64_t>(32, hi - w0);
    // the slice's first query is an anchor; lanes past hi are none
    const uint32_t valid =
        (lanes == 32 ? ~0u : (1u << lanes) - 1) & (w0 == lo ? ~1u : ~0u);
    Word v;
    __m512i any = _mm512_setzero_si512();
    for (int k = 0; k < 4; ++k)
      _mm_prefetch((const char*)(q + kAhead + 8 * k), _MM_HINT_T0);
    if (lanes == 32 && w0 > lo && prev_fits) {
      // the common word: all 32 roll in the run's direction, tested lane
      // by lane across the four vectors. A query that rolls from one that
      // fits fits too where its bits from 2w up are tested with the roll:
      // forward they are those of c ^ (p >> 2); reverse those of c, kept
      // by the select below, but for bits 2w and 2w + 1, where p << 2
      // holds p's top digit
      __mmask8 all = 0xFF;
      for (int k = 0; k < 4; ++k) {
        v.c[k] = _mm512_loadu_si512((const void*)(q + 8 * k));
        v.p[k] = _mm512_loadu_si512((const void*)(q + 8 * k - 1));
        all = rev ? _mm512_mask_testn_epi64_mask(
                        all,
                        _mm512_ternarylogic_epi64(  // keep ? c ^ (p << 2) : c
                            v.c[k], _mm512_slli_epi64(v.p[k], 2), keep_r,
                            0x78),
                        above_digit)
                  : _mm512_mask_testn_epi64_mask(
                        all,
                        _mm512_xor_si512(v.c[k],
                                         _mm512_srli_epi64(v.p[k], 2)),
                        low_high);
      }
      if (all == 0xFF) {
        words[(w0 - lo) / 32] =
            r.w >= 16 ? rolled_word(q, r, rev)
                      : digit_word(v, rev, place, turn_f, turn_r);
        if (((w0 + 32) & (kCheckEvery - 1)) == 0 || w0 + 32 >= hi) {
          const size_t now = sc.anchors.size();
          const int64_t sum = total.fetch_add((int64_t)(now - reported)) +
                              (int64_t)(now - reported);
          reported = now;
          if (sum > cap) return;
        }
        continue;
      }
      for (int k = 0; k < 4; ++k) any = _mm512_or_si512(any, v.c[k]);
    } else {
      for (int k = 0; k < 4; ++k) {
        const int in = std::max(0, std::min(8, lanes - 8 * k));
        const __mmask8 m = (__mmask8)((1u << in) - 1);
        v.c[k] = _mm512_maskz_loadu_epi64(m, q + 8 * k);
        v.p[k] = _mm512_maskz_loadu_epi64(
            (__mmask8)(k == 0 && w0 == lo ? m & 0xFE : m), q + 8 * k - 1);
        any = _mm512_or_si512(any, v.c[k]);
      }
    }
    const bool all_fit =
        prev_fits && _mm512_test_epi64_mask(any, high) == 0;
    const uint32_t fits =
        all_fit ? ~0u : [&] {
          const uint32_t f = fit_mask(v, high);
          return f & ((f << 1) | (uint32_t)prev_fits);
        }();
    auto masks = [&](bool reverse) {
      return roll_mask(v, reverse, low) & fits & valid;
    };
    auto digits = [&](bool reverse) {
      return digit_word(v, reverse, place, turn_f, turn_r);
    };
    uint32_t m_cur = masks(rev);
    uint64_t word;
    if (m_cur == ~0u && r.w >= 16) {
      word = rolled_word(q, r, rev);  // the common word: one run on
    } else {
      uint64_t d_cur = digits(rev), d_other = 0;
      uint32_t m_other = 0;
      bool other = false;  // m_other and d_other made
      word = 0;
      int j = 0;
      while (j < lanes) {
        const int run =
            std::min(__builtin_ctzll(~(uint64_t)(m_cur >> j)), lanes - j);
        if (run) {
          word |= d_cur & ((run == 32 ? ~0ULL : (1ULL << (2 * run)) - 1)
                           << (2 * j));
          j += run;
          if (j == lanes) break;
        }
        // an anchor, and the direction of its run
        const int64_t a = w0 + j;
        bool keep, turn;
        if (j + 1 < lanes) {
          keep = (m_cur >> (j + 1)) & 1;
          if (!keep && !other) {
            m_other = masks(!rev);
            d_other = digits(!rev);
            other = true;
          }
          turn = !keep && ((m_other >> (j + 1)) & 1);
        } else {
          keep = a + 1 < hi && (rev ? r.reverse(src[a], src[a + 1])
                                    : r.forward(src[a], src[a + 1]));
          turn = !keep && a + 1 < hi &&
                 (rev ? r.forward(src[a], src[a + 1])
                      : r.reverse(src[a], src[a + 1]));
        }
        if (turn) {
          rev = !rev;
          std::swap(m_cur, m_other);
          std::swap(d_cur, d_other);
        }
        sc.anchors.push_back({src[a], (int32_t)(a << 1) | (int32_t)rev, 0});
        ++j;
      }
    }
    words[(w0 - lo) / 32] = word;
    prev_fits = r.fits(q[lanes - 1]);
    if (((w0 + 32) & (kCheckEvery - 1)) == 0 || w0 + 32 >= hi) {
      const size_t now = sc.anchors.size();
      const int64_t sum = total.fetch_add((int64_t)(now - reported)) +
                          (int64_t)(now - reported);
      reported = now;
      if (sum > cap) return;
    }
  }
}

// Whether the probe's m queries would carry few enough anchors at this
// width; stops at the first anchor too many, so a chunk in no read order
// costs a few dozen of its queries.
bool probe_rolls(const uint64_t* src, int64_t m, const Roll& r) {
  const int64_t most = m / kProbeShare;
  int64_t anchors = 1;
  for (int64_t i = 1; i < m && anchors <= most; ++i)
    anchors += !(r.forward(src[i - 1], src[i]) ||
                 r.reverse(src[i - 1], src[i]));
  return anchors <= most;
}

int probe_width(const uint64_t* src, int64_t m) {
  uint64_t all = 0;
  for (int64_t i = 0; i < m; ++i) all |= src[i];
  const int bits = all ? 64 - __builtin_clzll(all) : 0;
  return std::max(1, (bits + 1) / 2);
}

int64_t align8(int64_t x) { return (x + 7) & ~int64_t(7); }

}  // namespace

extern "C" {

// Encode n int64 query hashes (src, contiguous) into out's capacity bytes
// in the rolled form above, on n_threads threads. Returns the bytes of the
// form, or -1 where the probe leaves the chunk to a plain copy, or -2
// where its anchors do not fit in capacity. info: [w, n_anchors, tiles
// offset, anchors offset] (bytes from out).
int64_t gki_rolled_encode(const uint64_t* src, int64_t n, uint8_t* out,
                          int64_t capacity, int32_t n_threads,
                          int64_t* info) {
  // one call at a time: the tasks' scratch is shared
  static std::mutex one_call;
  static std::unique_ptr<std::atomic<int>[]> done;
  static int done_size = 0;
  std::lock_guard<std::mutex> lk(one_call);
  if (n <= 0 || n > kMaxQueries) return -1;
  const int64_t m = std::min(n, kProbe);
  const Roll r(probe_width(src, m));
  if (!probe_rolls(src, m, r)) return -1;
  const int64_t n_words = (n + 31) / 32;
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  const int64_t tiles_off = n_words * 8;
  const int64_t anchors_off = tiles_off + align8((n_tiles + 1) * 4);
  if (anchors_off > capacity) return -2;
  const int64_t cap = (capacity - anchors_off) / (int64_t)sizeof(Anchor);
  const int n_tasks = (int)((n + kSlice - 1) / kSlice);
  std::vector<Scratch>& sc = scratch(n_tasks);
  if (done_size < n_tasks) {
    done.reset(new std::atomic<int>[n_tasks]);
    done_size = n_tasks;
  }
  for (int t = 0; t < n_tasks; ++t) done[t].store(0);
  uint64_t* words = reinterpret_cast<uint64_t*>(out);
  int32_t* tiles = reinterpret_cast<int32_t*>(out + tiles_off);
  Anchor* anchors = reinterpret_cast<Anchor*>(out + anchors_off);
  std::atomic<int64_t> total{0};
  std::atomic<bool> placing{false};
  std::atomic<int> frontier{0};  // the next slice to place
  int64_t placed = 0;            // anchors placed, under placing
  bool overflow = false;         // under placing
  // Place every done slice from the frontier on, unless another task is
  // at it; after letting go, look again, since a slice marked done while
  // the lock was held may have been missed by its holder.
  auto place_done = [&] {
    for (;;) {
      bool idle = false;
      if (!placing.compare_exchange_strong(idle, true)) return;
      int f;
      while ((f = frontier.load()) < n_tasks && done[f].load()) {
        const Scratch& s = sc[f];
        const int64_t c = (int64_t)s.anchors.size();
        if (placed + c > cap) overflow = true;
        if (!overflow) {
          std::memcpy(anchors + placed, s.anchors.data(),
                      c * sizeof(Anchor));
          // the anchors before each of the slice's tiles
          int64_t j = 0;
          for (int64_t b = s.lo / kTile; b * kTile < s.hi; ++b) {
            while (j < c && (s.anchors[j].key >> 1) < b * kTile) ++j;
            tiles[b] = (int32_t)(placed + j);
          }
        }
        placed += c;
        frontier.store(f + 1);
      }
      placing.store(false);
      f = frontier.load();
      if (f >= n_tasks || !done[f].load()) return;
    }
  };
  pool().run(n_tasks, std::max(1, n_threads), [&](int t) {
    const int64_t lo = t * kSlice, hi = std::min(n, lo + kSlice);
    sc[t].lo = lo;
    sc[t].hi = hi;
    scan_slice(src, lo, hi, r, words + lo / 32, sc[t], total, cap);
    done[t].store(1);
    place_done();
  });
  if (overflow || total.load() > cap) return -2;
  const int64_t n_anchors = placed;
  tiles[n_tiles] = (int32_t)n_anchors;
  // the alignment after the tiles: zero, so that the form is the same
  // bytes on any number of threads
  std::memset(tiles + n_tiles + 1, 0,
              anchors_off - tiles_off - (n_tiles + 1) * 4);
  info[0] = r.w;
  info[1] = n_anchors;
  info[2] = tiles_off;
  info[3] = anchors_off;
  return anchors_off + n_anchors * (int64_t)sizeof(Anchor);
}

}  // extern "C"

#else  // without AVX-512 every chunk takes the ring's plain copy

extern "C" int64_t gki_rolled_encode(const uint64_t*, int64_t, uint8_t*,
                                     int64_t, int32_t, int64_t*) {
  return -1;
}

#endif
