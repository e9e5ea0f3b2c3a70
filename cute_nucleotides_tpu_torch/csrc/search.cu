// Packed-domain exact search kernels for Hopper (sm_90a), plain C interface.
//
// Both kernels write one output u32 per stream word: bit s of out[w] flags a
// query match that starts in word w.  Starts at or past n_starts (the
// caller's length - m + 1) are cleared, and stream words past the end read as
// 0, as the reference pads them (cute_nucleotides_tpu/ops/search.py).
//
// 2-bit (replaces search.py:match_bits_rows): words are u32 of 16 nt, 2 bits
// each, LSB-first.  A start at nt 16w + s matches iff for every query word k,
// ((funnel(x[w+k], x[w+k+1], 2s) ^ q[k]) & care[k]) == 0, where care has 0b11
// in each concrete 2-bit field and 0b00 at an N wildcard.
//
// Base-5 (replaces pallas_kernels.py:match_b5_bits_rows): words are u64 of 9
// triplets t = a + 5b + 25c (7 bits each, bit 63 unused).  Each triplet is
// split into base-8 digit slots a | b << 3 | c << 6 with the exact
// multiply-shifts t / 5 == (t * 205) >> 10 and t / 25 == (t * 41) >> 10, so a
// corrupt triplet (125..127) keeps a high digit of 5 and never equals a
// literal N (4).  A start at nt 27w + 3j + p (triplet u = 9w + j, phase p)
// matches iff every tap i of phase p has ((t8[u + i] ^ q8[i]) & care8[i]) ==
// 0; bit 3j + p of out[w] holds it (27 bits used).
//
// Neither kernel bakes the query in: it arrives as a small device table that
// every thread of a warp reads at the same address (one broadcast load), so
// one build of this file serves every query.  Multi-word queries fold their
// anchor taps first and the rest only where an anchor matched (a per-thread
// early exit; anchors are chosen on the host, as the reference chooses them).
//
// Bound: the memory traffic is small (4 B in, 4 B out per 16 nt; 8 B in, 4 B
// out per 27 nt); the integer pipes bound both kernels at short queries (16
// funnel-compare-select steps per 2-bit word and query word, 9 shared loads
// and compares per base-5 word and tap).
//
// Every entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// --- 2-bit -------------------------------------------------------------------

constexpr int kThreads2 = 256;  // output words (threads) per block
constexpr int kLook2 = 256;     // lookahead words a block stages past its own

__device__ __forceinline__ uint32_t word_at(const uint32_t* __restrict__ x, int64_t n_words, int64_t i) {
  return i < n_words ? __ldg(x + i) : 0u;
}

// The 16-start match mask of query word k against stream words (a, b) =
// (x[w+k], x[w+k+1]): bit s set iff the 32-bit window at nt 16(w+k) + s
// agrees with q on every cared-for field.
__device__ __forceinline__ uint32_t fold_2bit(uint32_t a, uint32_t b, uint32_t q, uint32_t care) {
  uint32_t m = 0;
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    const uint32_t win = __funnelshift_r(a, b, 2 * s);
    m |= (((win ^ q) & care) == 0u ? 1u : 0u) << s;
  }
  return m;
}

// Block b covers output words 256b..256b+255.  It stages its words and up to
// kLook2 following ones in shared memory (coalesced); a thread whose query
// reaches past the tile reads the rest through __ldg.  table = q[wq] then
// care[wq]; anchor is the query word with the most cared-for bits.
__global__ void __launch_bounds__(kThreads2)
match_2bit_kernel(const uint32_t* __restrict__ x, int64_t n_words, const uint32_t* __restrict__ table,
                  int wq, int anchor, int64_t n_starts, uint32_t* __restrict__ out) {
  __shared__ uint32_t tile[kThreads2 + kLook2];
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kThreads2;
  const int staged = kThreads2 + min(wq + 1, kLook2);
  for (int i = threadIdx.x; i < staged; i += kThreads2) tile[i] = word_at(x, n_words, w0 + i);
  __syncthreads();
  const int t = threadIdx.x;
  const int64_t w = w0 + t;
  if (w >= n_words) return;
  const int in_tile = staged - t;  // words w .. w + in_tile - 1 lie in the tile
  const uint32_t* care = table + wq;
  int k = anchor;
  uint32_t bits = 0xFFFFu;
  for (int step = 0; step < wq && bits != 0u; ++step) {
    const uint32_t a = k < in_tile ? tile[t + k] : word_at(x, n_words, w + k);
    const uint32_t b = k + 1 < in_tile ? tile[t + k + 1] : word_at(x, n_words, w + k + 1);
    bits &= fold_2bit(a, b, __ldg(table + k), __ldg(care + k));
    // the anchor first, then every other word in order
    k = step == 0 ? (anchor == 0 ? 1 : 0) : k + 1;
    if (k == anchor) ++k;
  }
  const int64_t lim = n_starts - 16 * w;
  if (lim < 16) bits &= lim <= 0 ? 0u : (1u << lim) - 1u;
  out[w] = bits;
}

// --- base-5 ------------------------------------------------------------------

constexpr int kWords5 = 128;     // u64 words (threads) per block
constexpr int kMaxLook5 = 40;    // lookahead words: a 1024-nt query (342 taps) needs 39
constexpr int kTableHead = 6;    // table = ntaps[3], nanchor[3], then taps[3][max_taps]

// A tap packs its offset i (triplets past the start), care8 and q8.
__device__ __forceinline__ uint32_t tap_offset(uint32_t tap) { return tap >> 18; }
__device__ __forceinline__ uint32_t tap_care(uint32_t tap) { return (tap >> 9) & 0x1FFu; }
__device__ __forceinline__ uint32_t tap_q(uint32_t tap) { return tap & 0x1FFu; }

__device__ __forceinline__ uint32_t b8_digits(uint32_t t) {
  const uint32_t v5 = (t * 205u) >> 10;
  const uint32_t v25 = (t * 41u) >> 10;
  return (t - 5u * v5) | ((v5 - 5u * v25) << 3) | (v25 << 6);
}

// The 9-bit mask of slots j (start triplet 9w + j) that agree with taps
// [from, to) of one phase; t8 points at the thread's first triplet.
__device__ __forceinline__ uint32_t fold_b5(const uint16_t* t8, const uint32_t* __restrict__ taps,
                                            int from, int to) {
  uint32_t hit = 0x1FFu;
  for (int idx = from; idx < to && hit != 0u; ++idx) {
    const uint32_t tap = __ldg(taps + idx);
    const uint16_t* s = t8 + tap_offset(tap);
    const uint32_t q = tap_q(tap), c = tap_care(tap);
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      if ((s[j] ^ q) & c) hit &= ~(1u << j);
    }
  }
  return hit;
}

// slot mask h of phase p -> bits 3j + p
__device__ __forceinline__ uint32_t spread_phase(uint32_t h, int p) {
  uint32_t out = 0;
#pragma unroll
  for (int j = 0; j < 9; ++j) out |= ((h >> j) & 1u) << (3 * j + p);
  return out;
}

// Block b covers words 128b..128b+127: it stages them and `look` following
// words as base-8 digit triplets in shared memory (9 per word, u16 each);
// thread w then folds the anchor taps of each phase over its 9 start slots,
// and the other taps only if an anchor matched.
__global__ void __launch_bounds__(kWords5)
match_b5_kernel(const uint64_t* __restrict__ x, int64_t n_words, const uint32_t* __restrict__ table,
                int max_taps, int look, int64_t n_starts, uint32_t* __restrict__ out) {
  __shared__ uint16_t t8[(kWords5 + kMaxLook5) * 9];
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kWords5;
  for (int i = threadIdx.x; i < kWords5 + look; i += kWords5) {
    const uint64_t v = w0 + i < n_words ? x[w0 + i] : 0ull;
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      t8[9 * i + j] = static_cast<uint16_t>(b8_digits(static_cast<uint32_t>(v >> (7 * j)) & 0x7Fu));
    }
  }
  __syncthreads();
  const int64_t w = w0 + threadIdx.x;
  if (w >= n_words) return;
  const uint16_t* mine = t8 + 9 * threadIdx.x;
  const uint32_t* taps = table + kTableHead;
  uint32_t h[3];
  uint32_t any = 0;
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    h[p] = fold_b5(mine, taps + p * max_taps, 0, static_cast<int>(__ldg(table + 3 + p)));
    any |= h[p];
  }
  uint32_t bits = 0;
  if (any != 0u) {
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      if (h[p] != 0u) {
        h[p] &= fold_b5(mine, taps + p * max_taps, static_cast<int>(__ldg(table + 3 + p)),
                        static_cast<int>(__ldg(table + p)));
      }
      bits |= spread_phase(h[p], p);
    }
  }
  const int64_t lim = n_starts - 27 * w;
  if (lim < 27) bits &= lim <= 0 ? 0u : (1u << lim) - 1u;
  out[w] = bits;
}

}  // namespace

extern "C" {

// Packed 2-bit stream u32[n_words] -> match bits u32[n_words].  table (on the
// device) holds q[wq] then care[wq]; anchor < wq; words and out 4-byte
// aligned.
int cn_match_2bit(const void* words, int64_t n_words, const void* table, int wq, int anchor,
                  int64_t n_starts, void* out, void* stream) {
  if (n_words == 0) return 0;
  if (wq < 1 || anchor < 0 || anchor >= wq) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((n_words + kThreads2 - 1) / kThreads2);
  match_2bit_kernel<<<blocks, kThreads2, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n_words, static_cast<const uint32_t*>(table), wq, anchor,
      n_starts, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Base-5 stream u64[n_words] (8-byte aligned) -> match bits u32[n_words].
// table (on the device) = ntaps[3], nanchor[3], taps[3][max_taps], each tap
// offset << 18 | care8 << 9 | q8 with a nonzero care8, anchors first; look =
// the largest tap offset / 9 + 1 words, at most 40.
int cn_match_b5(const void* words, int64_t n_words, const void* table, int max_taps, int look,
                int64_t n_starts, void* out, void* stream) {
  if (n_words == 0) return 0;
  if (look < 1 || look > kMaxLook5 || max_taps < 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((n_words + kWords5 - 1) / kWords5);
  match_b5_kernel<<<blocks, kWords5, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(words), n_words, static_cast<const uint32_t*>(table), max_taps, look,
      n_starts, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
