// Packed-domain exact search kernels for Hopper (sm_90a), plain C interface.
//
// Both kernels write one output u32 per stream word: bit s of out[w] flags a
// query match that starts in word w.  Starts at or past n_starts (the
// caller's length - m + 1) are cleared, and stream words past the end read as
// 0, as the reference pads them (cute_nucleotides_tpu/ops/search.py).
//
// 2-bit (replaces search.py:match_bits_rows): words are u32 of 16 nt, 2 bits
// each, LSB-first.  A start at nt 16w + s matches iff every concrete query
// nt i = 16a + r (not an N) equals nt 16(w + a) + s + r of the stream.  The
// host compiles the query into one step per concrete nt: its word offset a,
// its shift 2r and its code c replicated into all 16 fields.  The window
// funnel(x[w+a], x[w+a+1], 2r) holds nt 16(w + a) + s + r in field s for
// every s at once, so window ^ rep(c) leaves field s zero iff start s agrees
// at nt i: one funnel shift and one xor-or a step tests all 16 starts of a
// word.  Zero tests commute with OR, so the steps OR into one v per word and
// one test, ~(v | v >> 1) & 0x55555555, sets bit 2s iff start s matched;
// four multiply-masks then gather the even bits into bits 0-15.
//
// Base-5 (replaces pallas_kernels.py:match_b5_bits_rows): words are u64 of 9
// triplets t = a + 5b + 25c (7 bits each, bit 63 unused).  A block splits
// each word once into three digit words, A, B and C, holding the a, b and c
// digits of its 9 triplets in 3-bit fields at bits 3j (27 bits used), by
// the exact divisions t / 5 and t / 25, unclamped: a corrupt triplet
// (125..127) has c = 5, which fits in 3 bits and never equals a query digit
// (0..4, N is 4).  A start at nt 27w + 3j + p (slot j, phase p) matches iff
// for every cared digit d of every tap i of phase p, digit d of triplet 9w
// + j + i equals the query's.  All nine slots of a word are tested at once:
// the window of digit word d at triplet offset i = 9a + r is (X[w+a] >> 3r)
// | (X[w+a+1] << (27 - 3r)), one funnel shift; xor with the query digit
// replicated into the nine fields leaves field j zero iff slot j agrees;
// OR-ing that over the phase's taps and digits and one add,
// ~(((v & 0x36DB6DB) + 0x36DB6DB) | v) & 0x4924924, sets bit 3j + 2 iff
// slot j matched.  Shifted right by 2 - p it lands at bit 3j + p of out[w].
//
// The table is grouped by offset, not by phase: the window of a digit word
// at offset i is the same for the three phases, and only the query digit
// differs.  So one step per offset takes up to three funnel shifts and
// serves every phase with a tap there (a 7-nt query: 6 shifts and 21
// xor-ors a word, against 27 and 27 with one entry per phase and tap).
// Each thread takes 4 consecutive words and keeps their 64-bit digit-word
// pairs in registers, so each step entry is read once per 4 words and steps
// within a word need no shared load; 8 words a thread took 166 registers or
// more and ran slower.
//
// Neither kernel bakes the query in: it arrives as a small device table that
// every thread of a warp reads at the same address (one broadcast load), so
// one build of this file serves every query.  Each thread takes a run of
// consecutive words (8 in the 2-bit kernel, 4 in the base-5 one), so a
// step entry is read once per run.  Long queries fold their anchor steps
// first (the query word with the most concrete nt in the 2-bit kernel,
// taps per phase in the base-5 one; chosen on the host, as the reference
// chooses them) and the rest only where the anchor (in the 2-bit kernel,
// its first 10 steps) left a start alive in some lane of the warp
// (__any_sync).
//
// Bound: the memory traffic is small (4 B in, 4 B out per 16 nt; 8 B in, 4 B
// out per 27 nt).  The 2-bit kernel spends about two integer-ALU
// instructions a word per concrete query nt and ten more a word for the
// zero test, the tail and the loop, and its compaction's multiplies run on
// the multiply-add pipe; at short queries that is under the bytes' time.
// The base-5 kernel is bound by its integer-ALU work: the shifts and logic
// ops of the steps, the zero tests and the pairs, which share the integer
// ALU pipe at half the dispatch rate, while the splits' multiplies run on
// the multiply-add pipe beside it.
//
// Every entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// --- 2-bit -------------------------------------------------------------------

constexpr int kThreads2 = 128;             // threads a block
constexpr int kRun2 = 8;                   // consecutive words a thread
constexpr int kSpan2 = kThreads2 * kRun2;  // words a block
constexpr int kLook2 = 256;                // lookahead words a block stages past its span
// Steps before the live test: 10 concrete nt leave a start of random data
// alive with odds 4^-10, so a warp's 4096 starts rarely hold one, while
// the rest of a 15- or 16-nt anchor word would cost every word 5-6 steps.
constexpr int kPre2 = 10;
constexpr uint32_t kEven = 0x55555555u;    // bit 2s of each 2-bit field s

__device__ __forceinline__ uint32_t word_at(const uint32_t* __restrict__ x, int64_t n_words, int64_t i) {
  return i < n_words ? __ldg(x + i) : 0u;
}

// acc | (w ^ q) as one three-input logic op (ptxas would otherwise combine
// three of them for a word as a tree, one op more)
__device__ __forceinline__ uint32_t or_xor(uint32_t acc, uint32_t w, uint32_t q) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0xF6;" : "=r"(r) : "r"(acc), "r"(w), "r"(q));
  return r;
}

// Bit 2s of e (its odd bits clear) moved to bit s: four multiply-masks on
// the multiply-add pipe, each a sum of two copies whose bits cannot overlap
// (so no carry), then a shift.  Pairs of starts gather in bits 1-2 of each
// nibble, quads in bits 3-6 of each byte, octets in bits 7-14 of each half,
// and all 16 in bits 16-31.
__device__ __forceinline__ uint32_t compact_even(uint32_t e) {
  e = (e * 3u) & 0x66666666u;
  e = (e * 5u) & 0x78787878u;
  e = (e * 17u) & 0x7F807F80u;
  return (e * 514u) >> 16;
}

// The words x[w + a .. w + a + kRun2] of the thread whose run starts at
// tile index base: from the block's tile while they lie in it, else through
// __ldg (zeros past the stream).
__device__ __forceinline__ void run_words(const uint32_t* tile, int staged, const uint32_t* __restrict__ x,
                                          int64_t n_words, int64_t w0, int base, int a,
                                          uint32_t (&xs)[kRun2 + 1]) {
#pragma unroll
  for (int j = 0; j <= kRun2; ++j) {
    const int i = base + a + j;
    xs[j] = i < staged ? tile[i] : word_at(x, n_words, w0 + i);
  }
}

// One step (e = a << 5 | 2r, c x 0x55555555) over a thread's words: the
// 32-bit window at nt 16(w + k + a) + r, xor the query code replicated into
// all 16 fields, OR-ed into v[k].  Field s of v[k] stays zero while start
// 16(w + k) + s agrees with every step so far.  The funnel shift takes the
// shift amount mod 32, so a needs no masking off.
__device__ __forceinline__ void fold_step(const uint32_t (&xs)[kRun2 + 1], uint2 e, uint32_t (&v)[kRun2]) {
#pragma unroll
  for (int k = 0; k < kRun2; ++k) v[k] = or_xor(v[k], __funnelshift_r(xs[k], xs[k + 1], e.x), e.y);
}

// Block b covers words kSpan2 b .. kSpan2 (b + 1) - 1: thread t loads its
// kRun2 words (16-byte loads), the block stages them and up to kLook2
// words past its span in shared memory, and each thread folds the first
// min(n_first, kPre2) anchor steps (query word `anchor`, steps [0,
// n_first)) on words held in registers, then the other steps only where
// those left a start alive in some lane of the warp, reloading its words
// when a step's offset changes.  steps = n_steps u32 pairs (fold_step),
// the anchor's first, then the other query words' in order; look = the
// largest offset + 1 words.
__global__ void __launch_bounds__(kThreads2)
match_2bit_kernel(const uint32_t* __restrict__ x, int64_t n_words, const uint2* __restrict__ steps, int n_first,
                  int n_steps, int look, int anchor, int64_t n_starts, uint32_t* __restrict__ out) {
  __shared__ __align__(16) uint32_t tile[kSpan2 + kLook2];
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kSpan2;
  const int base = kRun2 * threadIdx.x;
  const int64_t w = w0 + base;
  uint4 own[kRun2 / 4];
#pragma unroll
  for (int c = 0; c < kRun2 / 4; ++c) {
    const int64_t wc = w + 4 * c;
    if (wc + 4 <= n_words) {
      own[c] = __ldg(reinterpret_cast<const uint4*>(x + wc));
    } else {
      own[c] = make_uint4(word_at(x, n_words, wc), word_at(x, n_words, wc + 1), word_at(x, n_words, wc + 2),
                          word_at(x, n_words, wc + 3));
    }
  }
  const int staged = kSpan2 + min(look, kLook2);
  for (int i = kSpan2 + threadIdx.x; i < staged; i += kThreads2) tile[i] = word_at(x, n_words, w0 + i);
#pragma unroll
  for (int c = 0; c < kRun2 / 4; ++c) *reinterpret_cast<uint4*>(tile + base + 4 * c) = own[c];
  __syncthreads();
  uint32_t xs[kRun2 + 1];
  if (anchor == 0) {
#pragma unroll
    for (int c = 0; c < kRun2 / 4; ++c) {
      xs[4 * c] = own[c].x, xs[4 * c + 1] = own[c].y, xs[4 * c + 2] = own[c].z, xs[4 * c + 3] = own[c].w;
    }
    xs[kRun2] = tile[base + kRun2];  // look >= 1: staged
  } else {
    run_words(tile, staged, x, n_words, w0, base, anchor, xs);
  }
  uint32_t v[kRun2] = {};
  const int n_pre = min(n_first, kPre2);
#pragma unroll 8
  for (int idx = 0; idx < n_pre; ++idx) fold_step(xs, __ldg(steps + idx), v);
  if (n_pre < n_steps) {
    uint32_t alive = 0;
#pragma unroll
    for (int k = 0; k < kRun2; ++k) alive |= ~(v[k] | (v[k] >> 1));
    if (__any_sync(0xFFFFFFFFu, (alive & kEven) != 0u)) {
      int cur = anchor;
      for (int idx = n_pre; idx < n_steps; ++idx) {
        const uint2 e = __ldg(steps + idx);
        const int a = static_cast<int>(e.x >> 5);
        if (a != cur) {
          cur = a;
          run_words(tile, staged, x, n_words, w0, base, a, xs);
        }
        fold_step(xs, e, v);
      }
    }
  }
  uint32_t bits[kRun2];
#pragma unroll
  for (int k = 0; k < kRun2; ++k) bits[k] = compact_even(~(v[k] | (v[k] >> 1)) & kEven);
  if (n_starts - 16 * w < 16 * kRun2) {
#pragma unroll
    for (int k = 0; k < kRun2; ++k) {
      const int64_t lim = n_starts - 16 * (w + k);
      if (lim < 16) bits[k] &= lim <= 0 ? 0u : (1u << lim) - 1u;
    }
  }
  if (w + kRun2 <= n_words) {
#pragma unroll
    for (int c = 0; c < kRun2; c += 4) {
      *reinterpret_cast<uint4*>(out + w + c) = make_uint4(bits[c], bits[c + 1], bits[c + 2], bits[c + 3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kRun2; ++k) {
      if (w + k < n_words) out[w + k] = bits[k];
    }
  }
}

// --- base-5 ------------------------------------------------------------------

constexpr int kThreads5 = 128;            // threads a block
constexpr int kRun5 = 4;                  // consecutive words a thread
constexpr int kSpan5 = kThreads5 * kRun5; // words a block
constexpr int kMaxLook5 = 40;             // lookahead words: a 1024-nt query (342 taps) needs 39
constexpr int kRow5 = kSpan5 + kMaxLook5; // digit words a block stages of each kind
constexpr int kTableHead = 8;             // table = n_first, n_steps, 0 x 6, then the steps
constexpr uint32_t kLow2 = 0x36DB6DBu;    // the low two bits of each 3-bit field j < 9
constexpr uint32_t kHigh = 0x4924924u;    // bit 3j + 2 of each field j < 9

// The digit words of one u64 stream word: its 9 triplets t = a + 5b + 25c
// as dig[0] = sum a_j << 3j, dig[1] = sum b_j << 3j, dig[2] = sum c_j << 3j,
// by exact divisions, unclamped: a corrupt triplet (125..127) gives c = 5.
// t / 5 and t / 25 are the high words of t times ceil(2^32 / 5) and
// ceil(2^32 / 25) (exact for t < 2^30).  The sums are linear, so a = t - 5
// (t / 5) and b = t / 5 - 5 (t / 25) are taken once a word, on the sums of
// t, t / 5 and t / 25 at 3j (exact mod 2^32: each result's fields do not
// overlap).  The divisions and sums are multiplies (IMAD), which run on the
// multiply-add pipe beside the integer ALU that extracts the triplets.  Bit
// 63 is ignored.
__device__ __forceinline__ void digit_words(uint64_t v, uint32_t (&dig)[3]) {
  uint32_t t_sum = 0, v5_sum = 0, v25_sum = 0;
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    const uint32_t t = static_cast<uint32_t>(v >> (7 * j)) & 0x7Fu;
    t_sum += t * (1u << (3 * j));
    v5_sum += __umulhi(t, 0x33333334u) * (1u << (3 * j));
    v25_sum += __umulhi(t, 0x0A3D70A4u) * (1u << (3 * j));
  }
  dig[0] = t_sum - 5u * v5_sum;
  dig[1] = v5_sum - 5u * v25_sum;
  dig[2] = v25_sum;
}

// Bit 3j + 2 set iff field j < 9 of v is zero.  The add cannot carry out of
// a field ((v & 3) + 3 <= 6); bits 27 and up of v are dropped.
__device__ __forceinline__ uint32_t zero_fields(uint32_t v) {
  return ~(((v & kLow2) + kLow2) | v) & kHigh;
}

// lo/hi pairs of kind d for the words x[0..kRun5] (kRun5 + 1 digit words)
__device__ __forceinline__ void pair_words(const uint32_t* x, uint32_t (&lo)[kRun5], uint32_t (&hi)[kRun5]) {
#pragma unroll
  for (int k = 0; k < kRun5; ++k) {
    lo[k] = x[k] | (x[k + 1] << 27);
    hi[k] = x[k + 1] >> 5;
  }
}

// One step over a thread's kRun5 words.  lo/hi[d][k] hold digit words k and
// k + 1 of kind d as one 64-bit value (word k | word k + 1 << 27), so the
// 9-slot window at shift sh (3 x the step's triplet offset within its
// word) is one funnel shift, or the low word itself at sh = 0 (bits 27 and
// up are garbage every test drops).  The window of each kind serves the
// three phases: diff[p][k] ORs in window d xor the phase's replicated query
// digit for each (p, d) the step cares for, so a field of diff[p][k] stays
// zero while every step so far agrees at that start.
template <bool kShift>
__device__ __forceinline__ void fold_step(const uint32_t (&lo)[3][kRun5], const uint32_t (&hi)[3][kRun5],
                                          uint32_t sh, uint32_t kinds, const uint32_t (&q)[9],
                                          uint32_t (&diff)[3][kRun5]) {
  uint32_t win[3][kRun5];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    if (kinds & (0x49u << d)) {  // some phase cares for digit d
#pragma unroll
      for (int k = 0; k < kRun5; ++k) win[d][k] = kShift ? __funnelshift_r(lo[d][k], hi[d][k], sh) : lo[d][k];
    }
  }
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const uint32_t mine = (kinds >> (3 * p)) & 7u;  // uniform: a branch, not predicates
    if (mine == 7u) {
#pragma unroll
      for (int k = 0; k < kRun5; ++k) {
        diff[p][k] = or_xor(or_xor(or_xor(diff[p][k], win[0][k], q[3 * p]), win[1][k], q[3 * p + 1]),
                            win[2][k], q[3 * p + 2]);
      }
    } else if (mine != 0u) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        if (mine & (1u << d)) {
#pragma unroll
          for (int k = 0; k < kRun5; ++k) diff[p][k] = or_xor(diff[p][k], win[d][k], q[3 * p + d]);
        }
      }
    }
  }
}

// Steps [from, to) over a thread's words.  A step entry is three uint4: a
// << 16 | kinds << 5 | 3r for the step's triplet offset 9a + r (bit 3p + d
// of kinds: phase p cares for digit d of the triplet), then the query's
// digit d for phase p replicated into the nine fields at u32 1 + 3p + d,
// then two zeros.  Steps with a = 0 take the thread's own pairs; the others
// read their words from the block's digit words in shared memory.
__device__ __forceinline__ void fold_steps(const uint4* __restrict__ steps, int from, int to,
                                           const uint32_t (&lo)[3][kRun5], const uint32_t (&hi)[3][kRun5],
                                           const uint32_t* dig, int base, uint32_t (&diff)[3][kRun5]) {
  for (int idx = from; idx < to; ++idx) {
    const uint4 e0 = __ldg(steps + 3 * idx), e1 = __ldg(steps + 3 * idx + 1), e2 = __ldg(steps + 3 * idx + 2);
    const uint32_t a = e0.x >> 16, kinds = (e0.x >> 5) & 0x1FFu, sh = e0.x & 31u;
    const uint32_t q[9] = {e0.y, e0.z, e0.w, e1.x, e1.y, e1.z, e1.w, e2.x, e2.y};
    if (a == 0u) {
      if (sh == 0u) {
        fold_step<false>(lo, hi, sh, kinds, q, diff);
      } else {
        fold_step<true>(lo, hi, sh, kinds, q, diff);
      }
    } else {
      uint32_t flo[3][kRun5], fhi[3][kRun5];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        if (kinds & (0x49u << d)) pair_words(dig + d * kRow5 + base + a, flo[d], fhi[d]);
      }
      fold_step<true>(flo, fhi, sh, kinds, q, diff);
    }
  }
}

// digit words of stream words i (even) and i + 1 into the block's rows
__device__ __forceinline__ void stage_pair(uint32_t* dig, int i, ulonglong2 v) {
  uint32_t d0[3], d1[3];
  digit_words(v.x, d0);
  digit_words(v.y, d1);
#pragma unroll
  for (int d = 0; d < 3; ++d) *reinterpret_cast<uint2*>(dig + d * kRow5 + i) = make_uint2(d0[d], d1[d]);
}

constexpr int kPairs5 = kSpan5 / (2 * kThreads5);  // 16-byte loads a thread

// Block b covers words kSpan5 b .. kSpan5 (b + 1) - 1.  Its threads load
// them and `look` following words (16-byte loads, all in flight before the
// first split; zeros past the stream), split each into its three digit
// words in shared memory, then thread t takes words kRun5 t .. kRun5 t +
// kRun5 - 1: the anchor steps, and the other steps only where an anchor
// left a start alive in some lane of the warp (a warp-uniform skip).
__global__ void __launch_bounds__(kThreads5)
match_b5_kernel(const uint64_t* __restrict__ x, int64_t n_words, const uint32_t* __restrict__ table, int look,
                int64_t n_starts, uint32_t* __restrict__ out) {
  __shared__ __align__(16) uint32_t dig[3 * kRow5];
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kSpan5;
  ulonglong2 raw[kPairs5];
#pragma unroll
  for (int m = 0; m < kPairs5; ++m) {
    const int64_t w = w0 + 2 * (threadIdx.x + m * kThreads5);
    if (w + 1 < n_words) {
      raw[m] = __ldg(reinterpret_cast<const ulonglong2*>(x + w));
    } else {
      raw[m] = make_ulonglong2(w < n_words ? __ldg(x + w) : 0ull, 0ull);
    }
  }
  const int64_t wl = w0 + kSpan5 + threadIdx.x;
  const uint64_t extra = static_cast<int>(threadIdx.x) < look && wl < n_words ? __ldg(x + wl) : 0ull;
#pragma unroll
  for (int m = 0; m < kPairs5; ++m) stage_pair(dig, 2 * (threadIdx.x + m * kThreads5), raw[m]);
  if (static_cast<int>(threadIdx.x) < look) {
    uint32_t d[3];
    digit_words(extra, d);
#pragma unroll
    for (int k = 0; k < 3; ++k) dig[k * kRow5 + kSpan5 + threadIdx.x] = d[k];
  }
  __syncthreads();
  const uint4* steps = reinterpret_cast<const uint4*>(table + kTableHead);
  const int n_first = static_cast<int>(__ldg(table)), n_steps = static_cast<int>(__ldg(table + 1));
  const int base = kRun5 * threadIdx.x;
  uint32_t lo[3][kRun5], hi[3][kRun5];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    uint32_t run[kRun5 + 1];
#pragma unroll
    for (int c = 0; c < kRun5; c += 4) {
      const uint4 own = *reinterpret_cast<const uint4*>(dig + d * kRow5 + base + c);
      run[c] = own.x, run[c + 1] = own.y, run[c + 2] = own.z, run[c + 3] = own.w;
    }
    run[kRun5] = dig[d * kRow5 + base + kRun5];
    pair_words(run, lo[d], hi[d]);
#pragma unroll
    for (int k = 0; k < kRun5; ++k) {
      // keep the pairs in registers: rebuilding them in every step costs
      // three instructions a window
      asm volatile("" : "+r"(lo[d][k]), "+r"(hi[d][k]));
    }
  }
  uint32_t diff[3][kRun5] = {};
  fold_steps(steps, 0, n_first, lo, hi, dig, base, diff);
  if (n_first < n_steps) {
    uint32_t nonzero = 0xFFFFFFFFu;  // bit 3j + 2: field j nonzero in every diff so far
#pragma unroll
    for (int p = 0; p < 3; ++p) {
#pragma unroll
      for (int k = 0; k < kRun5; ++k) nonzero &= ((diff[p][k] & kLow2) + kLow2) | diff[p][k];
    }
    const bool live = (~nonzero & kHigh) != 0u;
    if (__any_sync(0xFFFFFFFFu, live)) fold_steps(steps, n_first, n_steps, lo, hi, dig, base, diff);
  }
  const int64_t w = w0 + base;
  uint32_t bits[kRun5];
#pragma unroll
  for (int k = 0; k < kRun5; ++k) {
    // phase p's hits sit at bits 3j + 2; the output wants them at 3j + p
    bits[k] = (zero_fields(diff[0][k]) >> 2) | (zero_fields(diff[1][k]) >> 1) | zero_fields(diff[2][k]);
  }
  if (n_starts - 27 * w < 27 * kRun5) {
#pragma unroll
    for (int k = 0; k < kRun5; ++k) {
      const int64_t lim = n_starts - 27 * (w + k);
      if (lim < 27) bits[k] &= lim <= 0 ? 0u : (1u << lim) - 1u;
    }
  }
  if (w + kRun5 <= n_words) {
#pragma unroll
    for (int c = 0; c < kRun5; c += 4) {
      *reinterpret_cast<uint4*>(out + w + c) = make_uint4(bits[c], bits[c + 1], bits[c + 2], bits[c + 3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kRun5; ++k) {
      if (w + k < n_words) out[w + k] = bits[k];
    }
  }
}

}  // namespace

extern "C" {

// Packed 2-bit stream u32[n_words] (16-byte aligned) -> match bits
// u32[n_words] (16-byte aligned).  table (on the device, 8-byte aligned)
// holds n_steps u32 pairs (match_2bit_kernel); n_first, n_steps, look and
// anchor are the head of the host's copy (kernels._match_table).  A head
// that is not consistent (n_first > n_steps, no anchor step while there are
// steps, look < 1, the anchor at or past look) returns cudaErrorInvalidValue
// before any launch.
int cn_match_2bit(const void* words, int64_t n_words, const void* table, int n_first, int n_steps, int look,
                  int anchor, int64_t n_starts, void* out, void* stream) {
  if (n_first < 0 || n_first > n_steps || (n_steps > 0 && n_first == 0) || look < 1 || anchor < 0 ||
      anchor >= look) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_words == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((n_words + kSpan2 - 1) / kSpan2);
  match_2bit_kernel<<<blocks, kThreads2, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n_words, static_cast<const uint2*>(table), n_first, n_steps, look,
      anchor, n_starts, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Base-5 stream u64[n_words] (16-byte aligned) -> match bits u32[n_words]
// (16-byte aligned).  table (on the device, 16-byte aligned) = n_first,
// n_steps, six zeros, then n_steps steps of 12 u32 (fold_steps), the
// anchor steps first.  look = ceil(largest step offset / 9) + 1 words, at
// most 40.
int cn_match_b5(const void* words, int64_t n_words, const void* table, int look, int64_t n_starts, void* out,
                void* stream) {
  if (n_words == 0) return 0;
  if (look < 1 || look > kMaxLook5) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((n_words + kSpan5 - 1) / kSpan5);
  match_b5_kernel<<<blocks, kThreads5, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(words), n_words, static_cast<const uint32_t*>(table), look, n_starts,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
