// Myers bit-vector edit-distance scan for Hopper (sm_90a), plain C interface,
// and beside it the base-5 Peq build that feeds it (its own section below).
//
// Replaces the word scans of cute_nucleotides_tpu/ops/align.py:
// _myers_scan_words (:336, 2-bit text) and _myers_scan_words_b5 (:385, base-5
// text).  Those are no Pallas kernels: each is one XLA while-loop (lax.scan)
// over the text words, every step advancing all B pairs' DP columns as (B,)
// u32 vectors, one pair per VPU lane, with the char step of align.py:
// _scan_setup (:248-313): Hyyro's recurrence on each 32-row block of the
// query, the adder carry and the two shift-out bits of Ph and Mh passed from
// block to block.
//
// What bounds it here: integer issue.  A text char costs at least 11
// instructions a block (Eq, the two-instruction adder, Xh, Ph, Mh, the two
// shifts, Xv, the new PV and MV) and a few a char
// (utils/profiling.py:myers_ops, the floor behind the bound).  The logic ops
// (LOP3, SHF, IADD3, ISETP, SEL) run on the INT32 pipe, 16 lanes a clock per
// scheduler, so a warp issues one every other clock; IMAD runs on the FMA
// pipe beside it.  So the design (1) fills all 528 schedulers (132 SMs x 4)
// and (2) spends as few INT32 instructions a char as it can, moving the
// shifts, the bit extractions and the score onto IMAD.
//
// The wavefront.  A pair (query, text) takes L lanes of a warp, L a power of
// two, and lane b holds BPL consecutive blocks (block b * BPL + i) with their
// PV and MV in registers and their Eq planes in shared memory.  Lane b runs D
// steps behind lane b - 1: at step s it takes text char s - D b.  What lane
// b - 1 produced for that char (the top words of Ph and Mh of its top block,
// and the adder's carry as 0/1) it sent D steps earlier by three
// __shfl_up_sync of width L, kept in a ring of D slots.  Ph's and Mh's bit
// 31 come out by one IMAD a value with a per-lane multiplier (0 on a pair's
// first lane, whose Ph input, phin0, is a loop-invariant 64-bit addend of
// the same IMAD.WIDE), the carry by one IMAD with 0 or 1, so a first lane
// needs no branch.  Within a lane the blocks chain in the same step: at BPL = 2
// one 64-bit add carries block 0 into block 1.  Each lane reads its own
// text, shifted by its lag (2-bit: a funnel shift of two words by 2 D b
// bits; base-5, D = 3: the 64-bit word shifted by b triplets), so every
// lane's loads are the same instruction and decode the same way, and the
// next word is loaded while a word runs.  2-bit: D = 2, so the shuffle's
// latency lies off the critical path; base-5: D = 3, so a lane's lag is
// whole triplets.  A lane outside [0, jend) of its char leaves its state
// unchanged: the text runs in whole words with no char test; only the word
// steps where a lane of the warp fills or drains test each char.  L = 1 is
// the solo form: no shuffles, the row-0 input a constant.
//
// Eq.  A lane's planes sit in its warp's shared region, plane c of block i at
// byte i * kTable + 128 c + 4 lane, so the lanes of a warp hit 32 banks.  A
// 2-bit code becomes the address with one shift and one LOP3 (the code's two
// bits ORed into bits 7-8 of the lane's base), then one LDS; a base-5
// triplet's three digits come from two IMAD.HI (t / 5, t / 25) and IMADs.  A
// corrupt triplet (125..127) gives digit 5, whose plane is a copy of plane 0
// (the reference's Eq defaults to plane 0, align.py:274-278).
//
// The score.  Global: no per-char work; D[m][n] comes from the final column,
// n + the popcounts of PV and MV below the score row - m, summed over the
// pair's lanes by __shfl_xor_sync.  Other modes: the score row's Ph and Mh
// bits, moved to bit 31 by a per-block multiplier (0 off the score block),
// added and subtracted by two IMAD.HI; semiglobal and prefix keep the best
// and its first end, ends writes a byte a char (the solo form 16 bytes a
// word).  The mode is a template argument: no flag is tested per char.
//
// The launch plan (cn_myers_plan reports it): one or two blocks are solo,
// a lane a pair.  More take L = pow2(nb) lanes of one block while the
// batch's lanes fit one warp a scheduler (the device's SMs x 4 x 32 lanes,
// 16,896 on an H100 SXM; two warps in semiglobal mode), else L / 2 lanes
// of two blocks.  Where one warp a scheduler is all there is, one block a
// lane keeps the step short (a 2-block step's chain is longer); past it,
// two blocks a lane spend about a quarter fewer instructions a pair (phase
// 1 of chip_smoke.py prints both steady loops), which a second warp on
// each scheduler does not win back, except in semiglobal mode: there the
// 2-block step, which branches on the best, stays 9-11% behind to two
// warps a scheduler.  Timing both forms in every mode at 2, 4 and 8
// blocks (bench_myers.py sweep, from builds with CN_MYERS_BPL set;
// PERF.md) put the crossovers there; at 2 blocks the solo form was slower
// only in prefix mode (by 11%, to 8,192 pairs).  So the bench's 8192
// pairs of 4 blocks run 2 lanes of 2 blocks in global mode, 512 warps,
// where one pair a thread gave 256 and half the card's schedulers idled,
// and 4 lanes of one block in semiglobal mode.  Queries past kRegBlocks
// blocks (1024 nt) take the scratch form: one pair a thread, PV and MV in a
// global scratch [nb][rows].
//
// Text, row r: row_len u32 starting at u32 r * row_stride of one flat
// stream, zeros past its end (n_words).  A batch u32[R, Wt] is row_stride =
// row_len = Wt; a long stream split into rows with a halo
// (best_match_stream) is row_stride = wrb, row_len = wrb + H.  2-bit: 16
// codes a u32, LSB first.  Base-5: a u32 pair is one u64 word of 9 triplets
// of 7 bits (bit 63 in none), split by the exact multiply-shifts t * 205 >>
// 10 (t / 5) and t * 41 >> 10 (t / 25).  Peq, row r: A planes of nb u32 at
// peq + r * peq_stride (stride 0: one query for every row).
//
// Modes: 0 global (row 0's input +1, the final score), 1 semiglobal (input
// 0, the best score and its first end), 2 prefix (input +1, the best), 3
// ends (semiglobal; writes score <= max_errors[r] for every position j <
// tlens[r] into a u8 row of row_len * 16 columns, which the caller zeroes).
// A row stops at its own min(tlens[r], capacity).  Base-5 has no ends mode.
//
// The stream form (myers_stream, entry point cn_myers_stream) is the batch
// form's sibling for best_match_stream: one query against every row of one
// stream, semiglobal, reduced on the card to one key (its section below).
//
// The design before this one (one pair a thread, Eq an A-way select,
// runtime mode flags, 64-bit positions and adds, 2.0-2.5 times the floor's
// instructions a char) took 0.2407 ms at the bench shape (8192 pairs, m =
// 128, n = 2048) and 0.7208 ms on the chr1-length stream (m = 21) on an
// H100 at 700 W (PERF.md).
//
// The entry points launch on the caller's stream, allocate nothing, do not
// synchronise, and return cudaGetLastError() after their launch.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kGlobal = 0, kSemi = 1, kPrefix = 2, kEnds = 3;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kRegBlocks = 32;     // the lane forms hold up to 32 blocks (1024 query nt)
constexpr int kSmLanes = 4 * 32;    // one warp on each of an SM's four schedulers
constexpr int kLag2 = 2;            // steps a lane runs behind the one below it, 2-bit text

struct Args {
  const uint32_t* peq;
  int64_t peq_stride;
  int nb;
  const int32_t* qlens;
  const uint32_t* words;
  int64_t n_words;
  int64_t row_stride;
  int64_t row_len;
  const int32_t* tlens;
  const int32_t* max_errors;
  int64_t rows;
  int32_t* score;
  int32_t* best;
  int32_t* best_end;
  uint8_t* ends;
  uint32_t* scratch;
};

template <int MODE>
struct Mode {
  static constexpr bool kTrack = MODE == kSemi || MODE == kPrefix;  // the best and its first end
  static constexpr bool kEmit = MODE == kEnds;                      // the ends row
  static constexpr bool kStep = MODE != kGlobal;                    // a score every char
  static constexpr uint32_t kPhin0 = MODE == kSemi || MODE == kEnds ? 0u : 1u;  // row 0's input
};

// The chars row r scans: min(tlens[r], its capacity), at least 0.
__device__ __forceinline__ uint32_t row_end(const Args& g, int64_t r, bool b5) {
  const int64_t cap = b5 ? (g.row_len / 2) * 27 : g.row_len * 16;
  const int64_t tlen = g.tlens[r];
  return static_cast<uint32_t>(tlen < cap ? (tlen > 0 ? tlen : 0) : cap);
}

// u32 the row holds before the stream ends
__device__ __forceinline__ uint32_t row_avail(const Args& g, int64_t r) {
  const int64_t left = g.n_words - r * g.row_stride;
  const int64_t n = left < g.row_len ? left : g.row_len;
  return static_cast<uint32_t>(n > 0 ? (n < 0x7FFFFFFF ? n : 0x7FFFFFFF) : 0);
}

__device__ __forceinline__ uint32_t lds(uint32_t addr) {
  uint32_t v;
  asm("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// hi(x * 2) as signed: -1 where bit 31 of x is set, else 0 (added to c)
__device__ __forceinline__ int32_t minus_bit31(uint32_t x, int32_t c) {
  int32_t v;
  asm("mad.hi.s32 %0, %1, 2, %2;" : "=r"(v) : "r"(x), "r"(c));
  return v;
}

// --- the lane forms --------------------------------------------------------

template <int BPL, int MODE, bool B5, bool WAVE>
struct Lane {
  using M = Mode<MODE>;
  static constexpr int D = B5 ? 3 : kLag2;
  static constexpr int kTable = (B5 ? 6 : 4) * 128;  // a block's planes in the warp's region

  uint32_t pv[BPL], mv[BPL];
  uint32_t ring[D][3];    // what the lane below sent D steps ago: Ph and Mh (bit 31), the carry (0/1)
  uint32_t mult, first;   // 0 on a pair's first lane, else 2 (bit 31 -> 0/1) and 1
  uint64_t padd;          // phin0 << 32 on a pair's first lane, else 0
  uint32_t smul[BPL];     // the score row's bit -> bit 31 (0 off the score block)
  uint32_t base;          // the lane's shared address of plane 0, block 0
  uint32_t lag, jend;     // chars the lane lags its pair's first lane; the row's end
  int32_t score, best, best_end, max_errors;
  bool slane;             // the lane owning the score: the score block's, or the first with none
  uint8_t* ends;
  uint32_t emit_bits[M::kEmit && !WAVE ? 4 : 1];  // the solo form's ends bytes of one word
  int width;              // L

  template <bool CHECK>
  __device__ __forceinline__ void step(int k, uint32_t addr, uint32_t c) {
    uint32_t* rx = ring[k % D];
    uint32_t pin, nin, cin;
    if constexpr (WAVE) {
      // one IMAD.WIDE: hi(word * 0 or 2) + the row-0 input, from a loop-invariant 64-bit addend
      pin = static_cast<uint32_t>((static_cast<uint64_t>(rx[0]) * mult + padd) >> 32);
      nin = __umulhi(rx[1], mult);
      cin = rx[2] * first;  // the carry arrives as 0/1
    } else {
      pin = M::kPhin0;
      nin = cin = 0u;
    }
    const bool valid = !CHECK || c < jend;
    uint32_t ph[BPL], mh[BPL], co;
    if constexpr (BPL == 1) {
      const uint32_t e = lds(addr), p = pv[0], m = mv[0];
      const uint32_t xv = e | m, a = e & p, s = a + p + cin;
      co = (a | (p & ~s)) >> 31;  // the adder's carry out (a lies inside p)
      const uint32_t xh = (s ^ p) | e;
      ph[0] = m | ~(xh | p);
      mh[0] = p & xh;
      const uint32_t ps = ph[0] * 2u + pin, ms = mh[0] * 2u + nin;
      if (valid) {
        pv[0] = ms | ~(xv | ps);
        mv[0] = ps & xv;
      }
    } else {
      static_assert(BPL == 2, "one or two blocks a lane");
      const uint32_t e0 = lds(addr), e1 = lds(addr + kTable);
      const uint32_t p0 = pv[0], p1 = pv[1], m0 = mv[0], m1 = mv[1];
      const uint32_t a0 = e0 & p0, a1 = e1 & p1;
      const uint64_t sum = ((static_cast<uint64_t>(a1) << 32) | a0) + ((static_cast<uint64_t>(p1) << 32) | p0) + cin;
      const uint32_t s0 = static_cast<uint32_t>(sum), s1 = static_cast<uint32_t>(sum >> 32);
      co = (a1 | (p1 & ~s1)) >> 31;
      const uint32_t xh0 = (s0 ^ p0) | e0, xh1 = (s1 ^ p1) | e1;
      ph[0] = m0 | ~(xh0 | p0);
      ph[1] = m1 | ~(xh1 | p1);
      mh[0] = p0 & xh0;
      mh[1] = p1 & xh1;
      const uint32_t ps0 = ph[0] * 2u + pin, ms0 = mh[0] * 2u + nin;
      const uint32_t ps1 = __funnelshift_l(ph[0], ph[1], 1), ms1 = __funnelshift_l(mh[0], mh[1], 1);
      const uint32_t xv0 = e0 | m0, xv1 = e1 | m1;
      if (valid) {
        pv[0] = ms0 | ~(xv0 | ps0);
        mv[0] = ps0 & xv0;
        pv[1] = ms1 | ~(xv1 | ps1);
        mv[1] = ps1 & xv1;
      }
    }
    if constexpr (WAVE) {
      rx[0] = __shfl_up_sync(kFull, ph[BPL - 1], 1, width);
      rx[1] = __shfl_up_sync(kFull, mh[BPL - 1], 1, width);
      rx[2] = __shfl_up_sync(kFull, co, 1, width);
    }
    if constexpr (M::kStep) {
      uint32_t x = ph[0] * smul[0], y = mh[0] * smul[0];
      if constexpr (BPL == 2) {
        x += ph[1] * smul[1];
        y += mh[1] * smul[1];
      }
      const int32_t ns = minus_bit31(y, static_cast<int32_t>(__umulhi(x, 2u)) + score);
      if (valid) score = ns;
      if constexpr (M::kTrack) {
        if (valid && score < best) {
          best = score;
          best_end = static_cast<int32_t>(c + 1);
        }
      }
      if constexpr (M::kEmit) {
        if constexpr (WAVE) {
          if (valid && slane) ends[c] = score <= max_errors;
        } else {
          emit_bits[k >> 2] |= static_cast<uint32_t>(valid && score <= max_errors) << (8 * (k & 3));
        }
      }
    }
  }

  // One word step of 2-bit text: the 16 codes of the lane's (lag-shifted)
  // word v, the first at char c0.
  template <bool CHECK>
  __device__ __forceinline__ void word2(uint32_t v, uint32_t c0) {
    if constexpr (M::kEmit && !WAVE) {
#pragma unroll
      for (int i = 0; i < 4; ++i) emit_bits[i] = 0u;
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const uint32_t code = k >= 4 ? v >> (2 * k - 7) : v << (7 - 2 * k);
      step<CHECK>(k, (code & 0x180u) | base, c0 + k);
    }
    if constexpr (M::kEmit && !WAVE) {
      // the solo form's chars start a 16-byte aligned run of the ends row
      if (c0 < jend)
        *reinterpret_cast<uint4*>(ends + c0) = make_uint4(emit_bits[0], emit_bits[1], emit_bits[2], emit_bits[3]);
    }
  }

  // One word step of base-5 text: the 27 digits of the lane's (lag-shifted)
  // 64-bit word v, the first at char c0.
  template <bool CHECK>
  __device__ __forceinline__ void word5(uint64_t v, uint32_t c0) {
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const uint32_t tr = static_cast<uint32_t>(v >> (7 * t)) & 0x7Fu;
      const uint32_t q5 = __umulhi(tr, 205u << 22), q25 = __umulhi(tr, 41u << 22);
      step<CHECK>(3 * t, base + (tr - 5u * q5) * 128u, c0 + 3 * t);
      step<CHECK>(3 * t + 1, base + (q5 - 5u * q25) * 128u, c0 + 3 * t + 1);
      step<CHECK>(3 * t + 2, base + q25 * 128u, c0 + 3 * t + 2);
    }
  }
};

template <int BPL, int MODE, bool B5, bool WAVE>
__global__ void __launch_bounds__(kThreads) myers_lanes(const Args g, const int log2l) {
  using M = Mode<MODE>;
  using LaneT = Lane<BPL, MODE, B5, WAVE>;
  constexpr int A = B5 ? 5 : 4;
  constexpr int U = B5 ? 27 : 16;  // chars a text word
  constexpr int D = LaneT::D;
  __shared__ __align__(1024) uint32_t table[kThreads / 32][BPL * LaneT::kTable / 4];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t gid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int L = 1 << log2l;
  const int lb = static_cast<int>(gid & (L - 1));  // the lane in its pair
  const int64_t r0 = gid >> log2l;
  const bool live = r0 < g.rows;
  const int64_t r = live ? r0 : g.rows - 1;  // a lane past the last pair reads the last and writes nothing

  // the lane's Eq planes into its column of the warp's region
  const uint32_t* peq = g.peq + r * g.peq_stride;
#pragma unroll
  for (int i = 0; i < BPL; ++i) {
    const int b = lb * BPL + i;
    uint32_t* col = &table[warp][i * LaneT::kTable / 4 + lane];
#pragma unroll
    for (int k = 0; k < A; ++k) col[k * 32] = b < g.nb ? __ldg(peq + k * g.nb + b) : 0u;
    if constexpr (B5) col[5 * 32] = col[0];  // digit 5 (a corrupt triplet) reads plane 0
  }
  __syncwarp();

  LaneT s;
  s.base = static_cast<uint32_t>(__cvta_generic_to_shared(&table[warp][lane]));
  s.width = L;
  const int32_t qlen = g.qlens[r];
  const int32_t m1 = (qlen > 1 ? qlen : 1) - 1;
  const int hb = m1 >> 5;  // the score block
  s.slane = hb < g.nb ? hb / BPL == lb : lb == 0;
#pragma unroll
  for (int i = 0; i < BPL; ++i) {
    s.pv[i] = 0xFFFFFFFFu;
    s.mv[i] = 0u;
    s.smul[i] = hb < g.nb && s.slane && hb % BPL == i ? 1u << (31 - (m1 & 31)) : 0u;
  }
#pragma unroll
  for (int k = 0; k < D; ++k) s.ring[k][0] = s.ring[k][1] = s.ring[k][2] = 0u;
  s.mult = lb ? 2u : 0u;
  s.first = lb ? 1u : 0u;
  s.padd = static_cast<uint64_t>(lb ? 0u : M::kPhin0) << 32;
  s.lag = static_cast<uint32_t>(D * lb);
  s.jend = live ? row_end(g, r, B5) : 0u;
  s.score = s.best = qlen;
  s.best_end = 0;
  s.max_errors = M::kEmit ? g.max_errors[r] : 0;
  s.ends = M::kEmit ? g.ends + r * (g.row_len * 16) : nullptr;

  // word steps: [0, ga) fill, [ga, gb) every char of every lane inside its
  // row, [max(ga, gb), gc) drain; bounds are the warp's, so lanes stay converged
  const uint32_t jmin = __reduce_min_sync(kFull, s.jend), jmax = __reduce_max_sync(kFull, s.jend);
  const uint32_t fill = static_cast<uint32_t>(D * (L - 1));
  const uint32_t ga = (fill + U - 1) / U, gb = jmin / U;
  const uint32_t gc = static_cast<uint32_t>((static_cast<uint64_t>(jmax) + fill + U - 1) / U);
  const uint32_t* row = g.words + r * g.row_stride;
  const uint32_t avail = row_avail(g, r);
  auto word = [&](int64_t w) -> uint32_t {
    return static_cast<uint64_t>(w) < avail ? __ldg(row + w) : 0u;
  };

  if constexpr (!B5) {
    // the lane's text: a funnel shift of words w - 1 and w by its lag in
    // bits; word w + 1 is in flight while word w runs
    const uint32_t lagbits = 2u * s.lag, q = lagbits >> 5, rb = lagbits & 31u;
    uint32_t prev = word(-static_cast<int64_t>(q) - 1), cur = word(-static_cast<int64_t>(q));
    auto run = [&](auto check, uint32_t g0, uint32_t g1) {
      for (uint32_t w = g0; w < g1; ++w) {
        const uint32_t next = word(static_cast<int64_t>(w) + 1 - q);
        s.template word2<decltype(check)::value>(__funnelshift_l(prev, cur, rb), w * U - s.lag);
        prev = cur;
        cur = next;
      }
    };
    const uint32_t ga2 = ga < gc ? ga : gc;
    run(std::true_type{}, 0u, ga2);
    if (gb > ga) run(std::false_type{}, ga, gb);
    run(std::true_type{}, ga2 > gb ? ga2 : gb, gc);
  } else {
    // the lane's text: the 64-bit word shifted up by its lag in triplets
    const uint32_t q = static_cast<uint32_t>(lb) / 9u, sh = 7u * (static_cast<uint32_t>(lb) % 9u);
    auto pair = [&](int64_t w) -> uint64_t {
      return (static_cast<uint64_t>(word(2 * w + 1)) << 32) | word(2 * w);
    };
    uint64_t prev = pair(-static_cast<int64_t>(q) - 1) & 0x7FFFFFFFFFFFFFFFull, cur = pair(-static_cast<int64_t>(q));
    auto run = [&](auto check, uint32_t g0, uint32_t g1) {
      for (uint32_t w = g0; w < g1; ++w) {
        const uint64_t next = pair(static_cast<int64_t>(w) + 1 - q);
        s.template word5<decltype(check)::value>((cur << sh) | ((prev >> 1) >> (62 - sh)), w * U - s.lag);
        prev = cur & 0x7FFFFFFFFFFFFFFFull;
        cur = next;
      }
    };
    const uint32_t ga2 = ga < gc ? ga : gc;
    run(std::true_type{}, 0u, ga2);
    if (gb > ga) run(std::false_type{}, ga, gb);
    run(std::true_type{}, ga2 > gb ? ga2 : gb, gc);
  }

  if constexpr (MODE == kGlobal) {
    // D[m1 + 1][n] = n + (PV - MV below the score row) of the last column
    const uint32_t top = (2u << (m1 & 31)) - 1u;  // rows 0..m1 % 32 of the score block
    int32_t part = 0;
#pragma unroll
    for (int i = 0; i < BPL; ++i) {
      const int b = lb * BPL + i;
      const uint32_t mask = b < hb ? 0xFFFFFFFFu : b == hb ? top : 0u;
      part += __popc(s.pv[i] & mask) - __popc(s.mv[i] & mask);
    }
    if constexpr (WAVE) {
      for (int o = 1; o < L; o <<= 1) part += __shfl_xor_sync(kFull, part, o, L);
    }
    if (live && lb == 0) {
      const uint32_t v = hb < g.nb ? static_cast<uint32_t>(qlen) + s.jend + static_cast<uint32_t>(part) -
                                         static_cast<uint32_t>(m1 + 1)
                                   : static_cast<uint32_t>(qlen);
      g.score[r] = static_cast<int32_t>(v);
    }
  } else if constexpr (M::kTrack) {
    if (live && s.slane) {
      g.best[r] = s.best;
      g.best_end[r] = s.best_end;
    }
  }
}

// --- the scratch form: one pair a thread, nb > kRegBlocks ------------------

template <int MODE, bool B5>
__global__ void __launch_bounds__(kThreads) myers_scratch(const Args g) {
  using M = Mode<MODE>;
  constexpr int A = B5 ? 5 : 4;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= g.rows) return;
  const int32_t qlen = g.qlens[r];
  const int32_t m1 = (qlen > 1 ? qlen : 1) - 1;
  const int hb = m1 >> 5;
  const uint32_t hmask = hb < g.nb ? 1u << (m1 & 31) : 0u;  // no score bit when the query outruns its blocks
  const int32_t max_errors = M::kEmit ? g.max_errors[r] : 0;
  uint8_t* ends = M::kEmit ? g.ends + r * (g.row_len * 16) : nullptr;
  const uint32_t jend = row_end(g, r, B5);
  const uint32_t* peq = g.peq + r * g.peq_stride;
  uint32_t* pv = g.scratch + r;
  uint32_t* mv = g.scratch + g.nb * g.rows + r;
  for (int b = 0; b < g.nb; ++b) {
    pv[b * g.rows] = 0xFFFFFFFFu;
    mv[b * g.rows] = 0u;
  }
  int32_t score = qlen, best = qlen, best_end = 0;
  const uint32_t* row = g.words + r * g.row_stride;
  const uint32_t avail = row_avail(g, r);
  auto word = [&](uint32_t w) -> uint32_t { return w < avail ? __ldg(row + w) : 0u; };
  auto step = [&](uint32_t c, uint32_t j) {
    const uint32_t* eq = peq + (c < static_cast<uint32_t>(A) ? c : 0u) * g.nb;
    uint32_t cin = 0u, phin = M::kPhin0, mhin = 0u, dp = 0u, dm = 0u;
    for (int b = 0; b < g.nb; ++b) {
      const int64_t at = b * g.rows;
      const uint32_t e = __ldg(eq + b), p = pv[at], m = mv[at];
      const uint32_t xv = e | m, a = e & p, s = a + p + cin;
      cin = (a | (p & ~s)) >> 31;
      const uint32_t xh = (s ^ p) | e;
      const uint32_t ph = m | ~(xh | p), mh = p & xh;
      const uint32_t ps = (ph << 1) | phin, ms = (mh << 1) | mhin;
      phin = ph >> 31;
      mhin = mh >> 31;
      pv[at] = ms | ~(xv | ps);
      mv[at] = ps & xv;
      if (b == hb) {
        dp = ph & hmask;
        dm = mh & hmask;
      }
    }
    score += (dp != 0u) - (dm != 0u);
    if (M::kTrack && score < best) {
      best = score;
      best_end = static_cast<int32_t>(j + 1);
    }
    if (M::kEmit) ends[j] = score <= max_errors;
  };
  uint32_t j = 0;
  if constexpr (!B5) {
    for (uint32_t w = 0; j < jend; ++w) {
      const uint32_t v = word(w);
      for (int k = 0; k < 16 && j < jend; ++k, ++j) step((v >> (2 * k)) & 3u, j);
    }
  } else {
    for (uint32_t w = 0; j < jend; ++w) {
      const uint64_t v = (static_cast<uint64_t>(word(2 * w + 1)) << 32) | word(2 * w);
      for (int t = 0; t < 9 && j < jend; ++t) {
        const uint32_t tr = static_cast<uint32_t>(v >> (7 * t)) & 0x7Fu;
        const uint32_t q5 = (tr * 205u) >> 10, q25 = (tr * 41u) >> 10;
        const uint32_t digit[3] = {tr - 5u * q5, q5 - 5u * q25, q25};
        for (int d = 0; d < 3 && j < jend; ++d, ++j) step(digit[d], j);
      }
    }
  }
  if (MODE == kGlobal) g.score[r] = score;
  if (M::kTrack) {
    g.best[r] = best;
    g.best_end[r] = best_end;
  }
}

// --- the stream form: one query over the rows of one stream -----------------
//
// best_match_stream's scan.  What bounds a call is the host: a chromosome's
// scan takes about 0.2 ms of the card, and every device operation and wait
// the host adds around it leaves the card idle.  So a call is one memset, one
// launch and one 8-byte result.  The batch form reads a Peq, a query length
// and a text length a row from device memory and writes a result a row; here
// every row takes the one query, semiglobal, so:
// - the query's Peq (A planes of nb u32, at most kRegBlocks blocks: 640
//   bytes) comes by value in the parameters, and the lanes fill their Eq
//   table from there;
// - row r's text length is min(max(length - r * nt_per_row, 0), its
//   capacity), worked out in the kernel, and its query length the one m;
// - the epilogue writes no row: a row's (best, first end) becomes the key
//   (best << 32) | (r * nt_per_row + end), the low half 0 where best is m
//   (nothing beats the empty alignment), a warp's least key (a shuffle min)
//   goes to one slot by one atomicMin.  The least key is the least distance
//   and, of the rows reaching it below m, the first global end, rows that
//   share it in their halo included; (m << 32) where no row beats m.  The
//   stream holds under 2^31 nt, so an end fits the low half.
// The lanes, their Eq table, the char step and the word loops are the batch
// form's (Lane, the plan in mode 1), unchanged.

struct StreamArgs {
  Args g;                        // the rows: words, n_words, row_stride, row_len, rows, nb; no per-row pointer
  int64_t length, nt_per_row;    // the stream's nt; nt from one row's start to the next
  int32_t qlen;                  // m, every row's
  unsigned long long* key;       // the slot, all ones before the launch
  uint32_t peq[5 * kRegBlocks];  // the query's Peq, A planes of nb u32
};

template <int BPL, bool B5, bool WAVE>
__global__ void __launch_bounds__(kThreads) myers_stream(const __grid_constant__ StreamArgs a, const int log2l) {
  using LaneT = Lane<BPL, kSemi, B5, WAVE>;
  constexpr int A = B5 ? 5 : 4;
  constexpr int U = B5 ? 27 : 16;  // chars a text word
  constexpr int D = LaneT::D;
  const Args& g = a.g;
  __shared__ __align__(1024) uint32_t table[kThreads / 32][BPL * LaneT::kTable / 4];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t gid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int L = 1 << log2l;
  const int lb = static_cast<int>(gid & (L - 1));  // the lane in its pair
  const int64_t r0 = gid >> log2l;
  const bool live = r0 < g.rows;
  const int64_t r = live ? r0 : g.rows - 1;  // a lane past the last row reads the last and folds nothing

  // the lane's Eq planes into its column of the warp's region, from the parameters
#pragma unroll
  for (int i = 0; i < BPL; ++i) {
    const int b = lb * BPL + i;
    uint32_t* col = &table[warp][i * LaneT::kTable / 4 + lane];
#pragma unroll
    for (int k = 0; k < A; ++k) col[k * 32] = b < g.nb ? a.peq[k * g.nb + b] : 0u;
    if constexpr (B5) col[5 * 32] = col[0];  // digit 5 (a corrupt triplet) reads plane 0
  }
  __syncwarp();

  LaneT s;
  s.base = static_cast<uint32_t>(__cvta_generic_to_shared(&table[warp][lane]));
  s.width = L;
  const int32_t qlen = a.qlen;
  const int32_t m1 = qlen - 1;  // the entry point holds qlen to [1, 32 nb]
  const int hb = m1 >> 5;       // the score block
  s.slane = hb / BPL == lb;
#pragma unroll
  for (int i = 0; i < BPL; ++i) {
    s.pv[i] = 0xFFFFFFFFu;
    s.mv[i] = 0u;
    s.smul[i] = s.slane && hb % BPL == i ? 1u << (31 - (m1 & 31)) : 0u;
  }
#pragma unroll
  for (int k = 0; k < D; ++k) s.ring[k][0] = s.ring[k][1] = s.ring[k][2] = 0u;
  s.mult = lb ? 2u : 0u;
  s.first = lb ? 1u : 0u;
  s.padd = 0u;  // semiglobal: row 0's input is 0
  s.lag = static_cast<uint32_t>(D * lb);
  const int64_t cap = B5 ? (g.row_len / 2) * 27 : g.row_len * 16;
  const int64_t left = a.length - r * a.nt_per_row;
  s.jend = live ? static_cast<uint32_t>(left < cap ? (left > 0 ? left : 0) : cap) : 0u;
  s.score = s.best = qlen;
  s.best_end = 0;
  s.max_errors = 0;
  s.ends = nullptr;

  // word steps: [0, ga) fill, [ga, gb) every char of every lane inside its
  // row, [max(ga, gb), gc) drain; bounds are the warp's, so lanes stay converged
  const uint32_t jmin = __reduce_min_sync(kFull, s.jend), jmax = __reduce_max_sync(kFull, s.jend);
  const uint32_t fill = static_cast<uint32_t>(D * (L - 1));
  const uint32_t ga = (fill + U - 1) / U, gb = jmin / U;
  const uint32_t gc = static_cast<uint32_t>((static_cast<uint64_t>(jmax) + fill + U - 1) / U);
  const uint32_t* row = g.words + r * g.row_stride;
  const uint32_t avail = row_avail(g, r);
  auto word = [&](int64_t w) -> uint32_t {
    return static_cast<uint64_t>(w) < avail ? __ldg(row + w) : 0u;
  };

  if constexpr (!B5) {
    const uint32_t lagbits = 2u * s.lag, q = lagbits >> 5, rb = lagbits & 31u;
    uint32_t prev = word(-static_cast<int64_t>(q) - 1), cur = word(-static_cast<int64_t>(q));
    auto run = [&](auto check, uint32_t g0, uint32_t g1) {
      for (uint32_t w = g0; w < g1; ++w) {
        const uint32_t next = word(static_cast<int64_t>(w) + 1 - q);
        s.template word2<decltype(check)::value>(__funnelshift_l(prev, cur, rb), w * U - s.lag);
        prev = cur;
        cur = next;
      }
    };
    const uint32_t ga2 = ga < gc ? ga : gc;
    run(std::true_type{}, 0u, ga2);
    if (gb > ga) run(std::false_type{}, ga, gb);
    run(std::true_type{}, ga2 > gb ? ga2 : gb, gc);
  } else {
    const uint32_t q = static_cast<uint32_t>(lb) / 9u, sh = 7u * (static_cast<uint32_t>(lb) % 9u);
    auto pair = [&](int64_t w) -> uint64_t {
      return (static_cast<uint64_t>(word(2 * w + 1)) << 32) | word(2 * w);
    };
    uint64_t prev = pair(-static_cast<int64_t>(q) - 1) & 0x7FFFFFFFFFFFFFFFull, cur = pair(-static_cast<int64_t>(q));
    auto run = [&](auto check, uint32_t g0, uint32_t g1) {
      for (uint32_t w = g0; w < g1; ++w) {
        const uint64_t next = pair(static_cast<int64_t>(w) + 1 - q);
        s.template word5<decltype(check)::value>((cur << sh) | ((prev >> 1) >> (62 - sh)), w * U - s.lag);
        prev = cur & 0x7FFFFFFFFFFFFFFFull;
        cur = next;
      }
    };
    const uint32_t ga2 = ga < gc ? ga : gc;
    run(std::true_type{}, 0u, ga2);
    if (gb > ga) run(std::false_type{}, ga, gb);
    run(std::true_type{}, ga2 > gb ? ga2 : gb, gc);
  }

  // the row's key, the warp's least, one atomicMin
  unsigned long long key = ~0ull;
  if (live && s.slane) {
    const uint32_t end = s.best < qlen ? static_cast<uint32_t>(r * a.nt_per_row + s.best_end) : 0u;
    key = (static_cast<unsigned long long>(static_cast<uint32_t>(s.best)) << 32) | end;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long v = __shfl_xor_sync(kFull, key, o);
    key = v < key ? v : key;
  }
  if (lane == 0 && key != ~0ull) atomicMin(a.key, key);
}

// --- the launch plan -------------------------------------------------------

struct Plan {
  int lanes, bpl;  // lanes a pair, blocks a lane; bpl 0: the scratch form
};

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

constexpr int kCachedDevices = 64;  // devices whose SM count is read once

// The lanes of one warp a scheduler on the current device.
cudaError_t wave_lanes(int64_t* lanes) {
  static std::atomic<int> cached[kCachedDevices];
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev < kCachedDevices) sms = cached[dev].load(std::memory_order_relaxed);
  if (e == cudaSuccess && sms == 0) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess && dev < kCachedDevices) cached[dev].store(sms, std::memory_order_relaxed);
  }
  *lanes = static_cast<int64_t>(sms) * kSmLanes;
  return e;
}

Plan plan(int nb, int64_t rows, int64_t wave, int mode) {
  if (nb > kRegBlocks) return {1, 0};
  if (nb <= 1) return {1, 1};
#ifdef CN_MYERS_BPL  // a timing build (bench_myers.py): CN_MYERS_BPL blocks a lane at every batch size
  const int forced = pow2_at_least(nb) / CN_MYERS_BPL;
  return {forced > 1 ? forced : 1, CN_MYERS_BPL};
#endif
  if (nb == 2) return {1, 2};
  const int lanes = pow2_at_least(nb);
  // semiglobal: one block a lane stays ahead to two warps a scheduler (bench_myers.py sweep)
  const int64_t budget = mode == kSemi ? 2 * wave : wave;
  if (rows * lanes > budget) return {lanes / 2, 2};
  return {lanes, 1};
}

int log2i(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

template <int MODE, bool B5>
cudaError_t launch(const Args& g, cudaStream_t stream) {
  int64_t wave = 0;
  if (const cudaError_t e = wave_lanes(&wave); e != cudaSuccess) return e;
  const Plan p = plan(g.nb, g.rows, wave, MODE);
  const unsigned blocks = static_cast<unsigned>((g.rows * p.lanes + kThreads - 1) / kThreads);
  const int l2 = log2i(p.lanes);
  if (p.bpl == 0) myers_scratch<MODE, B5><<<blocks, kThreads, 0, stream>>>(g);
  else if (p.lanes == 1 && p.bpl == 1) myers_lanes<1, MODE, B5, false><<<blocks, kThreads, 0, stream>>>(g, 0);
  else if (p.lanes == 1) myers_lanes<2, MODE, B5, false><<<blocks, kThreads, 0, stream>>>(g, 0);
  else if (p.bpl == 1) myers_lanes<1, MODE, B5, true><<<blocks, kThreads, 0, stream>>>(g, l2);
  else myers_lanes<2, MODE, B5, true><<<blocks, kThreads, 0, stream>>>(g, l2);
  return cudaGetLastError();
}

template <bool B5>
cudaError_t launch_mode(int mode, const Args& g, cudaStream_t stream) {
  switch (mode) {
    case kGlobal: return launch<kGlobal, B5>(g, stream);
    case kSemi: return launch<kSemi, B5>(g, stream);
    case kPrefix: return launch<kPrefix, B5>(g, stream);
    default:
      if constexpr (B5) return cudaErrorInvalidValue;
      else return launch<kEnds, B5>(g, stream);
  }
}

template <bool B5>
cudaError_t launch_stream(const StreamArgs& a, cudaStream_t stream) {
  int64_t wave = 0;
  if (const cudaError_t e = wave_lanes(&wave); e != cudaSuccess) return e;
  const Plan p = plan(a.g.nb, a.g.rows, wave, kSemi);
  const unsigned blocks = static_cast<unsigned>((a.g.rows * p.lanes + kThreads - 1) / kThreads);
  const int l2 = log2i(p.lanes);
  if (p.lanes == 1 && p.bpl == 1) myers_stream<1, B5, false><<<blocks, kThreads, 0, stream>>>(a, 0);
  else if (p.lanes == 1) myers_stream<2, B5, false><<<blocks, kThreads, 0, stream>>>(a, 0);
  else if (p.bpl == 1) myers_stream<1, B5, true><<<blocks, kThreads, 0, stream>>>(a, l2);
  else myers_stream<2, B5, true><<<blocks, kThreads, 0, stream>>>(a, l2);
  return cudaGetLastError();
}

// --- the base-5 Peq build --------------------------------------------------
//
// peq_b5_kernel (entry point cn_peq_b5) replaces no Pallas kernel.  The JAX
// package builds a base-5 query's Peq with jnp: cute_nucleotides_tpu/ops/
// align.py:573 _unpack_digits_b5_t splits the triplets into digits and :605
// _peq_from_codes compares every digit with the five values, weights each row
// by its bit and sums.  The port ran that as eager torch ops (an int64 one-hot
// [B, 5, NB, 32] and its sum): about 10 ms for 1,048,576 queries of two words,
// 35 times the #19 scan that reads it (PERF.md).  It is not named myers_: the
// benchmark counts every device event with myers_ in its name as #19.
//
// Query b: Wq u32 (Wq / 2 u64 words, bit 63 in no triplet) from u32 b *
// q_stride; digit k of triplet j of word w, t - 5 (t * 205 >> 10), (t * 205 >>
// 10) - 5 (t * 41 >> 10) and t * 41 >> 10, is row 27 w + 3 j + k.  Peq[b]:
// u32[5][nb], nb = max(1, ceil(27 Wq / 2 / 32)); bit i % 32 of word i / 32 of
// plane c is set where row i is digit c and i < min(qlens[b], 27 Wq / 2).  A
// corrupt triplet's (125..127) digit 5 sets no plane.
//
// What bounds it: bytes.  A query reads Wq u32 and its length and writes
// 5 nb u32: 60 bytes at Wq = 4, 62.9 MB for 1,048,576 queries, 0.019 ms at
// 3.35 TB/s.  Its integer work is small but not nothing, and a first design
// that spent about twice this one's instructions (a 16-byte table entry a
// triplet, 64-bit accumulators, a block of 128 queries building its table for
// one tile) ran at 43% of the bound (PERF.md).  So nothing between the words
// and Peq goes through device memory, each Peq word is stored once, and a
// digit costs about one instruction:
// - a thread builds one query's Peq, loading its words 16 bytes at a time
//   where address, stride and Wq allow (4 bytes otherwise: 1% slower at the
//   adapter scan's shape, and 8-byte loads gained half of that);
// - a triplet is one LDS of a 128-entry table in shared memory, its three
//   digits sliced by bit (bit 10 i + k: bit i of digit k); three triplets add
//   into a group at bit 0, 3 and 6, so field i of a group holds bit i of its
//   nine digits, and shifts and masks join a word's three groups into its
//   three 27-bit slices;
// - the slices join the query's pending rows by funnel shifts; each full 32
//   rows give the five plane words by one logic op each on the three slices
//   (plane c: the rows whose bits spell c), after the rows at and past the
//   limit are set to 101, digit 5, which spells no plane;
// - a warp stages its 32 queries' Peq rows in shared memory and stores them as
//   one run of 16-byte stores, neighbouring lanes on neighbouring words, while
//   a row holds at most kPeqStaged blocks (queries of up to 256 nt; longer rows
//   store each word where it is made).  Stored where they were made, the rows
//   of 1,048,576 two-block queries took 2.7 times as long.
// - a block of kPeqThreads queries builds the table once and takes tiles of
//   queries in turn, and 12 blocks an SM cap a thread at 40 registers: capped
//   at 32 it spilled and ran 4% slower, at 96 (an earlier form's own choice)
//   19% slower.

constexpr int kPeqThreads = 128;  // queries a tile; also the table's triplets
constexpr int kPeqStaged = 8;     // blocks a Peq row may hold for its warp to stage it
// Blocks an SM holds (1536 threads, so at most 40 registers a thread); the
// grid is as many as the card holds, each block taking tiles in turn.
constexpr int kPeqSmBlocks = 12;

// Triplet t's digits sliced by bit: bit 10 i + k holds bit i of digit k.
__device__ __forceinline__ uint32_t digit_slices(uint32_t t) {
  const uint32_t q5 = (t * 205u) >> 10, q25 = (t * 41u) >> 10;
  const uint32_t d[3] = {t - 5u * q5, q5 - 5u * q25, q25};
  uint32_t e = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) e |= ((d[k] * 0x40201u) & 0x100401u) << k;  // bits 0, 1, 2 of d to 0, 10, 20
  return e;
}

// V: u32 a load (4 or 1).
template <int V>
__global__ void __launch_bounds__(kPeqThreads, kPeqSmBlocks)
    peq_b5_kernel(const uint32_t* __restrict__ q, int64_t q_stride, int wq, const int32_t* __restrict__ qlens,
                  int64_t rows, int nb, uint32_t* __restrict__ peq) {
  __shared__ uint32_t table[128];
  extern __shared__ uint4 tile4[];  // staged: [warp][32 queries][5 nb] u32
  table[threadIdx.x] = digit_slices(threadIdx.x);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row_u32 = 5 * nb;
  const bool staged = nb <= kPeqStaged;
  uint32_t* const tile = reinterpret_cast<uint32_t*>(tile4) + 32 * warp * row_u32;
  const int have = 27 * (wq / 2);
  const int64_t tiles = (rows + kPeqThreads - 1) / kPeqThreads;
  for (int64_t at = blockIdx.x; at < tiles; at += gridDim.x) {
    const int64_t r0 = at * kPeqThreads + 32 * warp;  // the warp's first query
    const int64_t r = r0 + lane;
    const bool live = r < rows;  // a dead lane runs the warp's loop on zero words and stores nothing
    uint32_t* const out = staged ? tile + lane * row_u32 : peq + r * row_u32;
    const int32_t qlen = live ? qlens[r] : 0;
    const int32_t lim = qlen < have ? qlen : have;  // rows that count; may be negative
    const uint32_t* const row = q + (live ? r : 0) * q_stride;

    uint32_t p0 = 0, p1 = 0, p2 = 0;  // slices of the rows from 32 b on, `fill` of them made
    int fill = 0, b = 0;
    auto emit = [&](uint32_t s0, uint32_t s1, uint32_t s2) {
      int32_t n = lim - 32 * b;
      n = n < 0 ? 0 : n > 32 ? 32 : n;
      const uint32_t past = __funnelshift_lc(0u, 0xFFFFFFFFu, n);  // rows at and past the limit
      s0 |= past;  // which then spell 101, digit 5: no plane
      s1 &= ~past;
      s2 |= past;
      if (staged || live) {
        out[b] = ~s0 & ~s1 & ~s2;
        out[nb + b] = s0 & ~s1 & ~s2;
        out[2 * nb + b] = ~s0 & s1 & ~s2;
        out[3 * nb + b] = s0 & s1 & ~s2;
        out[4 * nb + b] = ~s0 & ~s1 & s2;
      }
      ++b;
    };
    auto word = [&](uint32_t lo, uint32_t hi) {
      auto at3 = [&](uint32_t x) { return table[x & 0x7Fu]; };
      // three triplets a group: field i (bits 10 i .. 10 i + 8) holds bit i of their nine digits
      const uint32_t g0 = at3(lo) + (at3(lo >> 7) << 3) + (at3(lo >> 14) << 6);
      const uint32_t g1 = at3(lo >> 21) + (at3(__funnelshift_r(lo, hi, 28)) << 3) + (at3(hi >> 3) << 6);
      const uint32_t g2 = at3(hi >> 10) + (at3(hi >> 17) << 3) + (at3(hi >> 24) << 6);
      // the word's 27 rows: bit 9 m + j of slice i is field i of group m, bit j
      const uint32_t s0 = (g0 & 0x1FFu) | ((g1 << 9) & 0x3FE00u) | ((g2 << 18) & 0x7FC0000u);
      const uint32_t s1 = ((g0 >> 10) & 0x1FFu) | ((g1 >> 1) & 0x3FE00u) | ((g2 << 8) & 0x7FC0000u);
      const uint32_t s2 = ((g0 >> 20) & 0x1FFu) | ((g1 >> 11) & 0x3FE00u) | ((g2 >> 2) & 0x7FC0000u);
      if (fill >= 5) {  // 27 rows a word: at most one block ends in it
        emit(p0 | (s0 << fill), p1 | (s1 << fill), p2 | (s2 << fill));
        p0 = __funnelshift_l(s0, 0u, fill);
        p1 = __funnelshift_l(s1, 0u, fill);
        p2 = __funnelshift_l(s2, 0u, fill);
        fill -= 5;
      } else {
        p0 |= s0 << fill;
        p1 |= s1 << fill;
        p2 |= s2 << fill;
        fill += 27;
      }
    };
    if constexpr (V == 4) {
      for (int k = 0; k < wq; k += 4) {
        const uint4 v = live ? __ldg(reinterpret_cast<const uint4*>(row + k)) : make_uint4(0u, 0u, 0u, 0u);
        word(v.x, v.y);
        word(v.z, v.w);
      }
    } else {
      for (int k = 0; k < wq; k += 2) word(live ? __ldg(row + k) : 0u, live ? __ldg(row + k + 1) : 0u);
    }
    while (b < nb) {  // the last, partial block (rows past 27 Wq / 2 are empty)
      emit(p0, p1, p2);
      p0 = p1 = p2 = 0;
    }

    if (staged) {  // the warp's queries' rows: one run of words
      __syncwarp();
      const int64_t left = rows - r0;
      const int count = left <= 0 ? 0 : (left >= 32 ? 32 : static_cast<int>(left)) * row_u32;
      const uint4* const src = reinterpret_cast<const uint4*>(tile);  // 16-byte aligned: 640 nb bytes a warp
      uint4* const dst = reinterpret_cast<uint4*>(peq + r0 * row_u32);
      for (int e = lane; e < count / 4; e += 32) dst[e] = src[e];
      for (int e = 4 * (count / 4) + lane; e < count; e += 32) peq[r0 * row_u32 + e] = tile[e];  // a last warp's tail
      __syncwarp();
    }
  }
}

template <int V>
cudaError_t launch_peq(const uint32_t* q, int64_t q_stride, int wq, const int32_t* qlens, int64_t rows, int nb,
                       uint32_t* peq, cudaStream_t stream) {
  int64_t wave = 0;
  if (const cudaError_t e = wave_lanes(&wave); e != cudaSuccess) return e;
  const int64_t tiles = (rows + kPeqThreads - 1) / kPeqThreads;
  const int64_t most = wave / kSmLanes * kPeqSmBlocks;
  const unsigned blocks = static_cast<unsigned>(tiles < most ? tiles : most);
  const size_t tile = nb <= kPeqStaged ? sizeof(uint32_t) * kPeqThreads * 5 * nb : 0;
  peq_b5_kernel<V><<<blocks, kPeqThreads, tile, stream>>>(q, q_stride, wq, qlens, rows, nb, peq);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Row r of `rows`: query Peq u32[A, nb] at peq + r * peq_stride (A = 4, or 5
// with b5), length qlens[r]; text row_len u32 from u32 r * row_stride of
// words[n_words], length tlens[r].  Writes score[r] (mode 0), best[r] and
// best_end[r] (modes 1 and 2) or the u8 ends rows (mode 3, 2-bit only).
// scratch: 2 * nb * rows u32, required when nb > 8 and used past 32 blocks.
int cn_myers(const void* peq, int64_t peq_stride, int nb, const void* qlens, const void* words, int64_t n_words,
             int64_t row_stride, int64_t row_len, const void* tlens, const void* max_errors, int mode, int b5,
             int64_t rows, void* score, void* best, void* best_end, void* ends, void* scratch, void* stream) {
  if (rows < 0 || nb < 0 || peq_stride < 0 || n_words < 0 || row_stride < 0 || row_len < 0 || mode < kGlobal ||
      mode > kEnds || (mode == kEnds && b5) || (b5 && (row_len % 2 || row_stride % 2)) ||
      (nb > 8 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  Args g{static_cast<const uint32_t*>(peq), peq_stride, nb, static_cast<const int32_t*>(qlens),
         static_cast<const uint32_t*>(words), n_words, row_stride, row_len, static_cast<const int32_t*>(tlens),
         static_cast<const int32_t*>(max_errors), rows, static_cast<int32_t*>(score),
         static_cast<int32_t*>(best), static_cast<int32_t*>(best_end), static_cast<uint8_t*>(ends),
         static_cast<uint32_t*>(scratch)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(b5 ? launch_mode<true>(mode, g, s) : launch_mode<false>(mode, g, s));
}

// The launch plan for nb blocks, `rows` pairs and `mode` on the current
// device: out[0] lanes a pair, out[1] blocks a lane (0: the scratch form).
int cn_myers_plan(int nb, int64_t rows, int mode, int* out) {
  int64_t wave = 0;
  const cudaError_t e = wave_lanes(&wave);
  const Plan p = plan(nb, rows, wave, mode);
  out[0] = p.lanes;
  out[1] = p.bpl;
  return static_cast<int>(e);
}

// The stream form (its section above): `rows` rows of row_len u32 every
// row_stride u32 of words[n_words], a stream of `length` nt (under 2^31), all
// against one query of qlen nt (1 to 32 nb) whose Peq, A planes of nb u32 (A =
// 4, or 5 with b5; nb at most 32), is read from host memory at peq.  On CUDA
// device `device` and `stream`: sets the u64 at key to all ones, then folds
// every row's semiglobal (best, first end) into it as (best << 32) | global
// end.  The current device is restored before it returns.
int cn_myers_stream(const void* peq, int nb, int qlen, const void* words, int64_t n_words, int64_t row_stride,
                    int64_t row_len, int64_t length, int b5, int64_t rows, void* key, int device, void* stream) {
  if (rows < 1 || nb < 1 || nb > kRegBlocks || qlen < 1 || qlen > 32 * nb || n_words < 0 || row_stride < 0 ||
      row_len < row_stride || length < 0 || length >= (int64_t{1} << 31) || (b5 && (row_len % 2 || row_stride % 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  StreamArgs a{};
  a.g.words = static_cast<const uint32_t*>(words);
  a.g.n_words = n_words;
  a.g.row_stride = row_stride;
  a.g.row_len = row_len;
  a.g.rows = rows;
  a.g.nb = nb;
  a.length = length;
  a.nt_per_row = b5 ? (row_stride / 2) * 27 : row_stride * 16;
  a.qlen = qlen;
  a.key = static_cast<unsigned long long*>(key);
  std::memcpy(a.peq, peq, sizeof(uint32_t) * (b5 ? 5 : 4) * nb);
  int current = device;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (e == cudaSuccess) e = cudaMemsetAsync(key, 0xFF, sizeof(unsigned long long), s);
  if (e == cudaSuccess) e = b5 ? launch_stream<true>(a, s) : launch_stream<false>(a, s);
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(e);
}

// The base-5 Peq of `rows` packed queries (the Peq section above): query b's
// wq u32 at qwords + b * q_stride (wq even, at most 2^26; q_stride 0: one
// query for every row), its length qlens[b]; writes peq u32[rows][5][nb], nb
// = max(1, ceil(27 wq / 2 / 32)), which the caller allocates 16-byte aligned.
int cn_peq_b5(const void* qwords, int64_t q_stride, int wq, const void* qlens, int64_t rows, int nb, void* peq,
              void* stream) {
  const int64_t need = (27 * static_cast<int64_t>(wq / 2) + 31) / 32;
  if (rows < 0 || q_stride < 0 || wq < 0 || wq % 2 || wq > (1 << 26) || nb != (need > 1 ? need : 1) ||
      reinterpret_cast<uintptr_t>(peq) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const auto* q = static_cast<const uint32_t*>(qwords);
  const auto* ql = static_cast<const int32_t*>(qlens);
  auto* out = static_cast<uint32_t*>(peq);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto at = reinterpret_cast<uintptr_t>(q);
  if (at % 16 == 0 && q_stride % 4 == 0 && wq % 4 == 0)
    return static_cast<int>(launch_peq<4>(q, q_stride, wq, ql, rows, nb, out, s));
  return static_cast<int>(launch_peq<1>(q, q_stride, wq, ql, rows, nb, out, s));
}

}  // extern "C"
