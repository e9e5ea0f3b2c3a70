// Myers bit-vector edit-distance scan for Hopper (sm_90a), plain C interface.
//
// Replaces the word scans of cute_nucleotides_tpu/ops/align.py:
// _myers_scan_words (:336, 2-bit text) and _myers_scan_words_b5 (:385, base-5
// text).  Those are no Pallas kernels: each is one XLA while-loop (lax.scan)
// over the text words, every step advancing all B pairs' DP columns as
// (B,) u32 vectors, one pair per VPU lane.  Here one (query, text) pair is one
// thread, and its whole state lives in registers: PV and MV as one u32 per
// 32-row block, the score, the best score and its first end.  A text char is
// Hyyro's recurrence on each block, the adder carry and the two shift-out
// bits passed from block to block within the step (align.py:_scan_setup
// :279-313); the 64-bit sum a + p + cin gives the carry the reference derives
// from (s < a) | (s == a & cin).
//
// Text, row r: row_len u32 starting at u32 r * row_stride of one flat stream,
// zeros past its end (n_words).  A batch u32[R, Wt] is row_stride = row_len =
// Wt; a long stream split into rows with a halo (best_match_stream) is
// row_stride = wrb, row_len = wrb + H, so no panel of overlapping rows is
// built.  2-bit: 16 codes a u32, LSB first.  Base-5: a u32 pair is one u64
// word of 9 triplets of 7 bits (bit 63 in none), each split into 3 digits by
// the exact multiply-shifts t * 205 >> 10 (t / 5) and t * 41 >> 10 (t / 25).
// A corrupt triplet (125..127) gives digit 5, which selects plane 0 (it reads
// as A): the reference's Eq defaults to plane 0 (align.py:274-278).
//
// Peq, row r: A planes of nb u32 at peq + r * peq_stride; peq_stride 0 is
// one query broadcast to every row (the CLI's form), read through the cache.
// The register forms hold NB = 1, 2, 4 or 8 blocks (queries up to 256 nt) and
// pad blocks past nb with a zero Peq: carries run upward only and the score
// reads block hb, so a padded block changes nothing.  Eq is an A-way select on
// the text code, never a register array indexed at run time.  Longer queries
// take the generic form, PV and MV in a global scratch laid out [nb][rows]
// (coalesced across a warp), Peq read from global memory by address.
//
// Modes: 0 global (row 0's input +1, the final score), 1 semiglobal (input 0,
// the best score and its first end), 2 prefix (input +1, the best), 3 ends
// (semiglobal; writes score <= max_errors[r] for every position j < tlens[r]
// into a u8 row of row_len * 16 columns, which the caller zeroes).  A row
// stops at its own min(tlens[r], capacity): the reference freezes its state
// there, so nothing after it changes an output.  Base-5 has no ends mode.
//
// Bound: integer issue.  The least a text char needs is 11 instructions a
// block (one to fetch Eq, the two-instruction adder, Xh, Ph, Mh, the two
// funnel shifts, Xv and the new PV and MV) and a few a char for the decode,
// the score bit and the best (utils/profiling.py:myers_ops); this form
// spends A - 1 selects a block on Eq.  Every pair's chars run in sequence in
// one thread, so a batch of B pairs is B threads: the bench's 8192 pairs are
// 256 warps, about two an SM (one for every other scheduler), too few to
// hide the dependent chain's latency.  This first form aims at being right;
// PERF.md has its time beside the bound.
//
// The entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kGlobal = 0, kSemi = 1, kPrefix = 2, kEnds = 3;

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
  int mode;
  int64_t rows;
  int32_t* score;
  int32_t* best;
  int32_t* best_end;
  uint8_t* ends;
  uint32_t* scratch;
};

// per-row state shared by both forms
struct Row {
  int32_t score, best, best_end, max_errors;
  int hb;
  uint32_t hmask;
  uint32_t phin0;
  bool track, emit;
  uint8_t* ends;
};

__device__ __forceinline__ void after_step(Row& s, uint32_t dp, uint32_t dm, int64_t j) {
  s.score += (dp != 0u) - (dm != 0u);
  if (s.track && s.score < s.best) {
    s.best = s.score;
    s.best_end = static_cast<int32_t>(j + 1);
  }
  if (s.emit) s.ends[j] = s.score <= s.max_errors;
}

// Hyyro's step on one 32-row block: Eq e, the block's PV p and MV m (updated
// in place), the adder carry and the two shift-out bits from the block below
// (updated for the block above); returns Ph and Mh for the score bit.
struct Carry {
  uint32_t cin, phin, mhin;
};

__device__ __forceinline__ void block_step(uint32_t e, uint32_t& p, uint32_t& m, Carry& c, uint32_t& ph,
                                           uint32_t& mh) {
  const uint32_t xv = e | m, a = e & p;
  const uint64_t sum = static_cast<uint64_t>(a) + p + c.cin;
  const uint32_t sm = static_cast<uint32_t>(sum);
  c.cin = static_cast<uint32_t>(sum >> 32);
  const uint32_t xh = (sm ^ p) | e;
  ph = m | ~(xh | p);
  mh = p & xh;
  const uint32_t ps = (ph << 1) | c.phin, ms = (mh << 1) | c.mhin;
  c.phin = ph >> 31;
  c.mhin = mh >> 31;
  p = ms | ~(xv | ps);
  m = ps & xv;
}

// One text char through NB register blocks.
template <int NB, int A>
struct RegState {
  uint32_t peq[A][NB];
  uint32_t pv[NB], mv[NB];

  __device__ __forceinline__ void step(Row& s, uint32_t c, int64_t j) {
    Carry cr{0u, s.phin0, 0u};
    uint32_t dp = 0, dm = 0;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      uint32_t e = peq[0][b];
#pragma unroll
      for (int k = 1; k < A; ++k) e = c == static_cast<uint32_t>(k) ? peq[k][b] : e;
      uint32_t ph, mh;
      block_step(e, pv[b], mv[b], cr, ph, mh);
      if (b == s.hb) {
        dp = ph & s.hmask;
        dm = mh & s.hmask;
      }
    }
    after_step(s, dp, dm, j);
  }
};

// The generic form: PV and MV in scratch [nb][rows], Peq from global memory.
struct ScratchState {
  const uint32_t* peq;
  uint32_t* pv;
  uint32_t* mv;
  int64_t rows;
  int nb, A;

  __device__ __forceinline__ void step(Row& s, uint32_t c, int64_t j) {
    const uint32_t* eq = peq + static_cast<int64_t>(c < static_cast<uint32_t>(A) ? c : 0u) * nb;
    Carry cr{0u, s.phin0, 0u};
    uint32_t dp = 0, dm = 0;
    for (int b = 0; b < nb; ++b) {
      const int64_t at = b * rows;
      uint32_t p = pv[at], m = mv[at], ph, mh;
      block_step(__ldg(eq + b), p, m, cr, ph, mh);
      pv[at] = p;
      mv[at] = m;
      if (b == s.hb) {
        dp = ph & s.hmask;
        dm = mh & s.hmask;
      }
    }
    after_step(s, dp, dm, j);
  }
};

// Feed row r's text, char by char, to st.step until position jend.
template <bool B5, class State>
__device__ __forceinline__ void scan_text(const Args& g, int64_t r, int64_t jend, Row& s, State& st) {
  const int64_t base = r * g.row_stride;
  int64_t j = 0;
  if (!B5) {
    for (int64_t w = 0; j < jend; ++w) {
      const int64_t at = base + w;
      const uint32_t word = at < g.n_words ? __ldg(g.words + at) : 0u;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        if (j >= jend) break;
        st.step(s, (word >> (2 * k)) & 3u, j);
        ++j;
      }
    }
  } else {
    for (int64_t w = 0; j < jend; ++w) {
      const int64_t at = base + 2 * w;
      const uint32_t lo = at < g.n_words ? __ldg(g.words + at) : 0u;
      const uint32_t hi = at + 1 < g.n_words ? __ldg(g.words + at + 1) : 0u;
      const uint64_t pair = static_cast<uint64_t>(lo) | (static_cast<uint64_t>(hi) << 32);
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const uint32_t t = static_cast<uint32_t>(pair >> (7 * k)) & 0x7Fu;
        const uint32_t q5 = (t * 205u) >> 10, q25 = (t * 41u) >> 10;
        const uint32_t digit[3] = {t - 5u * q5, q5 - 5u * q25, q25};
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          if (j >= jend) break;
          st.step(s, digit[d], j);
          ++j;
        }
      }
    }
  }
}

// NB > 0: registers; NB == 0: the generic scratch form.
template <int NB, bool B5>
__global__ void __launch_bounds__(kThreads) myers_kernel(const Args g) {
  constexpr int A = B5 ? 5 : 4;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= g.rows) return;
  const int32_t qlen = g.qlens[r];
  const int32_t m1 = (qlen > 1 ? qlen : 1) - 1;
  Row s;
  s.score = s.best = qlen;
  s.best_end = 0;
  s.hb = m1 >> 5;
  s.hmask = s.hb < g.nb ? 1u << (m1 & 31) : 0u;  // no score bit when the query outruns its blocks
  s.phin0 = g.mode == kSemi || g.mode == kEnds ? 0u : 1u;
  s.track = g.mode == kSemi || g.mode == kPrefix;
  s.emit = g.mode == kEnds;
  s.max_errors = s.emit ? g.max_errors[r] : 0;
  s.ends = s.emit ? g.ends + r * (g.row_len * 16) : nullptr;
  const int64_t cap = B5 ? (g.row_len / 2) * 27 : g.row_len * 16;
  const int64_t tlen = g.tlens[r];
  const int64_t jend = tlen < cap ? (tlen > 0 ? tlen : 0) : cap;
  const uint32_t* peq = g.peq + r * g.peq_stride;
  if constexpr (NB > 0) {
    RegState<NB, A> st;
#pragma unroll
    for (int k = 0; k < A; ++k)
#pragma unroll
      for (int b = 0; b < NB; ++b) st.peq[k][b] = b < g.nb ? __ldg(peq + k * g.nb + b) : 0u;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      st.pv[b] = 0xFFFFFFFFu;
      st.mv[b] = 0u;
    }
    scan_text<B5>(g, r, jend, s, st);
  } else {
    ScratchState st{peq, g.scratch + r, g.scratch + g.nb * g.rows + r, g.rows, g.nb, A};
    for (int b = 0; b < g.nb; ++b) {
      st.pv[b * g.rows] = 0xFFFFFFFFu;
      st.mv[b * g.rows] = 0u;
    }
    scan_text<B5>(g, r, jend, s, st);
  }
  if (g.score) g.score[r] = s.score;
  if (g.best) {
    g.best[r] = s.best;
    g.best_end[r] = s.best_end;
  }
}

template <bool B5>
cudaError_t launch(const Args& g, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((g.rows + kThreads - 1) / kThreads);
  if (g.nb <= 1) myers_kernel<1, B5><<<blocks, kThreads, 0, stream>>>(g);
  else if (g.nb <= 2) myers_kernel<2, B5><<<blocks, kThreads, 0, stream>>>(g);
  else if (g.nb <= 4) myers_kernel<4, B5><<<blocks, kThreads, 0, stream>>>(g);
  else if (g.nb <= 8) myers_kernel<8, B5><<<blocks, kThreads, 0, stream>>>(g);
  else myers_kernel<0, B5><<<blocks, kThreads, 0, stream>>>(g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Row r of `rows`: query Peq u32[A, nb] at peq + r * peq_stride (A = 4, or 5
// with b5), length qlens[r]; text row_len u32 from u32 r * row_stride of
// words[n_words], length tlens[r].  Writes score[r] (mode 0), best[r] and
// best_end[r] (modes 1 and 2) or the u8 ends rows (mode 3, 2-bit only).
// scratch: 2 * nb * rows u32 when nb > 8, else unused.
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
         static_cast<const int32_t*>(max_errors), mode, rows, static_cast<int32_t*>(score),
         static_cast<int32_t*>(best), static_cast<int32_t*>(best_end), static_cast<uint8_t*>(ends),
         static_cast<uint32_t*>(scratch)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(b5 ? launch<true>(g, s) : launch<false>(g, s));
}

}  // extern "C"
