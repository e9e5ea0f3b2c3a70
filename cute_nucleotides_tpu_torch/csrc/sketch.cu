// Sketch kernels for Hopper (sm_90a), plain C interface.
//
// Both read a packed 2-bit stream (16 nt per u32 word, 2 bits per nt,
// LSB-first; words past the stream read as 0) and hash k-mers with Murmur3
// fmix32 of their code, canonical (the lesser of the code and its reverse
// complement) when asked.
//
// Planar k-mer hashes, 16 <= k <= 31 (replaces cute_nucleotides_tpu/ops/
// kmer.py:kmer_hashes_planar, the inline pallas_call of
// _hashes_planar_pair_kernel).  The stream is cut into rows of `width` words;
// the 2k-bit code at nt 16i + s is the window at bit 2s of words i, i+1, i+2,
// where the two successors are 0 past the end of word i's segment (`seg`
// words: one read of a batch, or the whole stream).  Its hash
// fmix32(lo ^ fmix32(hi)) lands at column width*s + (i mod width) of row
// i / width (planar order), or 0xFFFFFFFF where 16i + s >= n_valid.  One
// thread per word reads its three words straight from the stream (the TPU
// kernel's successor panels were copies) and writes 16 hashes, each store
// one coalesced line per warp.  The reverse complement is taken once per
// thread, of all 48 nt of its three words, and shifted down by 64 - 2k: the
// reverse complement of the k-mer at shift s is then two funnel shifts and
// a mask, like its forward code, and the fold is a native unsigned 64-bit
// compare.  About 28 integer instructions per position (16 of them the two
// fmix32) against 4 bytes written; only a thread whose word holds n_valid
// selects per position.
//
// Minimizer bits, k <= 15, 1 <= w - 1 <= 2048 - k (replaces
// cute_nucleotides_tpu/ops/pallas_kernels.py:minimizer_bits_panels, whose
// sixteen s-planes of 1280-lane panels stood in for the lane shift a TPU
// lacks).  Position p (< n) is flagged iff its hash is the least of some
// window of w hashes starting in [0, n - w]: with wm[j] = min(h[j..j+w-1])
// for such starts j (0 elsewhere), iff h[p] == max(wm[p-w+1..p]).  A block
// of T threads (256 while the halo is at most 256 nt, else 1024) covers 8 T
// positions: its own span of 8 T - 2 halo and a halo of w - 1 nt, rounded
// up to whole words, on each side.  Thread i holds positions 8 i .. 8 i + 7
// in registers, hashed from the one word they share and the next.  Both
// windowed extremes come by doubling (a sparse table): with a = floor(log2
// w), a passes of m[t] <- min(m[t], m[t + 2^i]) leave the least of the 2^a
// hashes from t, and wm[t] = min(m[t], m[t + w - 2^a]); the same backward
// with max gives the windows that hold t.  A pass at an offset below 8
// stays in registers, taking the values past a thread's 8 from the next
// lane by a shuffle and across a warp's edge through shared memory; a pass
// at an offset of 8 or more, and each join at w - 2^a, trades whole
// threads' values through shared memory (two 16-byte stores and loads a
// thread).  No pass divides or carries a value from one step to the next,
// so every position costs the same few instructions a pass.  There are
// 2 a + 2 passes, each behind one barrier: 8 at w = 10, 6 of them in
// registers; the cost grows with log2 w (22 passes at w = 1024).  An even
// thread and the next hold the 16 flags of one output word.  A 256-thread
// block is held to 32 registers (16 B of stack), so that 8 fit an SM; at
// its free 48 registers 5 fit, and took 0.7% longer at w = 10 (PERF.md).
// Bound by integer work (the hash and the passes); 4 bytes read and 4
// written per 16 positions.
//
// Every entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kHashThreads = 256;
constexpr int kMzPer = 8;              // positions a minimizer thread holds in registers
constexpr int kMzNarrowThreads = 256;  // 2048 positions with the halos, for halos up to kMzNarrowHalo
constexpr int kMzWideThreads = 1024;   // 8192 positions with the halos
constexpr int kMzNarrowHalo = 256;
constexpr uint32_t kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// Reverse the order of the 2-bit fields: reverse the bits, then swap the two
// bits of each field back.
__device__ __forceinline__ uint32_t rev_fields32(uint32_t x) {
  x = __brev(x);
  return ((x >> 1) & 0x55555555u) | ((x & 0x55555555u) << 1);
}

// The hashes of the 16 k-mers that start in word a (successors b, c) to
// o[0], o[width], ..., o[15 width]; with kTail, 0xFFFFFFFF at the shifts
// s >= n_left.
template <bool kCanonical, bool kTail>
__device__ __forceinline__ void hash_word(uint32_t a, uint32_t b, uint32_t c, int k, uint32_t* o, int64_t width,
                                          int64_t n_left) {
  const uint32_t hi_mask = (1u << (2 * k - 32)) - 1u;  // 0 at k = 16
  // X = c:b:a holds 48 nt, a's first nt in the low bits.  r2:r1:r0 is the
  // reverse complement of X (complement: xor 2 per field) shifted down by
  // 64 - 2k, so the reverse complement of the k-mer at shift s (fields s ..
  // s + k - 1 of X) is its 64-bit window at bit 32 - 2s, masked to 2k bits.
  uint32_t r0 = 0, r1 = 0, r2 = 0;
  if (kCanonical) {
    const int rsh = 64 - 2 * k;  // in [2, 32]; the funnel shifts clamp 32 to a whole word
    const uint32_t x0 = rev_fields32(c ^ 0xAAAAAAAAu), x1 = rev_fields32(b ^ 0xAAAAAAAAu);
    const uint32_t x2 = rev_fields32(a ^ 0xAAAAAAAAu);
    r0 = __funnelshift_rc(x0, x1, rsh);
    r1 = __funnelshift_rc(x1, x2, rsh);
    r2 = __funnelshift_rc(x2, 0u, rsh);
  }
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    uint64_t code = (static_cast<uint64_t>(__funnelshift_r(b, c, 2 * s) & hi_mask) << 32) |
                    __funnelshift_r(a, b, 2 * s);
    if (kCanonical) {
      const uint64_t rc = (static_cast<uint64_t>(__funnelshift_rc(r1, r2, 32 - 2 * s) & hi_mask) << 32) |
                          __funnelshift_rc(r0, r1, 32 - 2 * s);
      code = rc < code ? rc : code;
    }
    const uint32_t h = fmix32(static_cast<uint32_t>(code) ^ fmix32(static_cast<uint32_t>(code >> 32)));
    o[s * width] = (!kTail || s < n_left) ? h : 0xFFFFFFFFu;
  }
}

template <bool kCanonical>
__global__ void __launch_bounds__(kHashThreads)
kmer_hashes_pair_kernel(const uint32_t* __restrict__ words, int64_t n_words, int64_t seg, int64_t width,
                        int64_t total, int64_t n_valid, int k, uint32_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kHashThreads + threadIdx.x;
  if (i >= total) return;
  const int64_t j = i % seg;  // word i's place in its segment
  const uint32_t a = i < n_words ? __ldg(words + i) : 0u;
  const uint32_t b = (i + 1 < n_words && j + 1 < seg) ? __ldg(words + i + 1) : 0u;
  const uint32_t c = (i + 2 < n_words && j + 2 < seg) ? __ldg(words + i + 2) : 0u;
  uint32_t* o = out + 15 * width * (i / width) + i;  // row r starts at 16 width r; column i - width r
  const int64_t n_left = n_valid - 16 * i;           // valid shifts of word i
  if (n_left >= 16)
    hash_word<kCanonical, false>(a, b, c, k, o, width, n_left);
  else
    hash_word<kCanonical, true>(a, b, c, k, o, width, n_left);
}

// Shared bytes of a minimizer block of kThreads threads: two double-buffered
// planes of every thread's 8 values, two edge buffers of 8 values a warp,
// and the words of its positions and one more.
template <int kThreads>
constexpr int mz_smem() {
  return 2 * 2 * kThreads * 16 + 2 * (kThreads / 32) * kMzPer * 4 + (kMzPer * kThreads / 16 + 1) * 4;
}

// Thread i's 8 values to plane buffer b, then a barrier.
template <int kThreads>
__device__ __forceinline__ void mz_put(uint4* planes, int b, const uint32_t (&v)[kMzPer]) {
  planes[2 * b * kThreads + threadIdx.x] = make_uint4(v[0], v[1], v[2], v[3]);
  planes[(2 * b + 1) * kThreads + threadIdx.x] = make_uint4(v[4], v[5], v[6], v[7]);
  __syncthreads();
}

// Thread src's 8 values from plane buffer b to u[o .. o + 7]; ident past
// the block's threads.
template <int kThreads, int kLen>
__device__ __forceinline__ void mz_get(const uint4* planes, int b, int src, uint32_t ident, uint32_t (&u)[kLen],
                                       int o) {
  uint4 x = make_uint4(ident, ident, ident, ident), y = x;
  if (src >= 0 && src < kThreads) {
    x = planes[2 * b * kThreads + src];
    y = planes[(2 * b + 1) * kThreads + src];
  }
  u[o] = x.x, u[o + 1] = x.y, u[o + 2] = x.z, u[o + 3] = x.w;
  u[o + 4] = y.x, u[o + 5] = y.y, u[o + 6] = y.z, u[o + 7] = y.w;
}

// One doubling pass at an offset kO below 8, in registers: forward (min),
// v[j] <- min(v[j], value at j + kO); backward (max), v[j] <- max(v[j], value
// at j - kO).  The values past a thread's 8 come from its neighbour lane by
// a shuffle, and across a warp's edge through edge buffer b.
template <int kThreads, int kO, bool kForward>
__device__ __forceinline__ void mz_shuffle_pass(uint32_t (&v)[kMzPer], uint32_t* edges, int b) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* e = edges + b * kWarps * kMzPer;
  uint32_t x[kO];
  if (kForward) {
    if (lane == 0)
#pragma unroll
      for (int j = 0; j < kO; ++j) e[warp * kMzPer + j] = v[j];
#pragma unroll
    for (int j = 0; j < kO; ++j) x[j] = __shfl_down_sync(kFull, v[j], 1);
    __syncthreads();
    if (lane == 31)
#pragma unroll
      for (int j = 0; j < kO; ++j) x[j] = warp + 1 < kWarps ? e[(warp + 1) * kMzPer + j] : 0xFFFFFFFFu;
#pragma unroll
    for (int j = 0; j < kMzPer; ++j) v[j] = min(v[j], j + kO < kMzPer ? v[j + kO] : x[j + kO - kMzPer]);
  } else {
    if (lane == 31)
#pragma unroll
      for (int j = 0; j < kO; ++j) e[warp * kMzPer + j] = v[kMzPer - kO + j];
#pragma unroll
    for (int j = 0; j < kO; ++j) x[j] = __shfl_up_sync(kFull, v[kMzPer - kO + j], 1);
    __syncthreads();
    if (lane == 0)
#pragma unroll
      for (int j = 0; j < kO; ++j) x[j] = warp > 0 ? e[(warp - 1) * kMzPer + j] : 0u;
#pragma unroll
    for (int j = kMzPer - 1; j >= 0; --j) v[j] = max(v[j], j >= kO ? v[j - kO] : x[j]);
  }
}

template <int kThreads, bool kCanonical>
__global__ void __launch_bounds__(kThreads, kThreads == kMzNarrowThreads ? 8 : 1)
minimizer_kernel(const uint32_t* __restrict__ words, int64_t n_words, int64_t n, int k, int w, int halo,
                 uint32_t* __restrict__ out, int64_t n_out) {
  constexpr int kN = kMzPer * kThreads;  // positions of the span, halos included
  constexpr int kWarps = kThreads / 32;
  extern __shared__ uint4 smem4[];
  uint4* planes = smem4;                                                // [2][2][kThreads]
  uint32_t* edges = reinterpret_cast<uint32_t*>(smem4 + 4 * kThreads);  // [2][kWarps][8]
  uint32_t* ws = edges + 2 * kWarps * kMzPer;                           // [kN / 16 + 1]
  const int tid = threadIdx.x;
  const int span = kN - 2 * halo;                               // own positions, a multiple of 16
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * span;  // first own position
  const int64_t t0 = p0 - halo;                                 // position of span index 0
  const int64_t g0 = t0 / 16;                                   // exact: both are whole words
  for (int u = tid; u <= kN / 16; u += kThreads) {
    const int64_t g = g0 + u;
    ws[u] = (g >= 0 && g < n_words) ? __ldg(words + g) : 0u;
  }
  __syncthreads();
  // thread tid holds span indices 8 tid .. 8 tid + 7, all in word tid / 2
  const uint32_t kmask = (1u << (2 * k)) - 1u;
  const uint32_t comp = 0xAAAAAAAAu >> (32 - 2 * k);
  const int rsh = 32 - 2 * k;
  const uint32_t wa = ws[tid >> 1], wb = ws[(tid >> 1) + 1];
  uint32_t h[kMzPer], v[kMzPer];
#pragma unroll
  for (int j = 0; j < kMzPer; ++j) {
    uint32_t c = __funnelshift_r(wa, wb, 16 * (tid & 1) + 2 * j) & kmask;
    if (kCanonical) c = min(c, rev_fields32(c ^ comp) >> rsh);
    h[j] = v[j] = fmix32(c);
  }
  const int a = 31 - __clz(w);    // floor(log2 w) >= 1
  const int tail = w - (1 << a);  // the second read of a window, 0 at a power of two
  const int qt = tail / kMzPer, rt = tail % kMzPer;
  int eb = 0, pb = 0;             // the edge and plane buffers the next pass writes
  uint32_t c[2 * kMzPer];
  // after pass i, v holds min(h[t .. t + 2^(i+1) - 1]) wherever that fits in the span
  mz_shuffle_pass<kThreads, 1, true>(v, edges, eb), eb ^= 1;
  if (a > 1) mz_shuffle_pass<kThreads, 2, true>(v, edges, eb), eb ^= 1;
  if (a > 2) mz_shuffle_pass<kThreads, 4, true>(v, edges, eb), eb ^= 1;
  for (int i = 3; i < a; ++i, pb ^= 1) {  // offsets of whole threads: through the planes
    mz_put<kThreads>(planes, pb, v);
    mz_get<kThreads>(planes, pb, tid + (1 << (i - 3)), 0xFFFFFFFFu, c, 0);
#pragma unroll
    for (int j = 0; j < kMzPer; ++j) v[j] = min(v[j], c[j]);
  }
  // the window minima: min(v[t], v[t + tail]), 0 at the starts outside [0, n - w]
  mz_put<kThreads>(planes, pb, v);
  mz_get<kThreads>(planes, pb, tid + qt, 0xFFFFFFFFu, c, 0);
  mz_get<kThreads>(planes, pb, tid + qt + 1, 0xFFFFFFFFu, c, kMzPer);
  pb ^= 1;
  if (rt & 1)
#pragma unroll
    for (int j = 0; j + 1 < 2 * kMzPer; ++j) c[j] = c[j + 1];
  if (rt & 2)
#pragma unroll
    for (int j = 0; j + 2 < 2 * kMzPer; ++j) c[j] = c[j + 2];
  if (rt & 4)
#pragma unroll
    for (int j = 0; j + 4 < 2 * kMzPer; ++j) c[j] = c[j + 4];
#pragma unroll
  for (int j = 0; j < kMzPer; ++j) {
    const int64_t start = t0 + kMzPer * tid + j;
    v[j] = (start >= 0 && start <= n - w) ? min(v[j], c[j]) : 0u;
  }
  // after pass i, v holds max(wm[t - 2^(i+1) + 1 .. t])
  mz_shuffle_pass<kThreads, 1, false>(v, edges, eb), eb ^= 1;
  if (a > 1) mz_shuffle_pass<kThreads, 2, false>(v, edges, eb), eb ^= 1;
  if (a > 2) mz_shuffle_pass<kThreads, 4, false>(v, edges, eb), eb ^= 1;
  for (int i = 3; i < a; ++i, pb ^= 1) {
    mz_put<kThreads>(planes, pb, v);
    mz_get<kThreads>(planes, pb, tid - (1 << (i - 3)), 0u, c, 0);
#pragma unroll
    for (int j = 0; j < kMzPer; ++j) v[j] = max(v[j], c[j]);
  }
  // the windows that hold t start in [t - r, t]: max(v[t], v[t - tail])
  mz_put<kThreads>(planes, pb, v);
  mz_get<kThreads>(planes, pb, tid - qt - 1, 0u, c, 0);
  mz_get<kThreads>(planes, pb, tid - qt, 0u, c, kMzPer);
  if (rt & 1)
#pragma unroll
    for (int j = 2 * kMzPer - 1; j >= 1; --j) c[j] = c[j - 1];
  if (rt & 2)
#pragma unroll
    for (int j = 2 * kMzPer - 1; j >= 2; --j) c[j] = c[j - 2];
  if (rt & 4)
#pragma unroll
    for (int j = 2 * kMzPer - 1; j >= 4; --j) c[j] = c[j - 4];
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < kMzPer; ++j) {
    const int t = kMzPer * tid + j;
    const bool own = t >= halo && t < halo + span && p0 + (t - halo) < n;
    bits |= static_cast<uint32_t>(own && h[j] == max(v[j], c[kMzPer + j])) << j;
  }
  // an even thread and the next hold the 16 positions of one output word
  const uint32_t word = bits | (__shfl_down_sync(kFull, bits, 1) << kMzPer);
  const int t = kMzPer * tid;
  if ((tid & 1) == 0 && t >= halo && t < halo + span) {
    const int64_t o = (p0 + t - halo) / 16;
    if (o < n_out) out[o] = word;
  }
}

template <int kThreads, bool kCanonical>
cudaError_t launch_minimizer(const uint32_t* words, int64_t n_words, int64_t n, int k, int w, int halo,
                             uint32_t* out, cudaStream_t s) {
  constexpr int kSmem = mz_smem<kThreads>();
  cudaError_t err = cudaFuncSetAttribute(minimizer_kernel<kThreads, kCanonical>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const int span = kMzPer * kThreads - 2 * halo;
  const unsigned blocks = static_cast<unsigned>((n + span - 1) / span);
  minimizer_kernel<kThreads, kCanonical><<<blocks, kThreads, kSmem, s>>>(words, n_words, n, k, w, halo, out,
                                                                         (n + 15) / 16);
  return cudaGetLastError();
}

unsigned blocks_for(int64_t items, int per_block) {
  return static_cast<unsigned>((items + per_block - 1) / per_block);
}

}  // namespace

extern "C" {

// words u32[n_words] -> out u32[rows][16 width], rows = ceil(n_words / width),
// 16 <= k <= 31; seg >= 1 words per segment.
int cn_kmer_hashes_pair(const void* words, int64_t n_words, int64_t seg, int64_t width, int64_t rows,
                        int64_t n_valid, int k, int canonical, void* out, void* stream) {
  if (k < 16 || k > 31 || width < 1 || seg < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = rows * width;
  if (total == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const uint32_t*>(words);
  auto* o = static_cast<uint32_t*>(out);
  if (canonical)
    kmer_hashes_pair_kernel<true><<<blocks_for(total, kHashThreads), kHashThreads, 0, s>>>(
        w, n_words, seg, width, total, n_valid, k, o);
  else
    kmer_hashes_pair_kernel<false><<<blocks_for(total, kHashThreads), kHashThreads, 0, s>>>(
        w, n_words, seg, width, total, n_valid, k, o);
  return static_cast<int>(cudaGetLastError());
}

// words u32[n_words] -> out u32[ceil(n / 16)], the minimizer bits of the
// first n positions; 1 <= k <= 15, 2 <= w <= 2049 - k.
int cn_minimizer_bits(const void* words, int64_t n_words, int64_t n, int k, int w, int canonical, void* out,
                      void* stream) {
  if (k < 1 || k > 15 || w < 2 || w - 1 > 2048 - k || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int halo = (w - 1 + 15) / 16 * 16;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* wp = static_cast<const uint32_t*>(words);
  auto* o = static_cast<uint32_t*>(out);
  cudaError_t err;
  if (halo <= kMzNarrowHalo)
    err = canonical ? launch_minimizer<kMzNarrowThreads, true>(wp, n_words, n, k, w, halo, o, s)
                    : launch_minimizer<kMzNarrowThreads, false>(wp, n_words, n, k, w, halo, o, s);
  else
    err = canonical ? launch_minimizer<kMzWideThreads, true>(wp, n_words, n, k, w, halo, o, s)
                    : launch_minimizer<kMzWideThreads, false>(wp, n_words, n, k, w, halo, o, s);
  return static_cast<int>(err);
}

}  // extern "C"
