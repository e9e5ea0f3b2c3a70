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
// owns 4096 positions.  It loads its 256 words and a halo of w - 1 nt
// (rounded up to whole words) on each side into shared memory, hashes every
// position of that span, and takes the windowed min and max by van
// Herk/Gil-Werman: the span is cut into segments of w, so any window is a
// suffix of one segment and a prefix of the next, and four segmented scans
// (prefix and suffix min, then max) give every window in a constant number
// of operations per position, whatever w.  A warp scans whole segments, 32
// elements a step with shuffles, carrying a segment's running value from
// step to step.  The flags of a warp's 32 positions go out as one
// __ballot_sync, two output words of 16 bits.  Bound by integer work (the
// hash and the scans); 4 bytes read and 4 written per 16 positions.
//
// Every entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kHashThreads = 256;
constexpr int kMzThreads = 256;
constexpr int kMzWarps = kMzThreads / 32;
constexpr int kMzSpan = 4096;      // positions a minimizer block owns (256 words)
constexpr int kMzMaxHalo = 2048;   // w - 1 <= 2047, rounded up to a whole word
constexpr int kMzMaxSmem = (3 * (kMzSpan + 2 * kMzMaxHalo) + (kMzSpan + 2 * kMzMaxHalo) / 16 + 1) * 4;
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

// Segmented inclusive scan (min or max; prefix when kForward, else suffix)
// of x[0, n) in segments of `seg` elements starting at 0, into y (y may be
// x).  Warp q takes a run of whole segments; a step scans 32 elements with
// shuffles and adds the carry of the segment that runs in from the previous
// step.
template <bool kMin, bool kForward>
__device__ __forceinline__ void seg_scan(const uint32_t* x, uint32_t* y, int n, int seg) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_seg = (n + seg - 1) / seg;
  const int lo = warp * n_seg / kMzWarps * seg;
  const int hi = min((warp + 1) * n_seg / kMzWarps * seg, n);
  const uint32_t ident = kMin ? 0xFFFFFFFFu : 0u;
  uint32_t carry = ident;
  if (kForward) {
    for (int base = lo; base < hi; base += 32) {
      const int i = base + lane;
      const int start = i - i % seg;
      uint32_t v = i < hi ? x[i] : ident;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t u = __shfl_up_sync(kFull, v, d);
        if (lane >= d && i - d >= start) v = kMin ? min(v, u) : max(v, u);
      }
      if (start < base) v = kMin ? min(v, carry) : max(v, carry);
      if (i < hi) y[i] = v;
      carry = __shfl_sync(kFull, v, 31);
    }
  } else {
    for (int top = hi; top > lo; top -= 32) {
      const int i = top - 32 + lane;
      const int ic = max(i, lo);
      const int end = ic - ic % seg + seg;  // past the end of i's segment
      uint32_t v = i >= lo ? x[i] : ident;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t u = __shfl_down_sync(kFull, v, d);
        if (lane + d < 32 && i + d < end) v = kMin ? min(v, u) : max(v, u);
      }
      if (end > top) v = kMin ? min(v, carry) : max(v, carry);
      if (i >= lo) y[i] = v;
      carry = __shfl_sync(kFull, v, 0);
    }
  }
}

template <bool kCanonical>
__global__ void __launch_bounds__(kMzThreads)
minimizer_kernel(const uint32_t* __restrict__ words, int64_t n_words, int64_t n, int k, int w, int halo,
                 uint32_t* __restrict__ out, int64_t n_out) {
  extern __shared__ uint32_t smem[];
  const int r = w - 1;
  const int N = kMzSpan + 2 * halo;  // positions of the span, halo included
  uint32_t* hs = smem;               // hashes
  uint32_t* a = smem + N;            // prefix scans
  uint32_t* b = smem + 2 * N;        // suffix scans, then the window minima
  uint32_t* ws = smem + 3 * N;       // the span's words and one more
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kMzSpan;  // first own position
  const int64_t t0 = p0 - halo;                                    // position of span index 0
  const int64_t g0 = t0 / 16;                                      // exact: both are whole words
  for (int u = threadIdx.x; u <= N / 16; u += kMzThreads) {
    const int64_t g = g0 + u;
    ws[u] = (g >= 0 && g < n_words) ? __ldg(words + g) : 0u;
  }
  __syncthreads();
  const uint32_t kmask = (1u << (2 * k)) - 1u;
  const uint32_t comp = 0xAAAAAAAAu >> (32 - 2 * k);
  const int rsh = 32 - 2 * k;
  for (int t = threadIdx.x; t < N; t += kMzThreads) {
    uint32_t c = __funnelshift_r(ws[t >> 4], ws[(t >> 4) + 1], 2 * (t & 15)) & kmask;
    if (kCanonical) c = min(c, rev_fields32(c ^ comp) >> rsh);
    hs[t] = fmix32(c);
  }
  __syncthreads();
  // the window starting at t is a suffix of t's segment and a prefix of the next
  seg_scan<true, true>(hs, a, N, w);
  seg_scan<true, false>(hs, b, N, w);
  __syncthreads();
  for (int t = threadIdx.x; t < N; t += kMzThreads) {
    const int64_t j = t0 + t;
    b[t] = (t + r < N && j >= 0 && j <= n - w) ? min(b[t], a[t + r]) : 0u;
  }
  __syncthreads();
  // the windows containing t start in [t - r, t]: a suffix and a prefix again
  seg_scan<false, true>(b, a, N, w);
  __syncwarp();  // the same warp rewrites its run of b below
  seg_scan<false, false>(b, b, N, w);
  __syncthreads();
  for (int l = threadIdx.x; l < kMzSpan; l += kMzThreads) {
    const int t = halo + l;
    const bool flag = p0 + l < n && hs[t] == max(a[t], b[t - r]);
    const uint32_t m = __ballot_sync(kFull, flag);
    if ((threadIdx.x & 31) == 0) {
      const int64_t o = (p0 + l) / 16;  // even: the warp's 32 positions start a pair of words
      if (o < n_out) out[o] = m & 0xFFFFu;
      if (o + 1 < n_out) out[o + 1] = m >> 16;
    }
  }
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
  const size_t smem = (3 * (kMzSpan + 2 * halo) + (kMzSpan + 2 * halo) / 16 + 1) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(minimizer_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kMzMaxSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(minimizer_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMzMaxSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* wp = static_cast<const uint32_t*>(words);
  auto* o = static_cast<uint32_t*>(out);
  const int64_t n_out = (n + 15) / 16;
  if (canonical)
    minimizer_kernel<true><<<blocks_for(n, kMzSpan), kMzThreads, smem, s>>>(wp, n_words, n, k, w, halo, o, n_out);
  else
    minimizer_kernel<false><<<blocks_for(n, kMzSpan), kMzThreads, smem, s>>>(wp, n_words, n, k, w, halo, o, n_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
