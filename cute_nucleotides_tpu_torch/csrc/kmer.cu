// K-mer kernels for Hopper (sm_90a), plain C interface.
//
// Planar k-mer codes (replace cute_nucleotides_tpu/ops/kmer.py:
// kmer_codes_planar and kmer_codes_planar_pair).  Input is a packed 2-bit
// stream cut into rows of W u32 words (16 nt each, 2 bits per nt, LSB-first)
// with the successor words beside it: nxt[r][w] is the word after
// words[r][w] in stream order (nxt2 the one after that).  The code of the
// k-mer at nt 16w + s of row r is the 2k-bit window at bit 2s of
// (words, nxt[, nxt2]); it lands at column W*s + w of row r of the output
// (planar order, a fixed permutation of position order).
//   * k <= 15: out i32[R][16W] = window & (4^k - 1).
//   * 16 <= k <= 31: out (lo, hi) u32[R][16W] planes; lo is the low 32 bits
//     of the window, hi the next 2k - 32 (0 at k = 16).
// One thread per input word: it loads its 2 (3) words once and writes 16
// codes (per plane), one per shift s.  Adjacent threads hold adjacent w, so
// each of the 16 stores of a warp is one contiguous 128-byte line.  Bound by
// the writes: 64 B (128 B for pairs) out per 8 B (12 B) in.
//
// Code histogram (replaces kmer.py:_hist_mxu, whose int8 one-hot matmul on
// the TPU's matrix unit stood in for a scatter): codes i32[n] -> counts
// i32[65536] (= [256][256], high byte then low byte), adding to counts; codes
// outside [0, 65536) are not counted, as the one-hots drop them.  65,536 u32
// bins (256 KiB) do not fit in a block's 227 KiB of shared memory, so each
// block keeps them as u16 counters, two per u32 word (128 KiB): the add that
// takes a counter to 0x8000 moves those 32768 to the global bin, so no
// counter ever reaches 0x10000 and spills into its neighbour.  A persistent
// grid (one block per SM) reads the codes with 16-byte loads and flushes its
// bins to global with one atomic per non-zero counter at the end.  Code 0 is
// where the callers mask every out-of-range position (a 150-nt read padded to
// a 512-word row puts 8049 of its 8192 codes there), so zeros skip the shared
// atomics: a warp counts them with one ballot and its lane 0 adds the total
// at the end.  Bound by reading the codes (4 B per code).
//
// Every entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;        // words (threads) per block of the code kernels
constexpr int kHistThreads = 1024;   // threads per histogram block
constexpr int kBins = 65536;
constexpr int kBinWords = kBins / 2;  // two u16 counters per u32 word
constexpr uint32_t kCarry = 0x8000u;  // a counter's count moves to global when it reaches this
constexpr int kHistSmem = kBinWords * 4;

__global__ void __launch_bounds__(kThreads)
kmer_codes_kernel(const uint32_t* __restrict__ words, const uint32_t* __restrict__ nxt,
                  int32_t* __restrict__ out, int64_t n_words, int64_t W, uint32_t mask) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_words) return;
  const int64_t r = i / W;
  const uint32_t a = __ldg(words + i), b = __ldg(nxt + i);
  int32_t* o = out + 15 * W * r + i;  // row r starts at 16 W r; column w = i - W r
  o[0] = static_cast<int32_t>(a & mask);
#pragma unroll
  for (int s = 1; s < 16; ++s) o[s * W] = static_cast<int32_t>(__funnelshift_r(a, b, 2 * s) & mask);
}

__global__ void __launch_bounds__(kThreads)
kmer_codes_pair_kernel(const uint32_t* __restrict__ words, const uint32_t* __restrict__ nxt,
                       const uint32_t* __restrict__ nxt2, uint32_t* __restrict__ lo,
                       uint32_t* __restrict__ hi, int64_t n_words, int64_t W, uint32_t hi_mask) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_words) return;
  const int64_t r = i / W;
  const uint32_t a = __ldg(words + i), b = __ldg(nxt + i), c = __ldg(nxt2 + i);
  const int64_t o = 15 * W * r + i;
  lo[o] = a;
  hi[o] = b & hi_mask;
#pragma unroll
  for (int s = 1; s < 16; ++s) {
    lo[o + s * W] = __funnelshift_r(a, b, 2 * s);
    hi[o + s * W] = __funnelshift_r(b, c, 2 * s) & hi_mask;
  }
}

// Count one code into the block's u16 counters (code 0 is counted by the
// caller's ballot).
__device__ __forceinline__ void count_code(uint32_t* bins, int32_t* __restrict__ counts, int32_t c) {
  if (c <= 0 || c >= kBins) return;
  const uint32_t half = (c & 1) * 16u;
  const uint32_t old = atomicAdd(bins + (c >> 1), 1u << half);
  if (((old >> half) & 0xFFFFu) == kCarry - 1u) {  // this add took the counter to kCarry
    atomicSub(bins + (c >> 1), kCarry << half);
    atomicAdd(counts + c, static_cast<int32_t>(kCarry));
  }
}

__global__ void __launch_bounds__(kHistThreads)
hist_codes_kernel(const int32_t* __restrict__ codes, int64_t n, int32_t* __restrict__ counts) {
  extern __shared__ uint32_t bins[];
  for (int j = threadIdx.x; j < kBinWords; j += kHistThreads) bins[j] = 0u;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  uint32_t zeros = 0;  // lane 0: the warp's code-0 count
  const int64_t n4 = n / 4;
  const int4* codes4 = reinterpret_cast<const int4*>(codes);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kHistThreads;
  // every thread of a block runs the same iterations, so the ballots see full warps
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kHistThreads; base < n4; base += stride) {
    const int64_t i = base + threadIdx.x;
    const int4 v = i < n4 ? __ldg(codes4 + i) : make_int4(-1, -1, -1, -1);
    const uint32_t z = __popc(__ballot_sync(0xFFFFFFFFu, v.x == 0)) + __popc(__ballot_sync(0xFFFFFFFFu, v.y == 0)) +
                       __popc(__ballot_sync(0xFFFFFFFFu, v.z == 0)) + __popc(__ballot_sync(0xFFFFFFFFu, v.w == 0));
    if (lane == 0) zeros += z;
    count_code(bins, counts, v.x);
    count_code(bins, counts, v.y);
    count_code(bins, counts, v.z);
    count_code(bins, counts, v.w);
  }
  if (blockIdx.x == 0 && threadIdx.x < n - 4 * n4) {  // the last n % 4 codes
    const int32_t c = codes[4 * n4 + threadIdx.x];
    if (c == 0) atomicAdd(counts, 1); else count_code(bins, counts, c);
  }
  if (lane == 0 && zeros) atomicAdd(counts, static_cast<int32_t>(zeros));
  __syncthreads();
  for (int j = threadIdx.x; j < kBinWords; j += kHistThreads) {
    const uint32_t v = bins[j];
    if (v & 0xFFFFu) atomicAdd(counts + 2 * j, static_cast<int32_t>(v & 0xFFFFu));
    if (v >> 16) atomicAdd(counts + 2 * j + 1, static_cast<int32_t>(v >> 16));
  }
}

unsigned code_blocks(int64_t n_words) { return static_cast<unsigned>((n_words + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// words, nxt u32[rows][W] -> out i32[rows][16 W], 1 <= k <= 15.
int cn_kmer_codes(const void* words, const void* nxt, void* out, int64_t rows, int64_t W, int k,
                  void* stream) {
  if (k < 1 || k > 15 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  kmer_codes_kernel<<<code_blocks(rows * W), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const uint32_t*>(nxt), static_cast<int32_t*>(out),
      rows * W, W, (1u << (2 * k)) - 1u);
  return static_cast<int>(cudaGetLastError());
}

// words, nxt, nxt2 u32[rows][W] -> lo, hi u32[rows][16 W], 16 <= k <= 31.
int cn_kmer_codes_pair(const void* words, const void* nxt, const void* nxt2, void* lo, void* hi, int64_t rows,
                       int64_t W, int k, void* stream) {
  if (k < 16 || k > 31 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  kmer_codes_pair_kernel<<<code_blocks(rows * W), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const uint32_t*>(nxt), static_cast<const uint32_t*>(nxt2),
      static_cast<uint32_t*>(lo), static_cast<uint32_t*>(hi), rows * W, W, (1u << (2 * k - 32)) - 1u);
  return static_cast<int>(cudaGetLastError());
}

// codes i32[n] (16-byte aligned) -> counts i32[65536] += the count of each
// code; counts must be zeroed by the caller for a fresh histogram.
int cn_hist_codes(const void* codes, int64_t n, void* counts, void* stream) {
  if (n == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(hist_codes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kHistSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t need = (n / 4 + kHistThreads - 1) / kHistThreads;
  const unsigned blocks = static_cast<unsigned>(need < 1 ? 1 : need < sms ? need : sms);
  hist_codes_kernel<<<blocks, kHistThreads, kHistSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(codes), n, static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
