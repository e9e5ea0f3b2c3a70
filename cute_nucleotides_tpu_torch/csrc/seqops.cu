// Base-5 GC count for Hopper (sm_90a), plain C interface.
//
// Replaces cute_nucleotides_tpu/ops/pallas_kernels.py:gc_b5_row_sums (the
// pallas_call of _gc_b5_inter_kernel, driven by gc_content_b5_stream_pallas):
// a flat base-5 stream of n u64 words (9 triplets of 7 bits each, bit 63 in
// none) -> one int32, the sum over every triplet t of
//   ((t ^ u) & 1) + ((u ^ v) & 1) + (v & 1),  u = t / 5, v = t / 25,
// the low bits of its three digits (C = 1 and G = 3 are the odd digits).  A
// corrupt triplet (125..127) counts by the same formula, as in every form of
// the reference.  The TPU kernel landed each triplet on its own lane with a
// bf16 gather-fold on the matrix unit (its VPU has no byte shuffle) and
// padded the stream to 256-u32 panel rows; neither is needed here.
//
// Each thread reads 16 B (two words) per step of a grid-stride loop and cuts
// the 9 triplets of each word with 64-bit shifts (triplet 4 straddles the
// u32 halves and needs nothing special).  A triplet's count comes from a
// 128-byte table in shared memory, built from the formula above: 128 bytes
// are one 4-byte word in each of the 32 banks, so a warp's lookups never
// conflict (two lanes in one word are a broadcast).  Per-thread counts are
// summed by warp shuffles, then across the block's warps, and the block adds
// its total to *out with one integer atomicAdd (exact, in any order).  An odd
// word count leaves one word for thread 0 of block 0: the tail is masked in
// the kernel, with no padding copy.  Bound by reading the stream: 8 B per
// 27 nt; the lookup form costs about 3 integer instructions per triplet.
//
// The entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() after its launch; *out
// must be zeroed by the caller.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ int word_gc(const uint8_t* table, uint64_t w) {
  int s = 0;
#pragma unroll
  for (int j = 0; j < 9; ++j) s += table[(w >> (7 * j)) & 0x7Fu];
  return s;
}

__global__ void __launch_bounds__(kThreads)
gc_b5_kernel(const uint4* __restrict__ pairs, const uint64_t* __restrict__ words, int64_t n_words,
             int32_t* __restrict__ out) {
  __shared__ uint8_t table[128];
  __shared__ int warp_sums[kWarps];
  if (threadIdx.x < 128) {
    const uint32_t t = threadIdx.x, u = (t * 205u) >> 10, v = (t * 41u) >> 10;
    table[t] = static_cast<uint8_t>(((t ^ u) & 1u) + ((u ^ v) & 1u) + (v & 1u));
  }
  __syncthreads();
  int acc = 0;
  const int64_t n_pairs = n_words / 2;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n_pairs; i += stride) {
    const uint4 v = __ldg(pairs + i);
    acc += word_gc(table, static_cast<uint64_t>(v.x) | (static_cast<uint64_t>(v.y) << 32));
    acc += word_gc(table, static_cast<uint64_t>(v.z) | (static_cast<uint64_t>(v.w) << 32));
  }
  if ((n_words & 1) && blockIdx.x == 0 && threadIdx.x == 0) acc += word_gc(table, words[n_words - 1]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xFFFFFFFFu, acc, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    int s = threadIdx.x < kWarps ? warp_sums[threadIdx.x] : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xFFFFFFFFu, s, off);
    if (threadIdx.x == 0 && s) atomicAdd(out, s);
  }
}

}  // namespace

extern "C" {

// words u64[n] (16-byte aligned, as u32 halves) -> *out += its GC count.
int cn_gc_b5(const void* words, int64_t n_words, void* out, void* stream) {
  if (n_words < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_words == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t need = (n_words / 2 + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSm;
  const unsigned blocks = static_cast<unsigned>(need < 1 ? 1 : need < cap ? need : cap);
  gc_b5_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(words), static_cast<const uint64_t*>(words), n_words, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
