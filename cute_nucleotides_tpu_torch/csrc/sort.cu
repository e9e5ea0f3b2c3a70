// Bitonic sort of u32 key pairs for Hopper (sm_90a), plain C interface.
//
// Replaces cute_nucleotides_tpu/ops/sort.py:_sort_pairs_bitonic (its
// _k1_kernel and _k2_kernel, run by _strip_call's pallas_call): (hi, lo)
// u32[n0] -> the same pairs sorted ascending, unsigned and lexicographic.
// The network is the standard one over n = n0 rounded up to a power of two,
// the tail padded with (0xFFFFFFFF, 0xFFFFFFFF), which sorts last; the
// result is cut back to n0, exact because equal pairs are indistinguishable.
// Phase k (2, 4, .., n) runs strides j = k/2 .. 1; element i and i + j
// (i & j == 0) swap when out of order for the direction ascending iff
// (i & k) == 0.
//
// The TPU kernels switched between a row layout and its transpose, in
// (8, 128) strips, so that every compare-exchange was a cross-row vector op
// (its VPU has no cheap lane shuffle), and flipped the keys' sign bit
// because Mosaic has no unsigned compare.  Here each pair is one u64 key
// hi << 32 | lo, built on load and compared natively as unsigned:
//   * tile kernel: a block sorts a tile of kTile keys (64 KiB) in dynamic
//     shared memory, phases 2 .. kTile, with the global direction bits, so
//     the tiles come out alternately ascending and descending;
//   * for each phase k > kTile: one global compare-exchange launch per
//     stride j >= kTile (one thread per pair, coalesced 8-byte accesses,
//     stores only on a swap), then one tile pass over the strides below
//     kTile in shared memory (its direction is uniform in the tile);
//   * the last pass splits the keys back into hi and lo, the first n0 only.
// Bound by memory: each global stride reads and writes every key; the least
// any sort needs is one read and one write of each pair (16 B).  Fusing
// strides in registers is left for a later change.
//
// The entry point launches on the caller's stream, allocates nothing (keys
// is the caller's u64[n] scratch), does not synchronise, and returns the
// first launch error, or cudaGetLastError() after its last launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 8192;        // keys per shared-memory tile
constexpr int kTileThreads = 1024;
constexpr int kStepThreads = 256;

// One stage of stride j over a tile in shared memory; k is the phase whose
// direction bit (i & k) of the global index i decides the order.
__device__ __forceinline__ void tile_stage(uint64_t* s, int tile, int64_t base, int j, int64_t k) {
  for (int p = threadIdx.x; p < tile / 2; p += blockDim.x) {
    const int low = p & (j - 1);
    const int a = ((p - low) << 1) | low;
    const bool asc = ((base + a) & k) == 0;
    const uint64_t x = s[a], y = s[a + j];
    if ((x > y) == asc) {
      s[a] = y;
      s[a + j] = x;
    }
  }
  __syncthreads();
}

// k_outer == 0: sort each tile (phases 2 .. tile); else the strides below
// the tile of phase k_outer.  kFromPairs loads from (hi, lo) and pads past
// n0, else from keys; kToPairs stores (hi, lo) below n0, else keys.
template <bool kFromPairs, bool kToPairs>
__global__ void __launch_bounds__(kTileThreads)
bitonic_tile_kernel(const uint32_t* __restrict__ hi, const uint32_t* __restrict__ lo, uint64_t* keys,
                    uint32_t* __restrict__ hi_out, uint32_t* __restrict__ lo_out, int64_t n0, int tile,
                    int64_t k_outer) {
  extern __shared__ uint64_t s[];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * tile;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int64_t g = base + i;
    if (kFromPairs)
      s[i] = g < n0 ? (static_cast<uint64_t>(__ldg(hi + g)) << 32) | __ldg(lo + g) : ~0ull;
    else
      s[i] = keys[g];
  }
  __syncthreads();
  if (k_outer == 0) {
    for (int k = 2; k <= tile; k <<= 1)
      for (int j = k >> 1; j > 0; j >>= 1) tile_stage(s, tile, base, j, k);
  } else {
    for (int j = tile >> 1; j > 0; j >>= 1) tile_stage(s, tile, base, j, k_outer);
  }
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int64_t g = base + i;
    if (kToPairs) {
      if (g < n0) {
        hi_out[g] = static_cast<uint32_t>(s[i] >> 32);
        lo_out[g] = static_cast<uint32_t>(s[i]);
      }
    } else {
      keys[g] = s[i];
    }
  }
}

// One stride j >= kTile of phase k over all n keys: thread p owns the pair
// (a, a + j) with a = p with a zero bit inserted at j.
__global__ void __launch_bounds__(kStepThreads)
bitonic_step_kernel(uint64_t* __restrict__ keys, int64_t half_n, int64_t j, int64_t k) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kStepThreads + threadIdx.x;
  if (p >= half_n) return;
  const int64_t low = p & (j - 1);
  const int64_t a = ((p - low) << 1) | low;
  const bool asc = (a & k) == 0;
  const uint64_t x = keys[a], y = keys[a + j];
  if ((x > y) == asc) {
    keys[a] = y;
    keys[a + j] = x;
  }
}

template <bool kFromPairs, bool kToPairs>
cudaError_t tile_pass(const uint32_t* hi, const uint32_t* lo, uint64_t* keys, uint32_t* hi_out, uint32_t* lo_out,
                      int64_t n0, int64_t n, int tile, int64_t k_outer, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(tile) * sizeof(uint64_t);
  cudaError_t err = cudaFuncSetAttribute(bitonic_tile_kernel<kFromPairs, kToPairs>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int threads = tile / 2 < kTileThreads ? tile / 2 : kTileThreads;
  bitonic_tile_kernel<kFromPairs, kToPairs><<<static_cast<unsigned>(n / tile), threads, smem, stream>>>(
      hi, lo, keys, hi_out, lo_out, n0, tile, k_outer);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// (hi, lo) u32[n0] -> (hi_out, lo_out) u32[n0] sorted by (hi, lo); n a power
// of two >= max(n0, 2); keys u64[n] scratch.
int cn_sort_pairs_bitonic(const void* hi_, const void* lo_, void* keys_, void* hi_out_, void* lo_out_, int64_t n0,
                          int64_t n, void* stream_) {
  if (n < 2 || (n & (n - 1)) || n0 < 1 || n0 > n || n > (int64_t(1) << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* hi = static_cast<const uint32_t*>(hi_);
  const auto* lo = static_cast<const uint32_t*>(lo_);
  auto* keys = static_cast<uint64_t*>(keys_);
  auto* hi_out = static_cast<uint32_t*>(hi_out_);
  auto* lo_out = static_cast<uint32_t*>(lo_out_);
  const auto stream = static_cast<cudaStream_t>(stream_);
  const int tile = n < kTile ? static_cast<int>(n) : kTile;
  if (n == tile)
    return static_cast<int>(tile_pass<true, true>(hi, lo, keys, hi_out, lo_out, n0, n, tile, 0, stream));
  cudaError_t err = tile_pass<true, false>(hi, lo, keys, hi_out, lo_out, n0, n, tile, 0, stream);
  const unsigned step_blocks = static_cast<unsigned>((n / 2 + kStepThreads - 1) / kStepThreads);
  for (int64_t k = 2 * static_cast<int64_t>(tile); k <= n && err == cudaSuccess; k <<= 1) {
    for (int64_t j = k >> 1; j >= tile && err == cudaSuccess; j >>= 1) {
      bitonic_step_kernel<<<step_blocks, kStepThreads, 0, stream>>>(keys, n / 2, j, k);
      err = cudaGetLastError();
    }
    if (err != cudaSuccess) break;
    err = k == n ? tile_pass<false, true>(hi, lo, keys, hi_out, lo_out, n0, n, tile, k, stream)
                 : tile_pass<false, false>(hi, lo, keys, hi_out, lo_out, n0, n, tile, k, stream);
  }
  return static_cast<int>(err);
}

}  // extern "C"
