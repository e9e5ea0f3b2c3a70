// Radix sort of u32 key pairs for Hopper (sm_90a), plain C interface.
//
// Replaces cute_nucleotides_tpu/ops/sort.py:_sort_pairs_bitonic (its
// _k1_kernel and _k2_kernel, run by _strip_call's pallas_call): (hi, lo)
// u32[n0] -> the same pairs sorted ascending, unsigned and lexicographic.
// The TPU sorted with a bitonic network because it has no scatter; the
// network is not the contract.  Here each pair is the u64 key hi << 32 | lo,
// whose unsigned order is the pairs' order (kmer_counts' all-ones sentinel
// sorts last by itself), sorted least significant digit first: 8 stable
// passes of 8-bit digits over the n0 keys themselves (no padding).
//   * histogram kernel: reads hi and lo once and counts all eight digits
//     into 256 bins each in shared memory (a thread merges a run of one
//     digit value into one atomic, so a digit that never changes, as the
//     high digits of k-mer keys, costs no contention), then adds its bins
//     to global memory; each pass scans its digit's bins into bucket starts;
//   * one kernel per pass ("one sweep"): a block takes the next tile of 4096
//     keys from a global counter, loads it (the first pass builds the keys
//     from hi and lo) and ranks its keys stably by digit: each warp takes 32
//     keys a step, finds the lanes with its digit with __match_any_sync and
//     counts the lower ones with a popcount, against a per-warp count in
//     shared memory; per-bin warp offsets follow in warp order.  It
//     publishes its 256 bin counts and learns the counts of all earlier
//     tiles by decoupled look-back on the pass's status array (one word per
//     tile and bin: 2 flag bits, which say whether the word holds the tile's
//     own count or the inclusive count of it and all earlier tiles, and a
//     30-bit count), scatters the keys into shared memory in digit order and
//     writes them out from there, one run per bin.  The last pass writes hi
//     and lo.
// A block takes its tile from the counter, not from blockIdx, so every tile
// it waits on belongs to a block that started before it and publishes
// without waiting: the look-back always ends.  It loads 16 status words a
// step, so that the tiles still running ahead of an inclusive word cost one
// load latency per 16, not one each.
//
// Bound by memory: the histogram reads 8 B per pair and each pass reads and
// writes 8 B per key, 136 B per pair against the 16 B (one read and one
// write of each pair) that bound the function.  A tile's ranking (a match,
// two popcounts and a shared read and write per key) and its look-back are
// latency that the other tiles on its SM (three blocks of 256 threads) must
// hide; PERF.md has how far they do.
//
// Digit width: 8 bits give one bin per thread of a 256-thread block, so
// scans and look-back take no loops, per-warp counts of 8 KiB, a status row
// of 1 KiB per tile, and an average run of 16 keys (128 B, a full line) per
// bin and tile on the scatter.  11-bit digits would save two of the eight
// passes, but their 2048 bins give runs of 2 keys per tile, 64 KiB of
// per-warp counts and 8 KiB of status per tile.
//
// The entry point launches on the caller's stream, allocates nothing (keys
// is the caller's u64[2 n0] scratch, hist u32[8 * 256], status u32[(tiles +
// 1) * 256], whose length the caller passes and the entry point checks
// against its own tile size), zeroes hist and, before each pass, status with
// cudaMemsetAsync, does not synchronise, and returns the first error.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBits = 8;
constexpr int kBins = 1 << kBits;
constexpr int kPasses = 64 / kBits;
constexpr int kThreads = 256;  // one bin per thread
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;  // keys per thread
constexpr int kWarpKeys = 32 * kItems;
constexpr int kTileKeys = kThreads * kItems;
constexpr int kLookback = 16;  // status words a look-back step loads at once
constexpr int kHistThreads = 256;
constexpr int kHistBlocks = 132 * 8;
constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr uint32_t kAggregate = 1u << 30;  // the tile's own count
constexpr uint32_t kInclusive = 2u << 30;  // the count of this and all earlier tiles
constexpr uint32_t kCountMask = kAggregate - 1u;
static_assert(kBins == kThreads, "the scans and the look-back take one bin per thread");

// A status word carries its own count, and nothing else is read on the
// strength of it, so relaxed device-scope accesses suffice: they bypass L1,
// where acquire loads would invalidate it (a third slower in all, PERF.md).
__device__ __forceinline__ void store_relaxed(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t load_relaxed(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Exclusive prefix sum of v over the block's threads in thread order;
// scratch holds kWarps words.  Every thread must call it.
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t v, uint32_t* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t u = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += u;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  uint32_t before = 0;
  for (int w = 0; w < warp; ++w) before += scratch[w];
  __syncthreads();  // the scratch is free again
  return before + x - v;
}

// hist[256 p + d] += the number of keys hi[i] << 32 | lo[i] whose digit p is d.
__global__ void __launch_bounds__(kHistThreads)
radix_hist_kernel(const uint32_t* __restrict__ hi, const uint32_t* __restrict__ lo, int64_t n,
                  uint32_t* __restrict__ hist) {
  __shared__ uint32_t s[kPasses * kBins];
  for (int i = threadIdx.x; i < kPasses * kBins; i += kHistThreads) s[i] = 0;
  __syncthreads();
  uint32_t run_digit[kPasses], run_len[kPasses];
#pragma unroll
  for (int p = 0; p < kPasses; ++p) run_digit[p] = run_len[p] = 0;
  auto count = [&](uint32_t h, uint32_t l) {
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const uint32_t d = ((p < kPasses / 2 ? l : h) >> (kBits * (p % (kPasses / 2)))) & (kBins - 1);
      if (d != run_digit[p]) {
        if (run_len[p]) atomicAdd(&s[p * kBins + run_digit[p]], run_len[p]);
        run_digit[p] = d;
        run_len[p] = 0;
      }
      ++run_len[p];
    }
  };
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kHistThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kHistThreads + threadIdx.x;
  const auto* hi4 = reinterpret_cast<const uint4*>(hi);  // the wrapper checks 16-byte alignment
  const auto* lo4 = reinterpret_cast<const uint4*>(lo);
  for (int64_t i = first; i < n / 4; i += stride) {
    const uint4 h = __ldg(hi4 + i), l = __ldg(lo4 + i);
    count(h.x, l.x);
    count(h.y, l.y);
    count(h.z, l.z);
    count(h.w, l.w);
  }
  for (int64_t i = n / 4 * 4 + first; i < n; i += stride) count(__ldg(hi + i), __ldg(lo + i));
#pragma unroll
  for (int p = 0; p < kPasses; ++p)
    if (run_len[p]) atomicAdd(&s[p * kBins + run_digit[p]], run_len[p]);
  __syncthreads();
  for (int i = threadIdx.x; i < kPasses * kBins; i += kHistThreads)
    if (s[i]) atomicAdd(hist + i, s[i]);
}

// One stable pass on the digit at bit `shift` of n keys: keys_in (or (hi,
// lo) with kFromPairs) -> keys_out (or (hi_out, lo_out) with kToPairs).
// hist holds this digit's 256 counts; status holds the tile counter in word
// 0 and a row of 256 words per tile from word 256, all zero on entry.
template <bool kFromPairs, bool kToPairs>
__global__ void __launch_bounds__(kThreads, 3)
radix_pass_kernel(const uint32_t* __restrict__ hi, const uint32_t* __restrict__ lo,
                  const uint64_t* __restrict__ keys_in, uint64_t* __restrict__ keys_out,
                  uint32_t* __restrict__ hi_out, uint32_t* __restrict__ lo_out, const uint32_t* __restrict__ hist,
                  uint32_t* status, int64_t n, int shift) {
  __shared__ uint64_t s_keys[kTileKeys];      // the tile in digit order
  __shared__ uint32_t s_warp[kWarps][kBins];  // per-warp counts, then per-warp offsets
  __shared__ uint32_t s_start[kBins];         // bin d's first index in s_keys
  __shared__ int32_t s_out[kBins];            // s_keys[i] of bin d goes to s_out[d] + i
  __shared__ uint32_t s_scan[kWarps];
  __shared__ uint32_t s_tile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < kWarps * kBins; i += kThreads) (&s_warp[0][0])[i] = 0;
  if (tid == 0) s_tile = atomicAdd(status, 1u);
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t base = tile * kTileKeys + warp * kWarpKeys + lane;  // key j of this thread is at base + 32 j

  uint64_t key[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t g = base + 32 * j;
    key[j] = g >= n ? 0ull : kFromPairs ? (static_cast<uint64_t>(__ldg(hi + g)) << 32) | __ldg(lo + g) : keys_in[g];
  }
  // rank within the warp: the keys of lower lanes and earlier steps with the same digit
  uint32_t* wcount = s_warp[warp];
  const uint32_t lower = (1u << lane) - 1u;
  uint32_t rank[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool valid = base + 32 * j < n;
    const uint32_t d = valid ? static_cast<uint32_t>(key[j] >> shift) & (kBins - 1) : kBins;
    const uint32_t peers = __match_any_sync(kFull, d);
    const uint32_t before = valid ? wcount[d] : 0u;
    __syncwarp();
    if (valid && (peers & lower) == 0) wcount[d] = before + __popc(peers);
    rank[j] = before + __popc(peers & lower);
    __syncwarp();
  }
  __syncthreads();
  // thread d: bin d's warp offsets in warp order, the tile's count, published at once
  const int d = tid;
  uint32_t count = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t c = s_warp[w][d];
    s_warp[w][d] = count;
    count += c;
  }
  uint32_t* row = status + static_cast<int64_t>(kBins) * (tile + 1);
  store_relaxed(row + d, (tile == 0 ? kInclusive : kAggregate) | count);
  const uint32_t start = block_exclusive_scan(count, s_scan);
  const uint32_t bucket = block_exclusive_scan(__ldg(hist + d), s_scan);
  s_start[d] = start;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (base + 32 * j < n) {
      const uint32_t dj = static_cast<uint32_t>(key[j] >> shift) & (kBins - 1);
      s_keys[s_start[dj] + s_warp[warp][dj] + rank[j]] = key[j];
    }
  }
  // decoupled look-back: bin d's count over all earlier tiles, kLookback
  // tiles a step (loaded together, summed newest first up to an inclusive
  // word; a word not yet published ends the step and is loaded again)
  uint32_t prefix = 0;
  if (tile > 0) {
    for (int64_t t = tile - 1;;) {  // the newest tile not yet summed
      uint32_t v[kLookback];
#pragma unroll
      for (int q = 0; q < kLookback; ++q)
        v[q] = t - q >= 0 ? load_relaxed(status + static_cast<int64_t>(kBins) * (t - q + 1) + d) : kInclusive;
      int summed = 0;
      bool done = false;
#pragma unroll
      for (int q = 0; q < kLookback; ++q) {
        if (!done && summed == q && v[q] != 0) {
          prefix += v[q] & kCountMask;
          done = (v[q] & kInclusive) != 0;
          ++summed;
        }
      }
      if (done) break;
      t -= summed;
    }
    store_relaxed(row + d, kInclusive | (prefix + count));
  }
  s_out[d] = static_cast<int32_t>(bucket + prefix) - static_cast<int32_t>(start);
  __syncthreads();
  const int tile_n = static_cast<int>(min(static_cast<int64_t>(kTileKeys), n - tile * kTileKeys));
  for (int i = tid; i < tile_n; i += kThreads) {
    const uint64_t k = s_keys[i];
    const int64_t pos = s_out[static_cast<uint32_t>(k >> shift) & (kBins - 1)] + i;
    if (kToPairs) {
      hi_out[pos] = static_cast<uint32_t>(k >> 32);
      lo_out[pos] = static_cast<uint32_t>(k);
    } else {
      keys_out[pos] = k;
    }
  }
}

}  // namespace

extern "C" {

// (hi, lo) u32[n0] -> (hi_out, lo_out) u32[n0] sorted by (hi, lo); 1 <= n0
// < 2^30; keys u64[2 n0], hist u32[8 * 256] and status u32[status_words]
// scratch, status_words at least (ceil(n0 / 4096) + 1) * 256 (else
// cudaErrorInvalidValue, before any launch).
int cn_sort_pairs_radix(const void* hi_, const void* lo_, void* keys_, void* hist_, void* status_,
                        int64_t status_words, void* hi_out_, void* lo_out_, int64_t n0, void* stream_) {
  if (n0 < 1 || n0 > static_cast<int64_t>(kCountMask)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = (n0 + kTileKeys - 1) / kTileKeys;
  if (status_words < (tiles + 1) * kBins) return static_cast<int>(cudaErrorInvalidValue);
  const auto* hi = static_cast<const uint32_t*>(hi_);
  const auto* lo = static_cast<const uint32_t*>(lo_);
  auto* keys_a = static_cast<uint64_t*>(keys_);
  auto* keys_b = keys_a + n0;
  auto* hist = static_cast<uint32_t*>(hist_);
  auto* status = static_cast<uint32_t*>(status_);
  auto* hi_out = static_cast<uint32_t*>(hi_out_);
  auto* lo_out = static_cast<uint32_t*>(lo_out_);
  const auto stream = static_cast<cudaStream_t>(stream_);
  const size_t status_bytes = static_cast<size_t>(tiles + 1) * kBins * sizeof(uint32_t);
  cudaError_t err = cudaMemsetAsync(hist, 0, kPasses * kBins * sizeof(uint32_t), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t hist_blocks = (n0 + 4 * kHistThreads - 1) / (4 * kHistThreads);
  radix_hist_kernel<<<static_cast<unsigned>(hist_blocks < kHistBlocks ? hist_blocks : kHistBlocks), kHistThreads, 0,
                      stream>>>(hi, lo, n0, hist);
  err = cudaGetLastError();
  for (int p = 0; p < kPasses && err == cudaSuccess; ++p) {
    err = cudaMemsetAsync(status, 0, status_bytes, stream);
    if (err != cudaSuccess) break;
    // pass p reads the keys pass p - 1 wrote: A after even passes, B after odd ones
    const uint64_t* src = p % 2 ? keys_a : keys_b;
    uint64_t* dst = p % 2 ? keys_b : keys_a;
    const uint32_t* h = hist + p * kBins;
    const int shift = kBits * p;
    const auto blocks = static_cast<unsigned>(tiles);
    if (p == 0)
      radix_pass_kernel<true, false><<<blocks, kThreads, 0, stream>>>(hi, lo, nullptr, dst, nullptr, nullptr, h,
                                                                     status, n0, shift);
    else if (p == kPasses - 1)
      radix_pass_kernel<false, true><<<blocks, kThreads, 0, stream>>>(nullptr, nullptr, src, nullptr, hi_out,
                                                                     lo_out, h, status, n0, shift);
    else
      radix_pass_kernel<false, false><<<blocks, kThreads, 0, stream>>>(nullptr, nullptr, src, dst, nullptr,
                                                                      nullptr, h, status, n0, shift);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // extern "C"
