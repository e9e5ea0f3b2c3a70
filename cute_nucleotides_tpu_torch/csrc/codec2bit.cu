// 2-bit nucleotide codec kernels for Hopper (sm_90a), plain C interface.
//
// Contract (cute_nucleotides_tpu/ops/spec.py): code = (byte >> 1) & 3, so
// A/a -> 0, C/c -> 1, T/t/U/u -> 2, G/g -> 3; nucleotide i of a stream sits at
// bits [2*(i%32), 2*(i%32)+1] of little-endian u64 word i/32; decode always
// emits upper-case ACGT.  Every kernel here is bound by device memory (5 bytes
// moved per 4 nt), so each thread moves whole 16-byte vectors and does a few
// integer ops per byte.  The pext slot (encode_2bit_pext_kernel) gathers the
// codes' two bit planes with multiply-masks inside each thread, where the
// other encoders pack both code bits of a byte at once.
//
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// t = w & 0x06060606 keeps code*2 in each byte; bits 24..31 of t * kMulMagic
// are c0 | c1 << 2 | c2 << 4 | c3 << 6 (the partial products never collide).
constexpr uint32_t kMulMagic = (1u << 5) | (1u << 11) | (1u << 17) | (1u << 23);
// char(code) == (kCharLut >> (8 * code)) & 0xFF, codes 0..3 -> "ACTG"
constexpr uint32_t kCharLut = 0x47544341u;

enum EncodeVariant { kMul = 0, kShift = 1, kInterleave = 2 };
enum DecodeVariant { kSwar = 0, kShuffle = 1, kSelect = 2 };

// one u32 of 4 ASCII nt -> its packed byte (low 8 bits)
template <int V>
__device__ __forceinline__ uint32_t pack4(uint32_t w) {
  if (V == kMul) {
    return ((w & 0x06060606u) * kMulMagic) >> 24;
  } else if (V == kShift) {
    uint32_t t = (w >> 1) & 0x03030303u;
    uint32_t u = t | (t >> 6);
    return (u | (u >> 12)) & 0xFFu;
  } else {
    uint32_t e = (w >> 1) & 0x00030003u;  // codes of nt 0 and 2
    uint32_t o = (w >> 9) & 0x00030003u;  // codes of nt 1 and 3
    uint32_t m = e | (o << 2);
    return (m | (m >> 12)) & 0xFFu;
  }
}

__device__ __forceinline__ uint32_t select_char(uint32_t c) {
  return 0x41u + (c == 1 ? 2u : 0u) + (c == 2 ? 19u : 0u) + (c == 3 ? 6u : 0u);
}

// one packed byte b (0..255) -> u32 of its 4 ASCII chars, little-endian
template <int V>
__device__ __forceinline__ uint32_t unpack4(uint32_t b) {
  if (V == kSwar) {
    // spread the codes to their byte positions with two carry-free
    // multiplies, then chars = 'A' + 2*code + 15*[code == 2] per byte
    uint32_t m1 = (b & 0x33u) * ((1u << 0) | (1u << 12));
    uint32_t m2 = (b & 0xCCu) * ((1u << 6) | (1u << 18));
    uint32_t s = (m1 | m2) & 0x03030303u;
    uint32_t e = (s >> 1) & ~s & 0x01010101u;
    return 0x41414141u + (s << 1) + e * 15u;
  } else if (V == kShuffle) {
    return ((kCharLut >> ((b & 3u) << 3)) & 0xFFu) |
           (((kCharLut >> (((b >> 2) & 3u) << 3)) & 0xFFu) << 8) |
           (((kCharLut >> (((b >> 4) & 3u) << 3)) & 0xFFu) << 16) |
           (((kCharLut >> (((b >> 6) & 3u) << 3)) & 0xFFu) << 24);
  } else {
    return select_char(b & 3u) | (select_char((b >> 2) & 3u) << 8) |
           (select_char((b >> 4) & 3u) << 16) | (select_char((b >> 6) & 3u) << 24);
  }
}

// nonzero exactly at the bytes of w outside {A,C,G,T,U} (either case): a
// byte is valid iff it equals, case-folded, the char its code decodes to,
// with bit 0 forgiven on code 2 so that U (0x55) passes beside T (0x54)
__device__ __forceinline__ uint32_t invalid_bits(uint32_t w) {
  uint32_t v = w & 0xDFDFDFDFu;
  uint32_t s = (w >> 1) & 0x03030303u;
  uint32_t e = (s >> 1) & ~s & 0x01010101u;
  uint32_t expect = 0x41414141u + (s << 1) + e * 15u;
  return (v ^ expect) & ~e;
}

// nonzero where one 16-nt group (4 u32 of 4 nt) holds a bad byte
__device__ __forceinline__ uint32_t invalid16(uint4 v) {
  return invalid_bits(v.x) | invalid_bits(v.y) | invalid_bits(v.z) | invalid_bits(v.w);
}

__device__ __forceinline__ int64_t global_thread() {
  return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}

// Thread g reads nt4 lanes 4g..4g+3 (16 nt, one 16-byte load) and writes
// packed bytes 4g..4g+3 (one u32 store).  The last thread may hold fewer
// than 4 lanes and falls back to scalar accesses.
template <int V>
__global__ void __launch_bounds__(kThreads)
encode_2bit_kernel(const uint32_t* __restrict__ in, uint8_t* __restrict__ out,
                   int64_t n_lanes) {
  const int64_t g = global_thread();
  const int64_t lane0 = 4 * g;
  if (lane0 >= n_lanes) return;
  if (lane0 + 4 <= n_lanes) {
    const uint4 v = reinterpret_cast<const uint4*>(in)[g];
    reinterpret_cast<uint32_t*>(out)[g] = pack4<V>(v.x) | (pack4<V>(v.y) << 8) |
                                          (pack4<V>(v.z) << 16) | (pack4<V>(v.w) << 24);
  } else {
    for (int64_t j = lane0; j < n_lanes; ++j) out[j] = static_cast<uint8_t>(pack4<V>(in[j]));
  }
}

// Thread g reads packed bytes 4g..4g+3 (one u32 load) and writes nt4 lanes
// 4g..4g+3 (16 ASCII bytes, one 16-byte store).
template <int V>
__global__ void __launch_bounds__(kThreads)
decode_2bit_kernel(const uint8_t* __restrict__ in, uint32_t* __restrict__ out,
                   int64_t n_bytes) {
  const int64_t g = global_thread();
  const int64_t byte0 = 4 * g;
  if (byte0 >= n_bytes) return;
  if (byte0 + 4 <= n_bytes) {
    const uint32_t p = reinterpret_cast<const uint32_t*>(in)[g];
    uint4 o;
    o.x = unpack4<V>(p & 0xFFu);
    o.y = unpack4<V>((p >> 8) & 0xFFu);
    o.z = unpack4<V>((p >> 16) & 0xFFu);
    o.w = unpack4<V>(p >> 24);
    reinterpret_cast<uint4*>(out)[g] = o;
  } else {
    for (int64_t j = byte0; j < n_bytes; ++j) out[j] = unpack4<V>(in[j]);
  }
}

// The encode above plus a per-row validity flag.  Rows hold a whole number
// of 16-nt groups, so a thread's group lies in one row.  A warp whose groups
// all lie in one row ORs its flags with one __reduce_or_sync and lane 0
// issues at most one atomicOr; a warp that straddles a row boundary (rare:
// once per row) lets each thread that saw a bad byte flag its own row.
template <int V>
__global__ void __launch_bounds__(kThreads)
encode_2bit_checked_kernel(const uint32_t* __restrict__ in, uint8_t* __restrict__ out,
                           uint32_t* __restrict__ flags, int64_t n_groups,
                           int64_t groups_per_row) {
  const int64_t g = global_thread();
  const int lane = threadIdx.x & 31;
  const int64_t warp_first = g - lane;
  if (warp_first >= n_groups) return;  // the whole warp is past the end
  uint32_t bad = 0;
  if (g < n_groups) {
    const uint4 v = reinterpret_cast<const uint4*>(in)[g];
    reinterpret_cast<uint32_t*>(out)[g] = pack4<V>(v.x) | (pack4<V>(v.y) << 8) |
                                          (pack4<V>(v.z) << 16) | (pack4<V>(v.w) << 24);
    bad = invalid16(v);
  }
  const int64_t warp_last = min(warp_first + 31, n_groups - 1);
  const int64_t row = warp_first / groups_per_row;
  if (row == warp_last / groups_per_row) {
    const uint32_t any = __reduce_or_sync(0xFFFFFFFFu, bad);
    if (lane == 0 && any != 0) atomicOr(&flags[row], 1u);
  } else if (bad != 0) {
    atomicOr(&flags[g / groups_per_row], 1u);
  }
}

// The pext slot's bit-plane gather, one u32 w of 4 nt (byte j = nt j) at a
// time.  lo = (w >> 1) & 0x01010101 is the codes' low plane (bit 8j = low bit
// of nt j's code), hi = (w >> 2) & 0x01010101 their high plane.  Multiplying
// lo by kPlaneLo = sum_i 2^(24 - 6i) copies bit 8j to bits 8j - 6i + 24, i =
// 0..3; multiplying hi by kPlaneHi = 2 * kPlaneLo copies it to 8j - 6i + 25.
// The 32 positions {8j - 6i + 24 + p : i, j in 0..3, p in 0, 1} are all
// distinct (the low plane's are even, the high plane's odd, and 8j - 6i
// takes 16 different values), so every partial product is one bit on a bit
// of its own and the sum has no carries.  The only ones in bits 24..31 are
// i = j, at 24 + 2j (low) and 25 + 2j (high): byte 3 of the sum is nt j's
// code at bits 2j, 2j + 1, the packed byte.  Bits above 31 fall off the u32,
// bits below 24 are never read.
constexpr uint32_t kPlaneMask = 0x01010101u;
constexpr uint32_t kPlaneLo = (1u << 24) | (1u << 18) | (1u << 12) | (1u << 6);
constexpr uint32_t kPlaneHi = kPlaneLo << 1;

// packed byte of w in bits 24..31, junk below
__device__ __forceinline__ uint32_t gather_planes(uint32_t w) {
  return ((w >> 1) & kPlaneMask) * kPlaneLo + ((w >> 2) & kPlaneMask) * kPlaneHi;
}

// one 16-nt group (4 u32 of 4 nt) -> its packed u32: byte q of the result is
// byte 3 of gather_planes(w_q), assembled with three byte permutes
__device__ __forceinline__ uint32_t pack16_planes(uint4 v) {
  const uint32_t b01 = __byte_perm(gather_planes(v.x), gather_planes(v.y), 0x0073);
  const uint32_t b23 = __byte_perm(gather_planes(v.z), gather_planes(v.w), 0x0073);
  return __byte_perm(b01, b23, 0x5410);
}

// 16-nt groups a thread: 2 aligned 16-byte loads in, one 8-byte store out
// (4 groups and a 16-byte store ran as fast unchecked and 0.6% slower
// checked, with 7 more registers)
constexpr int kPextGroups = 2;
static_assert(kPextGroups == 2, "encode_2bit_pext_kernel stores one uint2 a thread");

// The pext slot, thread-local: a 16-nt group always maps to one output u32,
// so the kernel is elementwise over groups.  Thread t loads groups
// kPextGroups * t .. + kPextGroups - 1 as 16-byte vectors, gathers each
// group's two bit planes in registers (gather_planes: two multiply-masks a
// u32 on the multiply-add pipe, no shuffle, ballot or shared memory) and
// stores their packed u32s as one 8-byte vector.  The last thread takes the
// remaining 1..kPextGroups-1 groups one u32 at a time.  Bound by device
// memory: 4 bytes in and 1 out per 4 nt.
//
// Checked adds the per-row validity flag of encode_2bit_checked_kernel on
// the same loads: rows hold groups_per_row whole groups.  A warp whose
// groups all lie in one row ORs its flags with one __reduce_or_sync and lane
// 0 sends at most one atomicOr; in a warp that straddles a row end (rows of
// 16 or 48 nt also split one thread's groups) each bad group flags its row.
template <bool Checked>
__global__ void __launch_bounds__(kThreads)
encode_2bit_pext_kernel(const uint4* __restrict__ in, uint32_t* __restrict__ out,
                        uint32_t* __restrict__ flags, int64_t n_groups, int64_t groups_per_row) {
  const int lane = threadIdx.x & 31;
  const int64_t g0 = kPextGroups * global_thread();
  const int64_t warp_g0 = g0 - kPextGroups * lane;
  if (warp_g0 >= n_groups) return;  // the whole warp is past the end
  uint32_t bad[kPextGroups] = {};
  if (g0 + kPextGroups <= n_groups) {
    uint4 v[kPextGroups];
#pragma unroll
    for (int k = 0; k < kPextGroups; ++k) v[k] = in[g0 + k];
    uint2 o;
    o.x = pack16_planes(v[0]);
    o.y = pack16_planes(v[1]);
    *reinterpret_cast<uint2*>(out + g0) = o;
    if (Checked) {
#pragma unroll
      for (int k = 0; k < kPextGroups; ++k) bad[k] = invalid16(v[k]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPextGroups; ++k) {
      if (g0 + k < n_groups) {
        const uint4 v = in[g0 + k];
        out[g0 + k] = pack16_planes(v);
        if (Checked) bad[k] = invalid16(v);
      }
    }
  }
  if (Checked) {
    const int64_t warp_last = min(warp_g0 + 32 * kPextGroups, n_groups) - 1;
    const int64_t row0 = warp_g0 / groups_per_row;
    if (row0 == warp_last / groups_per_row) {
      uint32_t any = 0;
#pragma unroll
      for (int k = 0; k < kPextGroups; ++k) any |= bad[k];
      any = __reduce_or_sync(0xFFFFFFFFu, any);
      if (lane == 0 && any != 0) atomicOr(&flags[row0], 1u);
    } else {
      int64_t row = g0 / groups_per_row;
      int64_t next_row_g = (row + 1) * groups_per_row;  // first group of the next row
#pragma unroll
      for (int k = 0; k < kPextGroups; ++k) {
        if (g0 + k == next_row_g) {
          ++row;
          next_row_g += groups_per_row;
        }
        if (bad[k] != 0) atomicOr(&flags[row], 1u);
      }
    }
  }
}

inline unsigned blocks_for(int64_t threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// nt4 u32[n_lanes] -> packed u8[n_lanes]; in 16-byte aligned, out 4-byte aligned
int cn_encode_2bit(const void* in, void* out, int64_t n_lanes, int variant, void* stream) {
  const int64_t threads = (n_lanes + 3) / 4;
  if (threads == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const uint32_t*>(in);
  auto* y = static_cast<uint8_t*>(out);
  switch (variant) {
    case kMul: encode_2bit_kernel<kMul><<<blocks_for(threads), kThreads, 0, s>>>(x, y, n_lanes); break;
    case kShift: encode_2bit_kernel<kShift><<<blocks_for(threads), kThreads, 0, s>>>(x, y, n_lanes); break;
    case kInterleave: encode_2bit_kernel<kInterleave><<<blocks_for(threads), kThreads, 0, s>>>(x, y, n_lanes); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// packed u8[n_bytes] -> nt4 u32[n_bytes]; in 4-byte aligned, out 16-byte aligned
int cn_decode_2bit(const void* in, void* out, int64_t n_bytes, int variant, void* stream) {
  const int64_t threads = (n_bytes + 3) / 4;
  if (threads == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const uint8_t*>(in);
  auto* y = static_cast<uint32_t*>(out);
  switch (variant) {
    case kSwar: decode_2bit_kernel<kSwar><<<blocks_for(threads), kThreads, 0, s>>>(x, y, n_bytes); break;
    case kShuffle: decode_2bit_kernel<kShuffle><<<blocks_for(threads), kThreads, 0, s>>>(x, y, n_bytes); break;
    case kSelect: decode_2bit_kernel<kSelect><<<blocks_for(threads), kThreads, 0, s>>>(x, y, n_bytes); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// nt4 u32[rows, lanes_per_row] -> packed u8[rows, lanes_per_row] and flags
// u32[rows] (OR-ed with 1 where the row holds a bad byte; the caller zeroes
// them).  lanes_per_row % 4 == 0.
int cn_encode_2bit_checked(const void* in, void* out, void* flags, int64_t rows,
                           int64_t lanes_per_row, int variant, void* stream) {
  const int64_t groups_per_row = lanes_per_row / 4;
  const int64_t n_groups = rows * groups_per_row;
  if (n_groups == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const uint32_t*>(in);
  auto* y = static_cast<uint8_t*>(out);
  auto* f = static_cast<uint32_t*>(flags);
  const unsigned blocks = blocks_for(n_groups);
  switch (variant) {
    case kMul: encode_2bit_checked_kernel<kMul><<<blocks, kThreads, 0, s>>>(x, y, f, n_groups, groups_per_row); break;
    case kShift: encode_2bit_checked_kernel<kShift><<<blocks, kThreads, 0, s>>>(x, y, f, n_groups, groups_per_row); break;
    case kInterleave: encode_2bit_checked_kernel<kInterleave><<<blocks, kThreads, 0, s>>>(x, y, f, n_groups, groups_per_row); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// ASCII u8[16 * n_out_u32] -> packed u32[n_out_u32]; in 16-byte aligned, out
// 8-byte aligned.  With flags (not null): flags u32[rows] are OR-ed with 1 where a
// row of nt_per_row nt (a multiple of 16) holds a bad byte; the caller zeroes
// them.
int cn_encode_2bit_pext(const void* in, void* out, void* flags, int64_t n_out_u32,
                        int64_t nt_per_row, void* stream) {
  const int64_t threads = (n_out_u32 + kPextGroups - 1) / kPextGroups;
  if (threads == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const uint4*>(in);
  auto* y = static_cast<uint32_t*>(out);
  auto* f = static_cast<uint32_t*>(flags);
  if (f != nullptr) {
    if (nt_per_row <= 0 || nt_per_row % 16) return static_cast<int>(cudaErrorInvalidValue);
    encode_2bit_pext_kernel<true><<<blocks_for(threads), kThreads, 0, s>>>(x, y, f, n_out_u32, nt_per_row / 16);
  } else {
    encode_2bit_pext_kernel<false><<<blocks_for(threads), kThreads, 0, s>>>(x, y, f, n_out_u32, 1);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
