// Base-5 nucleotide codec kernels for Hopper (sm_90a), plain C interface.
//
// Contract (cute_nucleotides_tpu/ops/spec.py): digit = DIGIT_LUT8[byte & 7],
// so A/a -> 0, C/c -> 1, T/t/U/u -> 2, G/g -> 3, N/n -> 4 (every other byte by
// the same table); 27 nt form one little-endian u64 word of 9 triplets
// c*25 + b*5 + a (a the first nt), 7 bits each, LSB-first, bit 63 zero.
// Decode emits upper-case ACTGN, or the digit bytes 0..4.  A corrupt triplet
// t (125..127) decodes as the host oracle decodes it
// (cute_nucleotides_tpu/native/codec.cpp): digits t % 5, (t / 5) % 5 and
// min(t / 25, 4); bit 63 is ignored.
//
// Both kernels are bound by device memory: 27 bytes and one 8-byte word per
// 27 nt, 35 bytes moved.  One thread owns one word.  A block of 128 threads
// covers 128 words = 3456 bytes = 216 16-byte vectors, staged through shared
// memory, so the byte side moves as coalesced 16-byte vectors and the word
// side as coalesced 8-byte words.  The per-byte work (digit, validity, char)
// is done four bytes at a time on u32 lanes (SWAR), so that the integer
// pipes keep up with the memory.
//
// The word side has two layouts: the reference's interleaved u64 stream, and
// a planar one, two u32 planes with word w = lo[w] | hi[w] << 32 (one
// coalesced 4-byte access per plane in place of the 8-byte one).  The planar
// encode replaces cute_nucleotides_tpu/ops/pallas_kernels.py:
// encode_b5_planar (#15), the planar decode decode_b5_panels (#17, bytes)
// and decode_b5_nt4_panels (#16: the same bytes seen as u32 nt4 lanes, or a
// padded form whose rows hold 8 slices of 112 lanes, 108 of data and 4 of
// 'AAAA').  Their TPU bodies are constant bf16 and int8 matmuls standing in
// for a byte shuffle, and the padding kept a result 128-lane aligned; here
// they are the same kernels with a planar load or store and, for the padded
// form, a store that skips one 16-byte vector after every 27.  Bound by
// memory as the interleaved forms: 35 bytes per 27 nt, the padded decode
// 3584 bytes written per 128 words.
//
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 128;                // words (and threads) per block
constexpr int kNt = 27;                    // nt per word
constexpr int kTileBytes = kWords * kNt;   // 3456
constexpr int kTileVecs = kTileBytes / 16; // 216

constexpr int kSlices = 8;                 // 432-byte slices per row
constexpr int kSliceVecs = kTileVecs / kSlices;      // 27
constexpr int kPadRowVecs = kTileVecs + kSlices;     // 224: a padded row, 896 u32 lanes

constexpr uint32_t kOnes = 0x01010101u;  // bit 0 of each byte

enum DecodeMode { kChars = 0, kChecked = 1, kDigits = 2 };

// The word side of a kernel: the interleaved u64 stream (w64), or the two
// u32 planes (lo, hi) of the planar layout.
struct Words {
  uint64_t* w64;
  uint32_t* lo;
  uint32_t* hi;
};

// The digits of the 4 bytes of v, one per byte, with [digit == 2] and
// [digit == 4] in bit 0 of each byte.  DIGIT_LUT8[b & 7] as bit logic on
// i = b & 7: d0 = i1 i0, d1 = i2 (i0 | !i1), d2 = i2 i1 !i0 (exact on all
// 8 slots: 1 -> 0 (A), 3 -> 1 (C), 4 and 5 -> 2 (T, U), 7 -> 3 (G),
// 6 -> 4 (N), and the dead slots 0 and 2 -> 0).
struct Digits4 {
  uint32_t d, is2, is4;
};

__device__ __forceinline__ Digits4 digits4(uint32_t v) {
  const uint32_t i0 = v & kOnes, i1 = (v >> 1) & kOnes, i2 = (v >> 2) & kOnes;
  const uint32_t d0 = i1 & i0;
  const uint32_t d1 = i2 & (i0 | (i1 ^ kOnes));
  const uint32_t d2 = i2 & i1 & (i0 ^ kOnes);
  return {d0 | (d1 << 1) | (d2 << 2), d1 & ~d0, d2};
}

// digits -> 'A', 'C', 'T', 'G', 'N' in each byte: 'A' + 2d + 15[d == 2] +
// 5[d == 4] (no byte carries)
__device__ __forceinline__ uint32_t chars4(uint32_t d, uint32_t is2, uint32_t is4) {
  return 0x41414141u + (d << 1) + is2 * 15u + is4 * 5u;
}

// 4 digit bytes (each 0..4) -> their 4 chars
__device__ __forceinline__ uint32_t digit_chars4(uint32_t d) {
  const uint32_t d2 = d >> 2;
  return chars4(d, (d >> 1) & ~d & ~d2 & kOnes, d2 & kOnes);
}

// A byte is in {A,C,G,T,U,N} (either case) iff, with bit 5 (case) cleared,
// and bit 0 too where its digit is 2 (U is T with bit 0 set), it equals the
// char its digit decodes to.  Nonzero exactly at the bytes of v outside the
// alphabet (exact on all 256 bytes).
__device__ __forceinline__ uint32_t invalid4(uint32_t v, const Digits4& q) {
  return (v & (0xDFDFDFDFu ^ q.is2)) ^ chars4(q.d, q.is2, q.is4);
}

// Word w of the stream, and its store: the two places that know the word
// layout, chosen by a template parameter.
template <bool Planar>
__device__ __forceinline__ uint64_t load_word(const Words& s, int64_t w) {
  if (Planar) return s.lo[w] | static_cast<uint64_t>(s.hi[w]) << 32;
  return s.w64[w];
}

template <bool Planar>
__device__ __forceinline__ void store_word(const Words& s, int64_t w, uint64_t v) {
  if (Planar) {
    s.lo[w] = static_cast<uint32_t>(v);
    s.hi[w] = static_cast<uint32_t>(v >> 32);
  } else {
    s.w64[w] = v;
  }
}

// Block b encodes words 128b..128b+127 from bytes 3456b..3456b+3455: the tile
// is staged with 16-byte loads (a scalar loop for the last, partial tile);
// thread w then reads the 8 aligned u32 of shared memory that cover its 27
// bytes, realigns them with funnel shifts, takes the digits 4 bytes at a
// time, and writes one 8-byte word (or its two halves).  Checked ORs the validity test of the
// same u32 lanes into one flag per call: one __reduce_or_sync per warp and
// one atomicOr by lane 0 of a warp that saw a bad byte.  Planar stores the
// word's two halves into the two planes.
template <bool Checked, bool Planar>
__global__ void __launch_bounds__(kWords)
encode_b5_kernel(const uint8_t* __restrict__ in, Words out,
                 uint32_t* __restrict__ flag, int64_t n_words) {
  // +16: the last thread's 8-word window reaches past the tile (into bytes
  // it does not use)
  __shared__ __align__(16) uint8_t tile[kTileBytes + 16];
  const int64_t word0 = static_cast<int64_t>(blockIdx.x) * kWords;
  const int words_here = static_cast<int>(n_words - word0 < kWords ? n_words - word0 : kWords);
  const uint8_t* src = in + word0 * kNt;
  if (words_here == kWords) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* t = reinterpret_cast<uint4*>(tile);
    for (int i = threadIdx.x; i < kTileVecs; i += kWords) t[i] = s[i];
  } else {
    for (int i = threadIdx.x; i < words_here * kNt; i += kWords) tile[i] = src[i];
  }
  __syncthreads();
  const int w = threadIdx.x;
  uint32_t bad = 0;
  if (w < words_here) {
    const int start = w * kNt;
    const uint32_t* t32 = reinterpret_cast<const uint32_t*>(tile) + (start >> 2);
    const uint32_t shift = 8u * static_cast<uint32_t>(start & 3);
    uint32_t v[7];  // v[k] holds bytes 4k..4k+3 of the word's 27 (byte 27 unused)
    uint32_t lo = t32[0];
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      const uint32_t hi = t32[k + 1];
      v[k] = __funnelshift_r(lo, hi, shift);
      lo = hi;
    }
    uint32_t d[7];  // digit bytes 4k..4k+3
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      const Digits4 q = digits4(v[k]);
      d[k] = q.d;
      if (Checked) bad |= invalid4(v[k], q) & (k == 6 ? 0x00FFFFFFu : 0xFFFFFFFFu);
    }
    uint64_t word = 0;
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      uint32_t t = 0;
#pragma unroll
      for (int r = 2; r >= 0; --r) {
        const int i = 3 * j + r;
        t = 5u * t + ((d[i >> 2] >> (8 * (i & 3))) & 0xFFu);
      }
      word |= static_cast<uint64_t>(t) << (7 * j);  // t = c*25 + b*5 + a
    }
    store_word<Planar>(out, word0 + w, word);
  }
  if (Checked) {
    const uint32_t any = __reduce_or_sync(0xFFFFFFFFu, bad);
    if ((threadIdx.x & 31) == 0 && any != 0) atomicOr(flag, 1u);
  }
}

// Block b decodes words 128b..128b+127: thread w loads its word (one 8-byte
// load, or one 4-byte load per plane, coalesced across the warp), splits the 9 triplets into digits with
// the exact multiply-shifts t / 5 == (t * 205) >> 10 and t / 25 ==
// (t * 41) >> 10 (t < 1024), and writes its 27 digit bytes into shared
// memory; the block then stores the 3456-byte tile with 16-byte vectors,
// turning digits into chars 4 bytes at a time on the way (a scalar loop for
// the last, partial tile).  Checked flags, once per call, a word with a
// triplet >= 125 or bit 63 set; Digits stores the digit bytes as they are.
// Planar loads the word from the two planes.  Padded (whole tiles only: the
// entry point refuses a partial one) writes the tile as a 3584-byte padded
// row: output vector 28 g + s takes tile vector 27 g + s for s < 27, and
// vector 28 g + 27 is four 'AAAA' lanes.
template <int Mode, bool Planar, bool Padded>
__global__ void __launch_bounds__(kWords)
decode_b5_kernel(Words in, uint8_t* __restrict__ out,
                 uint32_t* __restrict__ flag, int64_t n_words) {
  static_assert(!Padded || Mode == kChars, "the padded form stores chars");
  __shared__ __align__(16) uint8_t tile[kTileBytes];
  const int64_t word0 = static_cast<int64_t>(blockIdx.x) * kWords;
  const int words_here = static_cast<int>(n_words - word0 < kWords ? n_words - word0 : kWords);
  const int w = threadIdx.x;
  uint32_t bad = 0;
  if (w < words_here) {
    const uint64_t v = load_word<Planar>(in, word0 + w);
    if (Mode == kChecked) bad = static_cast<uint32_t>(v >> 63);
    uint8_t* dst = tile + w * kNt;
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      const uint32_t t = static_cast<uint32_t>(v >> (7 * j)) & 0x7Fu;
      if (Mode == kChecked) bad |= (t + 3u) >> 7;  // 1 iff t >= 125 (t <= 127)
      const uint32_t q5 = (t * 205u) >> 10;
      const uint32_t q25 = (t * 41u) >> 10;
      dst[3 * j] = static_cast<uint8_t>(t - 5u * q5);
      dst[3 * j + 1] = static_cast<uint8_t>(q5 - 5u * q25);
      dst[3 * j + 2] = static_cast<uint8_t>(min(q25, 4u));
    }
  }
  __syncthreads();
  if (Padded) {
    const uint4* t = reinterpret_cast<const uint4*>(tile);
    uint4* d = reinterpret_cast<uint4*>(out) + static_cast<int64_t>(blockIdx.x) * kPadRowVecs;
    for (int i = threadIdx.x; i < kPadRowVecs; i += kWords) {
      const int g = i / (kSliceVecs + 1), s = i - (kSliceVecs + 1) * g;
      uint4 q = make_uint4(0x41414141u, 0x41414141u, 0x41414141u, 0x41414141u);
      if (s < kSliceVecs) {
        q = t[kSliceVecs * g + s];
        q.x = digit_chars4(q.x);
        q.y = digit_chars4(q.y);
        q.z = digit_chars4(q.z);
        q.w = digit_chars4(q.w);
      }
      d[i] = q;
    }
    return;
  }
  uint8_t* o = out + word0 * kNt;
  if (words_here == kWords) {
    const uint4* t = reinterpret_cast<const uint4*>(tile);
    uint4* d = reinterpret_cast<uint4*>(o);
    for (int i = threadIdx.x; i < kTileVecs; i += kWords) {
      uint4 q = t[i];
      if (Mode != kDigits) {
        q.x = digit_chars4(q.x);
        q.y = digit_chars4(q.y);
        q.z = digit_chars4(q.z);
        q.w = digit_chars4(q.w);
      }
      d[i] = q;
    }
  } else {
    for (int i = threadIdx.x; i < words_here * kNt; i += kWords) {
      o[i] = static_cast<uint8_t>(Mode == kDigits ? tile[i] : digit_chars4(tile[i]));
    }
  }
  if (Mode == kChecked) {
    const uint32_t any = __reduce_or_sync(0xFFFFFFFFu, bad);
    if ((threadIdx.x & 31) == 0 && any != 0) atomicOr(flag, 1u);
  }
}

inline unsigned blocks_for(int64_t n_words) {
  return static_cast<unsigned>((n_words + kWords - 1) / kWords);
}

}  // namespace

extern "C" {

// ASCII u8[27 * n_words] -> u64[n_words]; in 16-byte aligned, out 8-byte
// aligned.  With flag (not null) the flag u32 is OR-ed with 1 if any byte
// lies outside {A,C,G,T,U,N}; the caller zeroes it.
int cn_encode_b5(const void* in, void* out, void* flag, int64_t n_words, void* stream) {
  if (n_words == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const uint8_t*>(in);
  const Words y{static_cast<uint64_t*>(out), nullptr, nullptr};
  auto* f = static_cast<uint32_t*>(flag);
  if (f != nullptr) {
    encode_b5_kernel<true, false><<<blocks_for(n_words), kWords, 0, s>>>(x, y, f, n_words);
  } else {
    encode_b5_kernel<false, false><<<blocks_for(n_words), kWords, 0, s>>>(x, y, f, n_words);
  }
  return static_cast<int>(cudaGetLastError());
}

// ASCII u8[27 * n_words] -> planes lo, hi u32[n_words] (word w = lo[w] |
// hi[w] << 32); in 16-byte aligned, lo and hi 4-byte aligned.
int cn_encode_b5_planar(const void* in, void* lo, void* hi, int64_t n_words, void* stream) {
  if (n_words == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Words y{nullptr, static_cast<uint32_t*>(lo), static_cast<uint32_t*>(hi)};
  encode_b5_kernel<false, true><<<blocks_for(n_words), kWords, 0, s>>>(
      static_cast<const uint8_t*>(in), y, nullptr, n_words);
  return static_cast<int>(cudaGetLastError());
}

// u64[n_words] -> u8[27 * n_words] (mode 0 chars, 1 chars + flag, 2 digit
// bytes); in 8-byte aligned, out 16-byte aligned.  Mode 1 ORs the flag u32
// with 1 if any word is corrupt; the caller zeroes it.
int cn_decode_b5(const void* in, void* out, void* flag, int64_t n_words, int mode, void* stream) {
  if (n_words == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Words x{static_cast<uint64_t*>(const_cast<void*>(in)), nullptr, nullptr};
  auto* y = static_cast<uint8_t*>(out);
  auto* f = static_cast<uint32_t*>(flag);
  const unsigned blocks = blocks_for(n_words);
  switch (mode) {
    case kChars: decode_b5_kernel<kChars, false, false><<<blocks, kWords, 0, s>>>(x, y, f, n_words); break;
    case kChecked:
      if (f == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      decode_b5_kernel<kChecked, false, false><<<blocks, kWords, 0, s>>>(x, y, f, n_words);
      break;
    case kDigits: decode_b5_kernel<kDigits, false, false><<<blocks, kWords, 0, s>>>(x, y, f, n_words); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Planes lo, hi u32[n_words] -> chars: u8[27 * n_words], or with padded
// (n_words a multiple of 128, else cudaErrorInvalidValue) u8[3584 *
// n_words / 128], rows of 8 slices of 432 chars and 16 'A' each; lo and hi
// 4-byte aligned, out 16-byte aligned.
int cn_decode_b5_planar(const void* lo, const void* hi, void* out, int64_t n_words, int padded, void* stream) {
  if (n_words == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Words x{nullptr, static_cast<uint32_t*>(const_cast<void*>(lo)),
                static_cast<uint32_t*>(const_cast<void*>(hi))};
  auto* y = static_cast<uint8_t*>(out);
  const unsigned blocks = blocks_for(n_words);
  if (padded) {
    if (n_words % kWords) return static_cast<int>(cudaErrorInvalidValue);
    decode_b5_kernel<kChars, true, true><<<blocks, kWords, 0, s>>>(x, y, nullptr, n_words);
  } else {
    decode_b5_kernel<kChars, true, false><<<blocks, kWords, 0, s>>>(x, y, nullptr, n_words);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
