"""Shared data-layout contracts for the nucleotide codecs.

The port's own copy of ``cute_nucleotides_tpu/ops/spec.py`` (numpy only),
with the same names and values; ``tests/test_torch_hostcopies.py`` holds the
two equal.  Every tier of the port (NumPy oracle, C++ oracle, eager torch,
CUDA kernels) is tested bit-exact against these contracts.

The contracts mirror the reference library's observable behavior
(``cute-nucleotides``):

2-bit codec (reference: src/n_to_bits.rs)
-----------------------------------------
* Code: ``A -> 0b00, C -> 0b01, T -> 0b10, U -> 0b10, G -> 0b11``,
  case-insensitive (reference src/n_to_bits.rs:8-21).
* Packing: LSB-first into 64-bit words — nucleotide ``i`` occupies bits
  ``[2*(i%32), 2*(i%32)+1]`` of word ``i//32``; output has ``ceil(len/32)``
  words, unused high bits zero (reference src/n_to_bits.rs:35-43).
* Decode emits uppercase ASCII and always ``T`` (never ``U``)
  (reference src/n_to_bits.rs:23-30).

Base-5 codec (reference: src/n_to_bits2.rs)
-------------------------------------------
* Digits: ``A->0, C->1, T->2, U->2, G->3, N->4``, case-insensitive
  (reference src/n_to_bits2.rs:8-23).
* A triplet ``(a, b, c)`` of consecutive nucleotides encodes as
  ``c*25 + b*5 + a`` in 7 bits (reference src/n_to_bits2.rs:49-53).
* 9 triplets pack LSB-first into the low 63 bits of a u64; output has
  ``ceil(len/27)`` words (reference src/n_to_bits2.rs:44-47).
* A trailing 1- or 2-nucleotide group encodes with the missing digits as 0
  (reference src/n_to_bits2.rs:58-70).

Word representation on device
-----------------------------
The TPU VPU is a 32-bit machine, so the device-side canonical packed form is
``uint32``.  A logical u64 word is a little-endian pair of u32s; the exact u64
stream of the reference is recovered by viewing the (C-contiguous, host)
uint32 array as ``np.uint64`` (little-endian byte order, verified on-device:
``lax.bitcast_convert_type`` of ``u8[..., 4] -> u32`` is little-endian).

Out-of-alphabet bytes
---------------------
The reference leaves these undefined (scalar LUT maps them to 0 / 'A', vector
paths extract ASCII bits 1-2, bytes >= 128 are UB — src/n_to_bits.rs:42).
This framework *defines* the behavior instead:

* 2-bit codec: every byte encodes as ``(byte >> 1) & 3`` (the ASCII-bit
  extraction the reference's vector tiers use).  The oracle and all kernels
  agree.
* Base-5 codec: every byte encodes as ``DIGIT_LUT8[byte & 7]`` (the shuffle
  LUT the reference's vector tier uses; entries not covered by
  ``{A,C,G,T,U,N}`` map to digit 0).  The oracle and all kernels agree.
* An optional validation pass (:mod:`cute_nucleotides_tpu.ops.validate`)
  detects out-of-alphabet input for callers who want strictness.
"""

from __future__ import annotations

import numpy as np

# --- 2-bit codec -----------------------------------------------------------

#: nucleotides per logical u64 word
NT_PER_WORD_2BIT = 32
#: nucleotides per device u32 word
NT_PER_U32_2BIT = 16

#: 2-bit code values (== ASCII bits 1-2 of the letter, upper or lower case)
CODE_A, CODE_C, CODE_T, CODE_G = 0b00, 0b01, 0b10, 0b11

#: decode table, code -> ASCII (always uppercase, always T)
BITS_TO_CHAR_2BIT = np.frombuffer(b"ACTG", dtype=np.uint8).copy()

#: packed decode LUT as a single u32: char(code) == (LUT >> (8*code)) & 0xFF
BITS_TO_CHAR_2BIT_U32 = int(
    int(BITS_TO_CHAR_2BIT[0])
    | (int(BITS_TO_CHAR_2BIT[1]) << 8)
    | (int(BITS_TO_CHAR_2BIT[2]) << 16)
    | (int(BITS_TO_CHAR_2BIT[3]) << 24)
)


def make_byte_lut_2bit() -> np.ndarray:
    """256-entry byte -> 2-bit-code table.

    Defined for *all* bytes as ``(byte >> 1) & 3`` so the scalar oracle and
    the vector kernels agree everywhere (see module docstring).  On the
    alphabet ``{A,C,G,T,U,a,c,g,t,u}`` this equals the reference's LUT
    (reference src/n_to_bits.rs:8-21).
    """
    b = np.arange(256, dtype=np.uint8)
    return ((b >> 1) & 3).astype(np.uint8)


BYTE_LUT_2BIT = make_byte_lut_2bit()

# --- base-5 codec ----------------------------------------------------------

#: nucleotides per logical u64 word (9 triplets * 3 nt)
NT_PER_WORD_B5 = 27
#: triplets per word
TRIPLETS_PER_WORD = 9
#: bits per triplet
BITS_PER_TRIPLET = 7

#: digit values
DIG_A, DIG_C, DIG_T, DIG_G, DIG_N = 0, 1, 2, 3, 4

#: decode table, digit -> ASCII (uppercase, T not U)
DIG_TO_CHAR_B5 = np.frombuffer(b"ACTGN", dtype=np.uint8).copy()

#: 8-entry digit LUT keyed on ``char & 7``.  The low 3 bits of ASCII are
#: unique and case-insensitive across {A,C,T,U,G,N}: A/a=1, C/c=3, T/t=4,
#: U/u=5, N/n=6, G/g=7 (reference src/n_to_bits2.rs:127-136 uses the same
#: property for its shuffle LUT).  Uncovered indices (0, 2) map to digit 0.
DIGIT_LUT8 = np.zeros(8, dtype=np.uint8)
DIGIT_LUT8[1] = DIG_A
DIGIT_LUT8[3] = DIG_C
DIGIT_LUT8[4] = DIG_T
DIGIT_LUT8[5] = DIG_T  # U encodes as T
DIGIT_LUT8[6] = DIG_N
DIGIT_LUT8[7] = DIG_G

#: the same LUT packed into one u32 with 4-bit fields:
#: digit(idx) == (LUT >> (4*idx)) & 0xF
DIGIT_LUT8_U32 = int(sum(int(d) << (4 * i) for i, d in enumerate(DIGIT_LUT8)))


def make_byte_lut_b5() -> np.ndarray:
    """256-entry byte -> base-5-digit table: ``DIGIT_LUT8[byte & 7]``.

    Matches the reference's LUT on the alphabet (reference
    src/n_to_bits2.rs:8-23) and its vector tier everywhere else.
    """
    b = np.arange(256, dtype=np.uint8)
    return DIGIT_LUT8[b & 7]


BYTE_LUT_B5 = make_byte_lut_b5()

# bit offset of triplet j inside the 63-bit word
TRIPLET_BIT_OFFSETS = tuple(7 * j for j in range(TRIPLETS_PER_WORD))


# --- helpers ---------------------------------------------------------------

def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def num_words_2bit(n: int) -> int:
    """Logical u64 word count for an n-nucleotide 2-bit encode."""
    return cdiv(n, NT_PER_WORD_2BIT)


def num_words_b5(n: int) -> int:
    """Logical u64 word count for an n-nucleotide base-5 encode."""
    return cdiv(n, NT_PER_WORD_B5)


def u64_to_u32_pairs(words: np.ndarray) -> np.ndarray:
    """View little-endian u64 words as the device u32-pair representation."""
    words = np.ascontiguousarray(words, dtype=np.uint64)
    return words.view("<u8").view("<u4").reshape(words.shape + (2,))


def u32_pairs_to_u64(pairs: np.ndarray) -> np.ndarray:
    """Inverse of :func:`u64_to_u32_pairs` (little-endian serialization)."""
    pairs = np.ascontiguousarray(pairs, dtype=np.uint32)
    assert pairs.shape[-1] % 2 == 0
    return pairs.view("<u8").reshape(pairs.shape[:-1] + (pairs.shape[-1] // 2,))
