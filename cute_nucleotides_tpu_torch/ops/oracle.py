"""Scalar-spec ("oracle") tier: pure-NumPy reference implementations.

The port's own copy of ``cute_nucleotides_tpu/ops/oracle.py``.  These are
the trivially-correct forms of the four core operations.  They are the test
oracle for every other tier (eager torch, CUDA, C++), mirror the role of
the reference's scalar LUT tier (reference src/n_to_bits.rs:34-69 and
src/n_to_bits2.rs:37-107), and define behavior for *all* byte values (the
reference leaves out-of-alphabet input undefined; see
:mod:`cute_nucleotides_tpu.ops.spec`).

All functions are host-side NumPy; they accept ``bytes`` / ``bytearray`` /
1-D ``uint8`` arrays and return NumPy arrays.  Logical u64 words use the
exact little-endian bit layout of the reference (golden vectors from the
reference's inline tests, src/n_to_bits.rs:408-470 and
src/n_to_bits2.rs:270-299, are asserted in tests/test_oracle.py).
"""

from __future__ import annotations

import numpy as np

from . import spec

__all__ = [
    "n_to_bits_lut",
    "bits_to_n_lut",
    "n_to_bits2_lut",
    "bits_to_n2_lut",
]


def _as_u8(seq) -> np.ndarray:
    if isinstance(seq, (bytes, bytearray, memoryview)):
        return np.frombuffer(bytes(seq), dtype=np.uint8)
    a = np.asarray(seq)
    if a.dtype != np.uint8:
        raise TypeError(f"expected uint8 nucleotide bytes, got {a.dtype}")
    if a.ndim != 1:
        raise ValueError("oracle functions take 1-D sequences")
    return a


# --- 2-bit codec -----------------------------------------------------------

def n_to_bits_lut(seq) -> np.ndarray:
    """Encode nucleotides to 2-bit packed u64 words (scalar spec form).

    Nucleotide ``i`` occupies bits ``[2*(i%32), 2*(i%32)+1]`` of word
    ``i//32``; output has ``ceil(len/32)`` words with unused high bits zero
    (contract of reference src/n_to_bits.rs:34-47).
    """
    n = _as_u8(seq)
    codes = spec.BYTE_LUT_2BIT[n].astype(np.uint64)
    nwords = spec.num_words_2bit(len(n))
    out = np.zeros(nwords, dtype=np.uint64)
    for i, c in enumerate(codes):
        out[i >> 5] |= c << np.uint64(2 * (i & 31))
    return out


def bits_to_n_lut(bits, length: int) -> np.ndarray:
    """Decode 2-bit packed u64 words back to ASCII (scalar spec form).

    ``length`` is the nucleotide count (the stream does not self-terminate).
    Raises ``ValueError`` when ``length`` exceeds capacity, mirroring the
    reference's panic (reference src/n_to_bits.rs:52-54).
    """
    bits = np.ascontiguousarray(bits, dtype=np.uint64)
    if length > bits.size * spec.NT_PER_WORD_2BIT:
        raise ValueError(
            f"length {length} exceeds capacity {bits.size * spec.NT_PER_WORD_2BIT}"
        )
    out = np.empty(length, dtype=np.uint8)
    for i in range(length):
        code = (bits[i >> 5] >> np.uint64(2 * (i & 31))) & np.uint64(3)
        out[i] = spec.BITS_TO_CHAR_2BIT[code]
    return out


# --- base-5 codec ----------------------------------------------------------

def n_to_bits2_lut(seq) -> np.ndarray:
    """Encode {A,C,G,T/U,N} to base-5 packed u64 words (scalar spec form).

    A triplet ``(a, b, c)`` encodes as ``c*25 + b*5 + a`` in 7 bits; 9
    triplets pack LSB-first into the low 63 bits of each word; a trailing
    1- or 2-nt group encodes with missing digits as 0 (contract of reference
    src/n_to_bits2.rs:37-74).
    """
    n = _as_u8(seq)
    digits = spec.BYTE_LUT_B5[n].astype(np.uint64)
    nwords = spec.num_words_b5(len(n))
    out = np.zeros(nwords, dtype=np.uint64)
    ntrip = spec.cdiv(len(n), 3)
    for t in range(ntrip):
        a = digits[3 * t]
        b = digits[3 * t + 1] if 3 * t + 1 < len(n) else np.uint64(0)
        c = digits[3 * t + 2] if 3 * t + 2 < len(n) else np.uint64(0)
        val = c * np.uint64(25) + b * np.uint64(5) + a
        out[t // spec.TRIPLETS_PER_WORD] |= val << np.uint64(
            spec.BITS_PER_TRIPLET * (t % spec.TRIPLETS_PER_WORD)
        )
    return out


def bits_to_n2_lut(bits, length: int) -> np.ndarray:
    """Decode base-5 packed u64 words back to ASCII (scalar spec form).

    Raises ``ValueError`` when ``length`` exceeds ``len(bits)*27``, mirroring
    the reference's panic (reference src/n_to_bits2.rs:78-80).
    """
    bits = np.ascontiguousarray(bits, dtype=np.uint64)
    if length > bits.size * spec.NT_PER_WORD_B5:
        raise ValueError(
            f"length {length} exceeds capacity {bits.size * spec.NT_PER_WORD_B5}"
        )
    out = np.empty(length, dtype=np.uint8)
    ntrip = spec.cdiv(length, 3)
    for t in range(ntrip):
        word = bits[t // spec.TRIPLETS_PER_WORD]
        val = int(
            (word >> np.uint64(spec.BITS_PER_TRIPLET * (t % spec.TRIPLETS_PER_WORD)))
            & np.uint64(0x7F)
        )
        trip = (val % 5, (val // 5) % 5, val // 25)
        for k in range(3):
            i = 3 * t + k
            if i < length:
                out[i] = spec.DIG_TO_CHAR_B5[trip[k]]
    return out
