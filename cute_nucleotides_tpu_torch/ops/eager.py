"""The ``torch`` tier: both codecs in plain eager PyTorch.

Counterpart of ``cute_nucleotides_tpu/ops/xla.py``, with the same variant
names and shape contracts:

* ``encode_2bit_words``: u8[..., L] -> u32[..., L // 16], L % 16 == 0
* ``decode_2bit_bytes``: u32[..., W] -> u8[..., 16 * W]
* ``encode_b5_words``:   u8[..., L] -> u32[..., 2 * (L // 27)], L % 27 == 0
* ``decode_b5_bytes``:   u32[..., 2 * W] -> u8[..., 27 * W]

``torch.uint32`` is only a storage type (CPU PyTorch has no ``>>`` on it),
so every formula here computes on int64 lanes holding the unsigned 32-bit
value and converts back at the boundary.  The per-lane formulas are also the
plain versions of the CUDA kernels (:mod:`.kernels`).

A base-5 word whose triplet is 125..127 is corrupt; it decodes as the host
oracle decodes it (``cute_nucleotides_tpu/native/codec.cpp``): the low two
digits are ``t % 5`` and ``(t // 5) % 5``, the high digit ``min(t // 25, 4)``.
Bit 63 is ignored.
"""

from __future__ import annotations

import torch

from . import spec

ENCODE_2BIT_VARIANTS = ("shift", "mul", "interleave", "dot")
DECODE_2BIT_VARIANTS = ("shuffle", "select", "swar", "broadcast")

#: with t = w & 0x06060606 (code*2 in each byte), bits 24..31 of t * MUL_MAGIC
#: are c0 | c1<<2 | c2<<4 | c3<<6
MUL_MAGIC = (1 << 5) | (1 << 11) | (1 << 17) | (1 << 23)
U32 = 0xFFFFFFFF


def u32_to_i64(w: torch.Tensor) -> torch.Tensor:
    """uint32 tensor -> int64 tensor of the same unsigned values."""
    return w.view(torch.int32).to(torch.int64) & U32


def i64_to_u32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> uint32 tensor (wraps through int32)."""
    return v.to(torch.int32).view(torch.uint32)


def bytes_to_lanes(x: torch.Tensor) -> torch.Tensor:
    """u8[..., 4k] -> int64[..., k] little-endian lanes of 4 bytes each."""
    if not x.is_contiguous() or x.stride(-1) != 1 or x.storage_offset() % 4:
        x = x.clone(memory_format=torch.contiguous_format)
    return u32_to_i64(x.view(torch.uint32))


# --- per-lane formulas on int64 lanes ---------------------------------------

def pack4_mul(w: torch.Tensor) -> torch.Tensor:
    """Lane of 4 ASCII nt -> packed byte, multiply-as-bit-shuffle."""
    return (((w & 0x06060606) * MUL_MAGIC) & U32) >> 24


def pack4_shift(w: torch.Tensor) -> torch.Tensor:
    """Lane of 4 ASCII nt -> packed byte, log-depth shift-OR tree."""
    t = (w >> 1) & 0x03030303
    u = t | (t >> 6)
    return (u | (u >> 12)) & 0xFF


def pack4_interleave(w: torch.Tensor) -> torch.Tensor:
    """Lane of 4 ASCII nt -> packed byte, even/odd code planes + fold."""
    e = (w >> 1) & 0x00030003
    o = (w >> 9) & 0x00030003
    m = e | (o << 2)
    return (m | (m >> 12)) & 0xFF


PACK4 = {"mul": pack4_mul, "shift": pack4_shift, "interleave": pack4_interleave}


def _char_shuffle(c: torch.Tensor) -> torch.Tensor:
    return (spec.BITS_TO_CHAR_2BIT_U32 >> (c << 3)) & 0xFF


def _char_select(c: torch.Tensor) -> torch.Tensor:
    return 0x41 + 2 * (c == 1) + 19 * (c == 2) + 6 * (c == 3)


def unpack4_shuffle(b: torch.Tensor) -> torch.Tensor:
    """Packed byte -> lane of 4 ASCII chars via a packed-LUT shift."""
    return (
        _char_shuffle(b & 3)
        | (_char_shuffle((b >> 2) & 3) << 8)
        | (_char_shuffle((b >> 4) & 3) << 16)
        | (_char_shuffle((b >> 6) & 3) << 24)
    )


def unpack4_select(b: torch.Tensor) -> torch.Tensor:
    """Packed byte -> lane of 4 ASCII chars via an arithmetic select tree."""
    return (
        _char_select(b & 3)
        | (_char_select((b >> 2) & 3) << 8)
        | (_char_select((b >> 4) & 3) << 16)
        | (_char_select((b >> 6) & 3) << 24)
    )


def unpack4_swar(b: torch.Tensor) -> torch.Tensor:
    """Packed byte -> lane of 4 ASCII chars, byte-parallel: two carry-free
    spread multiplies, then 'A' + 2*code + 15*[code == 2] per byte."""
    m1 = (b & 0x33) * ((1 << 0) | (1 << 12))
    m2 = (b & 0xCC) * ((1 << 6) | (1 << 18))
    s = (m1 | m2) & 0x03030303
    e = (s >> 1) & (~s) & 0x01010101
    return 0x41414141 + (s << 1) + e * 15


UNPACK4 = {"shuffle": unpack4_shuffle, "select": unpack4_select, "swar": unpack4_swar}


def invalid_bits(w: torch.Tensor) -> torch.Tensor:
    """Nonzero exactly at the bytes of a lane outside {A,C,G,T,U}, either
    case: a byte is valid iff it equals, case-folded, the char its code
    decodes to, with bit 0 forgiven on code 2 (U is T with bit 0 set)."""
    v = w & 0xDFDFDFDF
    s = (w >> 1) & 0x03030303
    e = (s >> 1) & (~s) & 0x01010101
    expect = 0x41414141 + (s << 1) + e * 15
    return (v ^ expect) & ~e


def check_variant(variant: str, variants) -> None:
    if variant not in variants:
        raise ValueError(f"unknown variant {variant!r}; expected one of {tuple(variants)}")


# --- whole-array codec -------------------------------------------------------

def encode_2bit_words(x: torch.Tensor, variant: str = "dot") -> torch.Tensor:
    """Encode u8[..., L] (L % 16 == 0) to packed u32[..., L // 16]."""
    check_variant(variant, ENCODE_2BIT_VARIANTS)
    if x.dtype != torch.uint8:
        raise TypeError(f"expected uint8 bytes, got {x.dtype}")
    L = x.shape[-1]
    if L % spec.NT_PER_U32_2BIT:
        raise ValueError(f"last dim {L} not a multiple of 16")
    lead = x.shape[:-1]
    if variant == "dot":
        # integer weighted sum of the 16 codes (exact at any precision
        # setting, unlike a float matmul)
        c = ((x >> 1) & 3).to(torch.int64).reshape(*lead, L // 16, 16)
        weights = 1 << (2 * torch.arange(16, device=x.device, dtype=torch.int64))
        return i64_to_u32((c * weights).sum(-1))
    packed = PACK4[variant](bytes_to_lanes(x)).reshape(*lead, L // 16, 4)
    word = packed[..., 0] | (packed[..., 1] << 8) | (packed[..., 2] << 16) | (packed[..., 3] << 24)
    return i64_to_u32(word)


def decode_2bit_bytes(words: torch.Tensor, variant: str = "broadcast") -> torch.Tensor:
    """Decode packed u32[..., W] to ASCII u8[..., 16 * W] (full blocks;
    callers truncate to the nucleotide count)."""
    check_variant(variant, DECODE_2BIT_VARIANTS)
    if words.dtype != torch.uint32:
        raise TypeError(f"expected uint32 words, got {words.dtype}")
    lead, W = words.shape[:-1], words.shape[-1]
    if variant == "broadcast":
        shifts = 2 * torch.arange(16, device=words.device, dtype=torch.int64)
        c = (u32_to_i64(words)[..., None] >> shifts) & 3
        return _char_shuffle(c).to(torch.uint8).reshape(*lead, 16 * W)
    b = words.contiguous().view(torch.uint8).to(torch.int64)  # one packed byte per lane
    chars = UNPACK4[variant](b)  # [..., 4W] lanes of 4 chars
    return i64_to_u32(chars).view(torch.uint8).reshape(*lead, 16 * W)


# --- base-5 codec --------------------------------------------------------------

def b5_digits(x: torch.Tensor) -> torch.Tensor:
    """ASCII u8[...] -> base-5 digits int32[...]: ``DIGIT_LUT8[byte & 7]``."""
    return (spec.DIGIT_LUT8_U32 >> ((x & 7).to(torch.int32) << 2)) & 0xF


def b5_word_halves(word: torch.Tensor) -> torch.Tensor:
    """int64 u64 words [..., W] -> their little-endian u32 halves u32[..., 2W]."""
    halves = torch.stack([word & U32, word >> 32], dim=-1)
    return i64_to_u32(halves).reshape(*word.shape[:-1], 2 * word.shape[-1])


def b5_word_triplets(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """u32 halves of u64 words as int64 [...] -> the 9 triplets int64[..., 9]
    (bit 63 dropped)."""
    word = lo | (hi << 32)  # bit 63 may wrap the sign; every mask drops it
    shifts = 7 * torch.arange(spec.TRIPLETS_PER_WORD, device=lo.device, dtype=torch.int64)
    return (word[..., None] >> shifts) & 0x7F


def b5_triplet_digits(t: torch.Tensor) -> torch.Tensor:
    """Triplets [...] -> digits [..., 3] (low first), by the exact
    multiply-shift divisions ``t // 5 == (t * 205) >> 10`` and
    ``t // 25 == (t * 41) >> 10`` (t < 1024); a corrupt triplet (>= 125)
    keeps its high digit at 4."""
    q5 = (t * 205) >> 10
    q25 = (t * 41) >> 10
    return torch.stack([t - 5 * q5, q5 - 5 * q25, q25.clamp(max=4)], dim=-1)


def b5_b8_slots(t: torch.Tensor) -> torch.Tensor:
    """Triplets [...] -> the search's base-8 digit slots ``a | b << 3 |
    c << 6`` [...], by the same multiply-shifts as :func:`b5_triplet_digits`
    but unclamped: a corrupt triplet (125..127) keeps c = 5, so it never
    equals a literal N (4), as in every tier of the reference's search."""
    q5 = (t * 205) >> 10
    q25 = (t * 41) >> 10
    return (t - 5 * q5) | ((q5 - 5 * q25) << 3) | (q25 << 6)


def b5_digit_chars(d: torch.Tensor) -> torch.Tensor:
    """Digits 0..4 -> ASCII 'ACTGN' (``spec.DIG_TO_CHAR_B5``), as
    'A' + 2d + 15[d == 2] + 5[d == 4]."""
    return 0x41 + 2 * d + 15 * (d == 2) + 5 * (d == 4)


def encode_b5_words(x: torch.Tensor) -> torch.Tensor:
    """Encode u8[..., L] (L % 27 == 0) to packed u32[..., 2 * (L // 27)]:
    the little-endian u32 halves of the reference's u64 words.

    Each word is one integer weighted sum of its 27 digits, digit ``3j + r``
    weighing ``5**r << 7j`` (no float matmul, so no precision setting can
    change it); every term and the sum stay below 2**63.
    """
    if x.dtype != torch.uint8:
        raise TypeError(f"expected uint8 bytes, got {x.dtype}")
    L = x.shape[-1]
    if L % spec.NT_PER_WORD_B5:
        raise ValueError(f"last dim {L} not a multiple of 27")
    lead, W = x.shape[:-1], L // spec.NT_PER_WORD_B5
    d = b5_digits(x).to(torch.int64).reshape(*lead, W, spec.NT_PER_WORD_B5)
    i = torch.arange(spec.NT_PER_WORD_B5, device=x.device, dtype=torch.int64)
    weights = torch.tensor([1, 5, 25], device=x.device, dtype=torch.int64)[i % 3] << (7 * (i // 3))
    return b5_word_halves((d * weights).sum(-1))


def decode_b5_bytes(words: torch.Tensor) -> torch.Tensor:
    """Decode packed u32[..., 2 * W] to ASCII u8[..., 27 * W] (full blocks;
    callers truncate to the nucleotide count)."""
    if words.dtype != torch.uint32:
        raise TypeError(f"expected uint32 words, got {words.dtype}")
    if words.shape[-1] % 2:
        raise ValueError("base-5 packed stream must have even u32 count")
    lead, W = words.shape[:-1], words.shape[-1] // 2
    pair = u32_to_i64(words).reshape(*lead, W, 2)
    d = b5_triplet_digits(b5_word_triplets(pair[..., 0], pair[..., 1]))
    return b5_digit_chars(d).to(torch.uint8).reshape(*lead, spec.NT_PER_WORD_B5 * W)
