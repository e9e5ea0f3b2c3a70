"""Operations on packed streams.

Counterpart of ``cute_nucleotides_tpu/ops/seqops.py``, with its names,
argument checks, errors and results bit for bit: complement and reverse
complement, GC content and base composition, the base-5 digit counts and
stream-integrity scan, region slices and concatenation, codon translation
and exact read deduplication, for both codecs.  Everything here is eager
torch on the words' device except the GC count of a long flat base-5 stream,
which is kernel #7 (:func:`.kernels.gc_b5_stream`) as in the reference.

2-bit: complement is ``XOR 0xAAAAAAAA`` (A<->T is 00<->10, C<->G 01<->11),
and GC content is a masked popcount: C (01) and G (11) are exactly the codes
with bit 0 set, and 'A' padding (00) counts nothing.  torch has no popcount
and no ``>>`` on uint32, so the counts and funnels run on int64 lanes.

Base-5: a u64 word (two u32 halves) holds 9 triplets ``t = a + 5b + 25c``
of 7 bits; bit 63 is in none.  The functions work on whole words in int64
lanes and split triplets with the reference's exact multiply-shifts,
UNCLAMPED: the high digit of a corrupt triplet (125..127) is 5, as in every
form of the reference (``eager.b5_triplet_digits`` clamps it to 4 for the
decode and must not be used here).  The GC count of a triplet is the
reference's parity formula, so t = 125 counts 1 where a decode reads 'AAN'.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import eager, spec

__all__ = [
    "complement_packed",
    "revcomp_packed",
    "gc_content_packed",
    "gc_bins_packed",
    "gc_content_bytes",
    "base_composition_packed",
    "gc_content_packed_b5",
    "n_count_packed_b5",
    "revcomp_packed_b5",
    "first_invalid_word_b5",
    "packed_slice",
    "packed_concat",
    "packed_slice_b5",
    "packed_concat_b5",
    "translate_packed",
    "translate_6frame",
    "translate_packed_b5",
    "translate_6frame_b5",
    "duplicate_mask",
]

_FIELD = 0x55555555  # bit 0 of each 2-bit field
_COMP = 0xAAAAAAAA  # bit 1 of each 2-bit field: XOR complements a nucleotide
_NT = spec.NT_PER_U32_2BIT
_NT5 = spec.NT_PER_WORD_B5
_TRIPLETS = spec.TRIPLETS_PER_WORD
#: flat base-5 streams of at least this many u32 take kernel #7 (the
#: reference's route to its Pallas kernel, seqops.py:318)
GC_B5_KERNEL_MIN_U32 = 1024


def popcount32(v: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit value in an int64 tensor (SWAR)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24) & 0xFF


def _field_count(m: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of the set bits of int64 lanes whose bits lie
    only at even positions (``x & 0x55555555``): the SWAR steps to per-byte
    counts, then one byte sum (fewer launches than a per-lane popcount,
    which matters on the one-record-at-a-time ``stats`` path)."""
    v = (m & 0x33333333) + ((m >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return v.view(torch.uint8).sum(-1, dtype=torch.int64)


def _check_words(words: torch.Tensor) -> torch.Tensor:
    if words.dtype != torch.uint32:
        raise TypeError(f"expected uint32 words, got {words.dtype}")
    return eager.u32_to_i64(words)


def _zeros_u32(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(n, dtype=torch.uint32, device=like.device)


def _window(words: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Elements ``[lo, hi)`` of a flat u32 stream as int64 lanes, 0 where
    the index lies outside the stream (either side)."""
    a, b = max(lo, 0), min(hi, words.shape[0])
    mid = _check_words(words[a:b]) if b > a else torch.zeros(0, dtype=torch.int64, device=words.device)
    front = min(max(-lo, 0), hi - lo)
    back = hi - lo - front - mid.shape[0]
    return torch.cat([mid.new_zeros(front), mid, mid.new_zeros(back)])


# --- 2-bit: complement, reverse complement, GC, composition ---------------------

def complement_packed(words: torch.Tensor) -> torch.Tensor:
    """Complement every nucleotide of a 2-bit packed u32 stream.

    Also flips 'A' padding in the tail word to 'T'; pair with a length mask
    (or use :func:`revcomp_packed`, which re-zeroes the tail).
    """
    if words.dtype != torch.uint32:
        raise TypeError(f"expected uint32 words, got {words.dtype}")
    return (words.view(torch.int32) ^ (_COMP - (1 << 32))).view(torch.uint32)


def _reverse_within_u32(w: torch.Tensor) -> torch.Tensor:
    """Reverse the 16 2-bit fields inside each u32 value of int64 lanes
    (SWAR: a byte swap, then the four fields of each byte)."""
    w = ((w & 0xFF) << 24) | ((w & 0xFF00) << 8) | ((w >> 8) & 0xFF00) | (w >> 24)
    return (((w & 0x03030303) << 6) | ((w & 0x0C0C0C0C) << 2)
            | ((w >> 2) & 0x0C0C0C0C) | ((w >> 6) & 0x03030303))


def revcomp_packed(words: torch.Tensor, length: int) -> torch.Tensor:
    """Reverse-complement a 2-bit packed u32[W] stream of ``length`` nt.

    Returns the packed stream of the reverse complement with the same word
    count and zeroed ('A'-coded) tail bits, bit-exact to encoding the
    reverse complement of the decoded sequence.  The reversed stream starts
    at bit ``2 (16 W - length)``: a funnel over each word and the one before
    it (complemented and field-reversed first), then a lane reversal.
    """
    if words.ndim != 1:
        raise TypeError("revcomp_packed takes a flat u32 word stream")
    W = words.shape[0]
    if length > W * _NT:
        raise ValueError(f"length {length} exceeds capacity {W * 16}")
    lane_sh, bit_sh = divmod(2 * (W * _NT - length), 32)
    g = _reverse_within_u32(_check_words(words) ^ _COMP)
    if bit_sh:
        # the word before the stream reads as all-'T' (0xAAAAAAAA), which
        # complements and reverses to 0
        prev = torch.cat([g.new_zeros(1), g[:-1]])
        g = ((g >> bit_sh) | (prev << (32 - bit_sh))) & eager.U32
        if lane_sh == 0:
            g[0] &= eager.U32 >> bit_sh  # the tail beyond `length`, last after the reversal
    rev = g.flip(0)
    if lane_sh:
        rev = torch.cat([rev[lane_sh:], rev.new_zeros(lane_sh)])
    return eager.i64_to_u32(rev)


def gc_content_packed(words: torch.Tensor) -> torch.Tensor:
    """Count of C+G nucleotides per stream: u32[..., W] -> i32[...].

    'A' padding counts 0, so ragged tails need no masking.
    """
    return _field_count(_check_words(words) & _FIELD).to(torch.int32)


def gc_bins_packed(words: torch.Tensor, bin_nt: int = 1024) -> torch.Tensor:
    """Binned GC profile: u32[..., W] -> i32[..., ceil(16 W / bin_nt)].

    Each word's GC count is one masked popcount and a bin sums ``bin_nt //
    16`` of them; ``bin_nt`` must be a multiple of 16 so bins align to
    words.  'A' padding counts 0, so the tail bin needs no masking (its
    denominator is the caller's bookkeeping).
    """
    if bin_nt <= 0 or bin_nt % 16:
        raise ValueError("bin_nt must be a positive multiple of 16 (word alignment)")
    wpb = bin_nt // 16
    per_word = popcount32(_check_words(words) & _FIELD)
    pad = (-per_word.shape[-1]) % wpb
    if pad:
        per_word = torch.nn.functional.pad(per_word, (0, pad))
    return per_word.reshape(*per_word.shape[:-1], -1, wpb).sum(-1).to(torch.int32)


def gc_content_bytes(reads: torch.Tensor) -> torch.Tensor:
    """Count of C+G per read from ASCII bytes (case-insensitive): bit 1 of
    the byte is bit 0 of its 2-bit code, set for C and G only."""
    return ((reads >> 1) & 1).sum(-1, dtype=torch.int32)


def base_composition_packed(words: torch.Tensor, length: int | None = None) -> torch.Tensor:
    """Per-base counts of a 2-bit packed stream: u32[..., W] -> i32[..., 4]
    in code order (A, C, T, G).

    With ``hi``/``lo`` the per-field code bits, three masked popcounts --
    of lo (C + G), hi (T + G) and hi & lo (G) -- give C, T and G, and A is
    the rest.  ``length`` subtracts the 'A'-coded tail padding from the A
    column, and raises ``ValueError`` when it exceeds the capacity ``16 W``.
    """
    w = _check_words(words)
    cap = words.shape[-1] * _NT
    if length is not None:
        if length > cap:
            raise ValueError(f"length {length} exceeds capacity")
        cap = length
    lo, hi = w & _FIELD, (w >> 1) & _FIELD
    n_lo, n_hi, g = _field_count(torch.stack([lo, hi, hi & lo])).unbind(0)
    return torch.stack([cap - n_lo - n_hi + g, n_lo - g, n_hi - g, g], dim=-1).to(torch.int32)


# --- base-5: digit counts, integrity, reverse complement -------------------------

def _b5_digits(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Triplet values -> (a, b, c) digits by the exact multiply-shifts
    ``t // 5 == (t * 205) >> 10`` and ``t // 25 == (t * 41) >> 10``,
    unclamped: a corrupt triplet (125..127) has c = 5."""
    q5 = (t * 205) >> 10
    q25 = (t * 41) >> 10
    return t - 5 * q5, q5 - 5 * q25, q25


def _b5_words(words: torch.Tensor) -> torch.Tensor:
    """Base-5 stream u32[..., 2W] -> its u64 words as int64[..., W] (bit 63
    lands on the sign; every triplet mask drops it)."""
    if words.shape[-1] % 2:
        raise ValueError("base-5 packed stream must have even u32 count")
    pair = _check_words(words).reshape(*words.shape[:-1], words.shape[-1] // 2, 2)
    return pair[..., 0] | (pair[..., 1] << 32)


def _b5_triplet(word: torch.Tensor, j: int) -> torch.Tensor:
    return (word >> (7 * j)) & 0x7F


def _b5_pack(vals: torch.Tensor) -> torch.Tensor:
    """Triplet values int64[W, 9] (each below 256) -> u32[2W]: value j OR-ed
    in at bit 7 j of its word, as the reference assembles words (a value of
    128 or more, only from corrupt input, spills into the next field)."""
    word = vals[:, 0].clone()
    for j in range(1, _TRIPLETS):
        word |= vals[:, j] << (7 * j)
    return eager.b5_word_halves(word).reshape(-1)


def b5_word_gc(word: torch.Tensor) -> torch.Tensor:
    """GC count of each base-5 u64 word (int64 lanes): over its 9 triplets,
    ``((t ^ u) & 1) + ((u ^ v) & 1) + (v & 1)`` with ``u = t // 5`` and
    ``v = t // 25`` -- the low bits of the digits a, b, c (5d and d share
    parity), C (1) and G (3) being the odd digits.  Zero words count 0."""
    acc = torch.zeros_like(word)
    for j in range(_TRIPLETS):
        t = _b5_triplet(word, j)
        u = (t * 205) >> 10
        v = (t * 41) >> 10
        acc += ((t ^ u) & 1) + ((u ^ v) & 1) + (v & 1)
    return acc


def gc_content_packed_b5(words: torch.Tensor) -> torch.Tensor:
    """Count of C+G nucleotides per base-5 stream: u32[..., 2W] -> i32[...].

    Digits C (1) and G (3) are exactly those with bit 0 set (A = 0, T = 2,
    N = 4 are even), so the count sums the digits' low bits
    (:func:`b5_word_gc`); 'A' padding counts 0, so ragged tails need no
    masking.  A flat stream of at least 1024 u32 and even length goes to
    kernel #7 (:func:`.kernels.gc_b5_stream`), the reference's route to its
    Pallas kernel; the result is the same.
    """
    if words.ndim == 1 and words.shape[0] >= GC_B5_KERNEL_MIN_U32 and not words.shape[0] % 2:
        from . import kernels  # kernels imports this module

        return kernels.gc_b5_stream(words)
    return b5_word_gc(_b5_words(words)).sum(-1).to(torch.int32)


def n_count_packed_b5(words: torch.Tensor) -> torch.Tensor:
    """Count of N nucleotides per base-5 stream: u32[..., 2W] -> i32[...].

    N is digit 4, the only digit with bit 2 set: ``sum(digit >> 2)`` over
    the unclamped digits (the high digit 5 of a corrupt triplet counts too).
    """
    word = _b5_words(words)
    acc = torch.zeros_like(word)
    for j in range(_TRIPLETS):
        a, b, c = _b5_digits(_b5_triplet(word, j))
        acc += (a >> 2) + (b >> 2) + (c >> 2)
    return acc.sum(-1).to(torch.int32)


def first_invalid_word_b5(words: torch.Tensor) -> torch.Tensor:
    """Index of the first corrupt u64 word of a base-5 stream (a triplet
    value >= 125, or pad bit 63 set), else -1: u32[..., 2W] -> int32[...].

    The 2-bit stream has no invalid states, but base-5 words leave 3 of 128
    triplet codes and one bit unused, so a scan catches container
    corruption.  Runs on the tensor's device.
    """
    if words.dtype != torch.uint32:
        raise TypeError(f"expected uint32 words, got {words.dtype}")
    if words.shape[-1] % 2:
        raise ValueError("base-5 packed stream must have even u32 count")
    lead, W = words.shape[:-1], words.shape[-1] // 2
    if W == 0:
        return torch.full(lead, -1, dtype=torch.int32, device=words.device)
    pair = eager.u32_to_i64(words).reshape(*lead, W, 2)
    t = eager.b5_word_triplets(pair[..., 0], pair[..., 1])
    bad = (t >= 125).any(-1) | ((pair[..., 1] >> 31) != 0)
    idx = bad.to(torch.uint8).argmax(-1)  # first maximum: the first bad word
    return torch.where(bad.any(-1), idx, -1).to(torch.int32)


def _b5_digit_stream(word: torch.Tensor) -> torch.Tensor:
    """u64 words int64[W] -> their unclamped digits int64[27 W] in stream
    order (digit 3 j + r of a word is digit r of its triplet j)."""
    t = eager.b5_word_triplets(word & eager.U32, (word >> 32) & eager.U32)
    return torch.stack(_b5_digits(t), dim=-1).reshape(-1)


def revcomp_packed_b5(words: torch.Tensor, length: int) -> torch.Tensor:
    """Reverse-complement a base-5 packed u32[2W] stream of ``length`` nt.

    Digit complement is ``d ^ 2`` for d < 4 with N (4) fixed (and a corrupt
    high digit 5 fixed, as in the reference), and reversal renumbers digit
    positions ``p -> L-1-p``.  Returns the stream of the reverse complement
    with the same word count, zero tail digits and zero pad bits -- bit-exact
    to encoding the reverse complement (with N) of the decoded sequence.
    Only the words that hold the first ``length`` nt are read: trailing
    slack words are zero on both sides.
    """
    if words.ndim != 1 or words.shape[0] % 2:
        raise TypeError("revcomp_packed_b5 takes a flat interleaved u32[2W] stream")
    w_cap = words.shape[0] // 2
    if length > w_cap * _NT5:
        raise ValueError(f"length {length} exceeds capacity {w_cap * 27}")
    if w_cap == 0 or length == 0:
        return torch.zeros_like(words)
    W = spec.cdiv(length, _NT5)
    d = _b5_digit_stream(_b5_words(words[: 2 * W]))[:length].flip(0)
    d = d ^ ((d < 4).to(torch.int64) << 1)
    d = torch.cat([d, d.new_zeros(_NT5 * W - length)]).view(W, _TRIPLETS, 3)
    out = _b5_pack(d[..., 0] + 5 * d[..., 1] + 25 * d[..., 2])
    if W < w_cap:
        out = torch.cat([out.view(torch.int32), out.new_zeros(2 * (w_cap - W), dtype=torch.int32)])
    return out.view(torch.uint32)


# --- region extraction and concatenation ----------------------------------------
# samtools-faidx-style subsequence access without a decode: a funnel shift
# over the packed words (2-bit) or over the triplets (base-5).  Positions
# outside the stream read as 'A' (digit 0), the padding convention
# everywhere, and a negative ``start`` places the stream at offset
# ``-start`` inside the window, which is what concatenation needs.

def packed_slice(words: torch.Tensor, start: int, n: int) -> torch.Tensor:
    """Extract nucleotides ``[start, start + n)`` of a 2-bit packed stream.

    u32[W] -> u32[2 ceil(n/32)] with zeroed tail bits -- bit-exact to
    re-encoding ``decode(words)[start:start+n]``: each output word is a
    funnel of two input words.  Only the input words the window covers are
    read.
    """
    if words.ndim != 1:
        raise TypeError("packed_slice takes a flat u32 word stream")
    if n < 0:
        raise ValueError("n must be >= 0")
    if n == 0:
        return _zeros_u32(0, words)
    w_used = spec.cdiv(n, _NT)  # u32 lanes carrying data
    w_out = 2 * spec.cdiv(n, 32)  # whole u64 words
    lane_sh, half = divmod(start, _NT)
    bit_sh = 2 * half
    cur = _window(words, lane_sh, lane_sh + w_used + (1 if bit_sh else 0))
    if bit_sh:
        cur = ((cur[:-1] >> bit_sh) | (cur[1:] << (32 - bit_sh))) & eager.U32
    r = n % _NT
    if r:
        cur[-1] &= (1 << (2 * r)) - 1
    if w_out > w_used:  # the hi u32 of a half-filled final u64 word
        cur = torch.cat([cur, cur.new_zeros(w_out - w_used)])
    return eager.i64_to_u32(cur)


def packed_concat(a: torch.Tensor, len_a: int, b: torch.Tensor, len_b: int) -> torch.Tensor:
    """Concatenate two 2-bit packed streams at the nucleotide level.

    (u32[Wa], len_a, u32[Wb], len_b) -> u32[2 ceil((len_a + len_b)/32)],
    the packed stream of ``a ++ b``: ``b`` lands at its (unaligned) offset
    through :func:`packed_slice`'s negative-start window, ``a`` is re-masked
    to its length, and the two are OR-ed, so dirty bits beyond either
    length cannot leak.
    """
    w_out = 2 * spec.cdiv(len_a + len_b, 32)
    if w_out == 0:
        return _zeros_u32(0, a)
    sb = packed_slice(b, -len_a, len_a + len_b)
    if len_a == 0:
        return sb
    wa = packed_slice(a, 0, len_a).view(torch.int32)
    wa = torch.cat([wa, wa.new_zeros(w_out - wa.shape[0])])
    return (wa | sb.view(torch.int32)).view(torch.uint32)


def packed_slice_b5(words: torch.Tensor, start: int, n: int) -> torch.Tensor:
    """Extract nucleotides ``[start, start + n)`` of a base-5 packed stream.

    Interleaved u32[2W] -> u32[2 ceil(n/27)] with zero tail digits and pad
    bits -- bit-exact to re-encoding the decoded window.  The funnel runs on
    the triplets: with ``q, r = divmod(start, 3)``, output triplet T is input
    triplet ``q + T`` (r = 0), or the high ``3 - r`` digits of it below the
    low r digits of triplet ``q + T + 1``, by the exact multiply-shifts.
    """
    if words.ndim != 1 or words.shape[0] % 2:
        raise TypeError("packed_slice_b5 takes a flat interleaved u32[2W] stream")
    if n < 0:
        raise ValueError("n must be >= 0")
    if n == 0:
        return _zeros_u32(0, words)
    w_out = spec.cdiv(n, _NT5)
    n_trip = _TRIPLETS * w_out
    q0, r0 = divmod(start, 3)
    w_lo = q0 // _TRIPLETS  # the input words of triplets q0 .. q0 + n_trip
    pair = _window(words, 2 * w_lo, 2 * ((q0 + n_trip) // _TRIPLETS + 1)).view(-1, 2)
    trips = eager.b5_word_triplets(pair[:, 0], pair[:, 1]).reshape(-1)
    off = q0 - _TRIPLETS * w_lo
    t1 = trips[off : off + n_trip]
    if r0 == 0:
        val = t1.clone()
    else:
        t2 = trips[off + 1 : off + 1 + n_trip]
        if r0 == 1:
            val = ((t1 * 205) >> 10) + 25 * (t2 - 5 * ((t2 * 205) >> 10))
        else:
            val = ((t1 * 41) >> 10) + 5 * (t2 - 25 * ((t2 * 41) >> 10))
    big_m = (n - 1) // 3  # the last output triplet
    u = n - 3 * big_m  # digits it keeps (1..3)
    if u < 3:
        c = 205 if u == 1 else 41
        val[big_m] -= 5**u * ((val[big_m] * c) >> 10)
    val[big_m + 1 :] = 0  # whole triplets past the window
    return _b5_pack(val.view(w_out, _TRIPLETS))


def packed_concat_b5(a: torch.Tensor, len_a: int, b: torch.Tensor, len_b: int) -> torch.Tensor:
    """Concatenate two base-5 packed streams at the nucleotide level.

    (u32[2Wa], len_a, u32[2Wb], len_b) -> u32[2 ceil((len_a + len_b)/27)].
    ``a`` re-masked to its length and ``b`` digit-shifted to offset
    ``len_a`` (a negative-start :func:`packed_slice_b5`) hold their digits
    in disjoint places, and the triplet at the seam sums ``a``'s low digits
    and ``b``'s high ones below 125, so one 64-bit add per word joins them
    (the reference's u32 lane add with its carry into the high half).
    """
    w_out = spec.cdiv(len_a + len_b, _NT5)
    if w_out == 0:
        return _zeros_u32(0, a)
    sb = packed_slice_b5(b, -len_a, len_a + len_b)
    if len_a == 0:
        return sb
    wa = packed_slice_b5(a, 0, len_a).view(torch.int32)
    wa = torch.cat([wa, wa.new_zeros(2 * w_out - wa.shape[0])]).view(torch.uint32)
    return eager.b5_word_halves(_b5_words(wa) + _b5_words(sb)).reshape(-1)


# --- codon translation -----------------------------------------------------------
# DNA -> protein without decoding: a 2-bit codon is the k = 3 window at every
# third position, and a base-5 codon is one packed triplet.

@functools.lru_cache(maxsize=1)
def _codon_lut() -> np.ndarray:
    """64-entry codon -> amino-acid LUT indexed by ``c0 + 4 c1 + 16 c2``
    (2-bit codes A=0 C=1 T=2 G=3).  NCBI standard code (table 1), built
    from the canonical TCAG-order spelling so no codon is hand-transcribed;
    stops are ``*``."""
    aas = b"FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
    code = {ord("A"): 0, ord("C"): 1, ord("T"): 2, ord("G"): 3}
    tcag = b"TCAG"
    lut = np.zeros(64, np.uint8)
    for i, aa in enumerate(aas):
        b1, b2, b3 = tcag[i >> 4], tcag[(i >> 2) & 3], tcag[i & 3]
        lut[code[b1] | (code[b2] << 2) | (code[b3] << 4)] = aa
    return lut


@functools.lru_cache(maxsize=1)
def _codon_lut_b5() -> np.ndarray:
    """128-entry codon LUT on the base-5 triplet value ``a + 5b + 25c``:
    digits 0-3 are the 2-bit codes (A C T G in the same order), so entries
    without N reuse :func:`_codon_lut`; a codon with N (digit 4) and the
    corrupt values 125-127 translate to ``X``."""
    lut64 = _codon_lut()
    lut = np.full(128, ord("X"), np.uint8)
    for t in range(125):
        a, b, c = t % 5, (t // 5) % 5, t // 25
        if a < 4 and b < 4 and c < 4:
            lut[t] = lut64[a | (b << 2) | (c << 4)]
    return lut


def _lookup(lut: np.ndarray, idx: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(lut).to(idx.device)[idx.to(torch.int64)]


def _check_frame(frame: int) -> None:
    if frame not in (0, 1, 2):
        raise ValueError("frame must be 0, 1 or 2")


def _n_codons(frame: int, length: int) -> int:
    n_cod = (length - frame) // 3
    if n_cod <= 0:
        raise ValueError(f"length {length} has no frame-{frame} codon")
    return n_cod


def translate_packed(words: torch.Tensor, length: int, frame: int = 0) -> torch.Tensor:
    """Translate a 2-bit packed stream to amino acids: -> u8[(length-frame)//3].

    ``frame`` in {0, 1, 2} is the forward reading-frame offset.  Codons are
    the k = 3 codes of :func:`.kmer.kmer_codes` at stride 3, mapped through
    the standard genetic code; stop codons emit ``*``.  For reverse frames
    feed :func:`revcomp_packed` output (:func:`translate_6frame` does).
    """
    from . import kmer  # kmer imports kernels, which imports this module

    _check_frame(frame)
    n_cod = _n_codons(frame, length)
    codes = kmer.kmer_codes(words, length, 3)
    return _lookup(_codon_lut(), codes[frame : frame + 3 * (n_cod - 1) + 1 : 3])


def translate_6frame(words: torch.Tensor, length: int) -> list[torch.Tensor]:
    """All six reading frames: ``[+0, +1, +2, -0, -1, -2]`` as u8 tensors.

    Reverse frames translate the reverse complement (:func:`revcomp_packed`,
    still no decode); frame ``-j`` starts ``j`` nucleotides into it, the
    samtools/EMBOSS convention.
    """
    rc = revcomp_packed(words, length)
    return [translate_packed(words, length, f) for f in range(3)] + [
        translate_packed(rc, length, f) for f in range(3)
    ]


def translate_packed_b5(words: torch.Tensor, length: int, frame: int = 0) -> torch.Tensor:
    """Translate a base-5 packed u32[2W] stream: -> u8[(length-frame)//3].

    A frame-0 codon is one packed triplet, so translation is a per-triplet
    LUT; frames 1 and 2 first shift the digits with :func:`packed_slice_b5`.
    Codons with N emit ``X``; stops emit ``*``.
    """
    if words.ndim != 1 or words.shape[0] % 2:
        raise TypeError("translate_packed_b5 takes a flat interleaved u32[2W]")
    _check_frame(frame)
    if length > (words.shape[0] // 2) * _NT5:
        raise ValueError(f"length {length} exceeds capacity")
    n_cod = _n_codons(frame, length)
    w = packed_slice_b5(words, frame, length - frame) if frame else words
    pair = _check_words(w[: 2 * spec.cdiv(n_cod, _TRIPLETS)]).view(-1, 2)
    trips = eager.b5_word_triplets(pair[:, 0], pair[:, 1]).reshape(-1)[:n_cod]
    return _lookup(_codon_lut_b5(), trips)


def translate_6frame_b5(words: torch.Tensor, length: int) -> list[torch.Tensor]:
    """All six frames of a base-5 stream (N-aware), with the packed-domain
    reverse complement for the minus strand: the base-5 mirror of
    :func:`translate_6frame`."""
    rc = revcomp_packed_b5(words, length)
    return [translate_packed_b5(words, length, f) for f in range(3)] + [
        translate_packed_b5(rc, length, f) for f in range(3)
    ]


# --- exact read deduplication ------------------------------------------------------

def duplicate_mask(words: torch.Tensor, lengths) -> torch.Tensor:
    """True for rows duplicating an EARLIER row: (u32[B, W], i32[B]) -> bool[B].

    ``seqkit rmdup -s``'s job on the packed domain: two reads are duplicates
    iff they have the same length and the same packed words (the codec's
    case/U folding and 'A' padding make content equality plain word
    equality).  The rows (length, every word) are grouped by
    ``torch.unique(dim=0)`` and every row but its group's first index is
    marked.  Exact: the key is the full content, no hash.
    """
    B, W = words.shape
    lengths = torch.as_tensor(lengths, device=words.device)
    if B == 0:
        return torch.zeros(0, dtype=torch.bool, device=words.device)
    rows = torch.cat([lengths.to(torch.int32).to(torch.int64).view(B, 1),
                      words.view(torch.int32).to(torch.int64)], dim=1)
    uniq, inv = torch.unique(rows, dim=0, return_inverse=True)
    idx = torch.arange(B, device=words.device)
    first = torch.full((uniq.shape[0],), B, dtype=torch.int64, device=words.device)
    first.scatter_reduce_(0, inv, idx, "amin")
    return idx != first[inv]
