"""Operations on packed streams.

Counterpart of ``cute_nucleotides_tpu/ops/seqops.py``; so far the 2-bit
GC and base-composition counts of ``stats`` and the base-5
stream-integrity scan that diagnoses a flagged ``decode_checked``.  The
JAX package has no kernel for any of them, so they are eager torch on the
words' device.

GC content is a masked popcount: C (01) and G (11) are exactly the codes
with bit 0 set, and 'A' padding (00) counts nothing.  torch has no
popcount, so the counts are SWAR forms on int64 lanes.
"""

from __future__ import annotations

import torch

from . import eager, spec

_FIELD = 0x55555555  # bit 0 of each 2-bit field


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


def base_composition_packed(words: torch.Tensor, length: int | None = None) -> torch.Tensor:
    """Per-base counts of a 2-bit packed stream: u32[..., W] -> i32[..., 4]
    in code order (A, C, T, G).

    With ``hi``/``lo`` the per-field code bits, three masked popcounts --
    of lo (C + G), hi (T + G) and hi & lo (G) -- give C, T and G, and A is
    the rest.  ``length`` subtracts the 'A'-coded tail padding from the A
    column, and raises ``ValueError`` when it exceeds the capacity ``16 W``.
    """
    w = _check_words(words)
    cap = words.shape[-1] * spec.NT_PER_U32_2BIT
    if length is not None:
        if length > cap:
            raise ValueError(f"length {length} exceeds capacity")
        cap = length
    lo, hi = w & _FIELD, (w >> 1) & _FIELD
    n_lo, n_hi, g = _field_count(torch.stack([lo, hi, hi & lo])).unbind(0)
    return torch.stack([cap - n_lo - n_hi + g, n_lo - g, n_hi - g, g], dim=-1).to(torch.int32)


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
