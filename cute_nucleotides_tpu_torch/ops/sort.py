"""Sorting u32 key pairs.

Counterpart of ``cute_nucleotides_tpu/ops/sort.py:sort_pairs`` on its
production path (``prefer="lax"``, ``jax.lax.sort`` outside any Pallas
kernel): here ``torch.sort`` of one int64 key per pair.  The reference's
bitonic kernel (``prefer="bitonic"``) is not ported.
"""

from __future__ import annotations

import torch

_FLIP = -(1 << 31)  # the sign bit of an int32


def sort_pairs(hi: torch.Tensor, lo: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort u32 pairs by ``(hi, lo)`` ascending (unsigned, lexicographic):
    -> (hi_sorted, lo_sorted), both u32[n].

    The key is the signed int64 ``(hi ^ 0x80000000) << 32 | lo``: flipping
    the sign bit of the high half makes signed order equal unsigned order,
    so every u32 pair sorts where the reference sorts it (the all-ones pair
    that ``kmer_counts`` uses as its sentinel becomes the int64 maximum and
    sorts last; unflipped it would be -1 and sort first).
    """
    if hi.shape != lo.shape:
        raise TypeError(f"key shapes differ: {tuple(hi.shape)} vs {tuple(lo.shape)}")
    if hi.dtype != torch.uint32 or lo.dtype != torch.uint32:
        raise TypeError(f"expected u32 keys, got {hi.dtype}/{lo.dtype}")
    h = (hi.reshape(-1).view(torch.int32) ^ _FLIP).to(torch.int64)
    key = (h << 32) | (lo.reshape(-1).view(torch.int32).to(torch.int64) & 0xFFFFFFFF)
    del h
    key = torch.sort(key).values
    hi_s = ((key >> 32).to(torch.int32) ^ _FLIP).view(torch.uint32)
    return hi_s, key.to(torch.int32).view(torch.uint32)
