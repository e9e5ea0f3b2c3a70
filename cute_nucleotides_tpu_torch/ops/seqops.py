"""Operations on packed streams.

Counterpart of ``cute_nucleotides_tpu/ops/seqops.py``; so far the base-5
stream-integrity scan that diagnoses a flagged ``decode_checked``.
"""

from __future__ import annotations

import torch

from . import eager


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
