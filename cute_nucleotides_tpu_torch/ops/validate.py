"""Input validation on the device: which bytes lie outside the alphabet.

Counterpart of ``cute_nucleotides_tpu/ops/validate.py``.  Encoding is
defined for every byte (see ``cute_nucleotides_tpu/ops/spec.py``); these
checks let strict callers reject out-of-alphabet input.  All checks are
case-insensitive and accept ``U``.
"""

from __future__ import annotations

import torch


def valid_mask(x: torch.Tensor, *, allow_n: bool = False) -> torch.Tensor:
    """bool[...]: True where the byte is in {A,C,G,T,U[,N]} (either case)."""
    c = x & 0xDF  # fold lowercase
    ok = (c == ord("A")) | (c == ord("C")) | (c == ord("G"))
    ok = ok | (c == ord("T")) | (c == ord("U"))
    if allow_n:
        ok = ok | (c == ord("N"))
    return ok


def count_invalid(x: torch.Tensor, *, allow_n: bool = False) -> torch.Tensor:
    """int32 count of invalid bytes along the last axis."""
    return (~valid_mask(x, allow_n=allow_n)).sum(-1, dtype=torch.int32)


def first_invalid(x: torch.Tensor, *, allow_n: bool = False) -> torch.Tensor:
    """int32 index of the first invalid byte along the last axis, or -1."""
    bad = ~valid_mask(x, allow_n=allow_n)
    if bad.shape[-1] == 0:
        return torch.full(bad.shape[:-1], -1, dtype=torch.int32, device=x.device)
    idx = bad.to(torch.uint8).argmax(-1)  # first maximum: the first bad byte
    return torch.where(bad.any(-1), idx, -1).to(torch.int32)
