"""The base-5 codec of the crate's bit contract, in plain PyTorch.

A byte's digit is ``DIGIT_OF_LOW3[byte & 7]``: A 0, C 1, T (and U) 2, G 3,
N 4, and 0 for the low bits no letter of the alphabet has.  A 64-bit word
holds 27 nt as 9 triplets of 7 bits, triplet ``k`` at bit ``7 k`` with the
value ``d0 + 5 d1 + 25 d2`` (``d0`` first in the stream); words are laid out
as their little-endian u32 halves.  Decoding writes 'ACTGN' by digit.  A
byte is valid where it is one of ``ACGTUN`` in either case.

Work is cut into blocks of rows so that the int64 temporaries stay small.
"""

from __future__ import annotations

import torch

DIGIT_OF_LOW3 = (0, 0, 0, 1, 2, 2, 4, 3)
CHARS = b"ACTGN"
NT_PER_WORD = 27
#: rows a block
BLOCK = 1 << 16


def _blocks(n: int):
    for r0 in range(0, n, BLOCK):
        yield slice(r0, min(n, r0 + BLOCK))


def digits(x: torch.Tensor) -> torch.Tensor:
    """u8[R, L] -> digits u8[R, L]."""
    lut = torch.tensor(DIGIT_OF_LOW3, dtype=torch.uint8, device=x.device)
    out = torch.empty_like(x)
    for s in _blocks(x.shape[0]):
        out[s] = lut[(x[s] & 7).long()]
    return out


def pack(d: torch.Tensor) -> torch.Tensor:
    """Digits u8[R, 27 k] -> packed u32[R, 2 k]."""
    R, L = d.shape
    k = L // NT_PER_WORD
    shifts = 7 * torch.arange(9, device=d.device, dtype=torch.int64)
    out = torch.empty((R, k), dtype=torch.int64, device=d.device)
    for s in _blocks(R):
        t = d[s].to(torch.int64).view(-1, k, 9, 3)
        t = t[..., 0] + 5 * t[..., 1] + 25 * t[..., 2]
        out[s] = (t << shifts).sum(-1)
    return out.view(torch.int32).view(torch.uint32)


def unpack(words: torch.Tensor) -> torch.Tensor:
    """Packed u32[R, 2 k] -> digits u8[R, 27 k] (words of valid triplets)."""
    R = words.shape[0]
    w = words.contiguous().view(torch.int32).view(torch.int64)
    k = w.shape[1]
    shifts = 7 * torch.arange(9, device=w.device, dtype=torch.int64)
    out = torch.empty((R, NT_PER_WORD * k), dtype=torch.uint8, device=w.device)
    for s in _blocks(R):
        t = (w[s][..., None] >> shifts) & 0x7F
        out[s] = torch.stack([t % 5, (t // 5) % 5, t // 25], -1).reshape(t.shape[0], -1).to(torch.uint8)
    return out


def chars(d: torch.Tensor) -> torch.Tensor:
    """Digits u8[...] -> 'ACTGN' bytes."""
    lut = torch.tensor(list(CHARS), dtype=torch.uint8, device=d.device)
    out = torch.empty_like(d)
    for s in _blocks(d.shape[0]):
        out[s] = lut[d[s].long()]
    return out


def has_invalid(x: torch.Tensor) -> bool:
    """True where some byte lies outside ACGTUN (either case)."""
    for s in _blocks(x.shape[0]):
        up = x[s] & 0xDF
        ok = (up == 65) | (up == 67) | (up == 71) | (up == 84) | (up == 85) | (up == 78)
        if not bool(ok.all()):
            return True
    return False


def mismatches(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements that differ between two tensors of one shape (compared as
    signed integers of their width)."""
    if a.shape != b.shape:
        return max(a.numel(), b.numel())
    view = {1: torch.uint8, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return int((a.contiguous().view(view) != b.contiguous().view(view)).sum())
