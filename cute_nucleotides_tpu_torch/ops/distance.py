"""Nucleotide Hamming distances on packed words and on bytes.

Counterpart of ``cute_nucleotides_tpu/ops/distance.py``, with its names and
results (int32, on the input's device):

* :func:`hamming_packed`: ``d = a ^ b``, then the differing-nt count
  ``popcount((d | d >> 1) & 0x55555555)`` per word, by an exact SWAR
  popcount on int64 lanes (torch has no popcount, the card's torch no
  ``>>`` on uint32);
* :func:`hamming_seqs`: the ``(byte >> 1) & 3`` fold (case- and
  U/T-insensitive) compared position by position;
* :func:`pairwise_hamming` and :func:`pairwise_hamming_packed`: all-pairs
  distances as matches of one-hot code planes, ``A @ A^T`` chunk by chunk
  over the length, as int8 products summed exactly in int32
  (``torch._int_mm``, the reference's ``dot_general`` with an int32
  result).  No kernel of the reference's is on this path: its product ran
  outside Pallas, as this one runs in the library.
"""

from __future__ import annotations

import torch

from . import eager

__all__ = [
    "hamming_packed",
    "hamming_seqs",
    "pairwise_hamming",
    "pairwise_hamming_packed",
]

#: ``torch._int_mm`` on the card takes more than 16 rows and dimensions that
#: are multiples of 8
_MM_MIN_ROWS, _MM_ALIGN = 24, 8


def _fold2(x: torch.Tensor) -> torch.Tensor:
    """ASCII byte -> 2-bit code (case- and T/U-insensitive)."""
    return (x >> 1) & 3


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit value held in int64 lanes."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_packed(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Differing-nt count between two equal-shape 2-bit packed u32 streams,
    reduced over the last axis: ``u32[..., W] -> i32[...]``.  Trailing
    padding must match (e.g. both 'A'-padded)."""
    d = eager.u32_to_i64(a) ^ eager.u32_to_i64(b)
    return _popcount32((d | (d >> 1)) & 0x55555555).sum(-1).to(torch.int32)


def hamming_seqs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Differing-nt count between two equal-shape ASCII u8 sequences."""
    return (_fold2(a) != _fold2(b)).sum(-1).to(torch.int32)


def _round_up(n: int, k: int) -> int:
    return -(-n // k) * k


def _pairwise_from_codes(codes: torch.Tensor, chunk: int) -> torch.Tensor:
    """Codes [B, L] (values 0..3) -> all-pairs match counts i32[B, B]: per
    chunk of the length a (B, 4 * chunk) int8 one-hot, ``A @ A^T`` summed in
    int32.  Rows pad with all-zero one-hots to the product's shape rules,
    and the chunk's columns to a multiple of 8; neither adds a match."""
    B, L = codes.shape
    rows = max(_round_up(B, _MM_ALIGN), _MM_MIN_ROWS)
    syms = torch.arange(4, dtype=codes.dtype, device=codes.device)
    acc = torch.zeros((rows, rows), dtype=torch.int32, device=codes.device)
    for lo in range(0, L, chunk):
        c = codes[:, lo : lo + chunk]
        oh = torch.zeros((rows, _round_up(4 * c.shape[1], _MM_ALIGN)), dtype=torch.int8, device=codes.device)
        oh[:B, : 4 * c.shape[1]] = (c[..., None] == syms).view(B, -1)
        acc += torch._int_mm(oh, oh.t())
    return acc[:B, :B]


def pairwise_hamming(reads: torch.Tensor, *, chunk: int = 2048) -> torch.Tensor:
    """All-pairs nt Hamming distances for a batch: u8[B, L] -> i32[B, B]
    (distance = L - matches, exact for L < 2**31)."""
    return reads.shape[1] - _pairwise_from_codes(_fold2(reads), chunk)


def pairwise_hamming_packed(words: torch.Tensor, *, chunk: int = 2048) -> torch.Tensor:
    """All-pairs distances straight from packed words: u32[B, W] -> i32[B,
    B], over all ``16 * W`` positions (equal padding counts zero).  Trailing
    padding must match across reads."""
    B, W = words.shape
    shifts = 2 * torch.arange(16, device=words.device)
    codes = (eager.u32_to_i64(words)[:, :, None] >> shifts) & 3
    return 16 * W - _pairwise_from_codes(codes.reshape(B, 16 * W), chunk)
