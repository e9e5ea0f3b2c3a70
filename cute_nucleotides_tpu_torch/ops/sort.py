"""Sorting u32 key pairs.

Counterpart of ``cute_nucleotides_tpu/ops/sort.py:sort_pairs``.  Its
production path (``prefer="lax"``, ``jax.lax.sort``) is ``torch.sort`` of
one int64 key per pair here; ``prefer="bitonic"`` runs kernel #18 (the
radix sort :func:`.kernels.sort_pairs_bitonic`, in the place of the
reference's bitonic network) inside the reference's envelope and the same
``torch.sort`` outside it, as the reference does.
"""

from __future__ import annotations

import torch

from . import kernels

__all__ = ["sort_pairs", "BITONIC_COLS", "BITONIC_MAX_N"]

#: the reference's matrix width; its lower bound on the bitonic route,
#: padded n >= 4 * BITONIC_COLS, is kept
BITONIC_COLS = 1024

#: largest padded n the bitonic route takes.  The reference sized it from a
#: TPU core's VMEM; the Hopper kernel's passes have no shared-memory
#: ceiling, so it is set where the chr1 k = 21 key sort fits (248,956,402
#: pairs pad to 2^28; the radix passes' two key buffers take 4 GB)
BITONIC_MAX_N = 1 << 28


def sort_pairs(hi: torch.Tensor, lo: torch.Tensor, *, prefer: str = "lax") -> tuple[torch.Tensor, torch.Tensor]:
    """Sort u32 pairs by ``(hi, lo)`` ascending (unsigned, lexicographic):
    -> (hi_sorted, lo_sorted), both u32[n].

    ``prefer="lax"`` (the default) sorts one int64 key per pair
    (:func:`.kernels.pair_keys`) with ``torch.sort``.  ``prefer="bitonic"``
    runs kernel #18 (on a CUDA tensor; its plain version on the CPU) when
    the padded n (:func:`.kernels.bitonic_size`) lies in ``[4 * BITONIC_COLS,
    BITONIC_MAX_N]``, and ``torch.sort`` otherwise; the result is the same.
    """
    if prefer not in ("lax", "bitonic"):
        raise ValueError(f"prefer must be 'lax' or 'bitonic', got {prefer!r}")
    if hi.shape != lo.shape:
        raise TypeError(f"key shapes differ: {tuple(hi.shape)} vs {tuple(lo.shape)}")
    if hi.dtype != torch.uint32 or lo.dtype != torch.uint32:
        raise TypeError(f"expected u32 keys, got {hi.dtype}/{lo.dtype}")
    n = kernels.bitonic_size(hi.numel())
    if prefer == "lax" or n < 4 * BITONIC_COLS or n > BITONIC_MAX_N:
        return kernels.split_keys(torch.sort(kernels.pair_keys(hi, lo)).values)
    return kernels.sort_pairs_bitonic(hi.reshape(-1), lo.reshape(-1))
