"""Exact conversion between the reference's numpy arrays and this package's
tensors.

The codec has no weights; what crosses between the two packages is data:
u8 byte streams, u32 word arrays (including the nt4 view of a byte stream),
u64 word streams and ``.nup`` containers (read and written alike by both
packages).  Every function here
keeps the bits: dtypes map one to one, and a u64 stream travels as its
little-endian u32 pairs, the form the port's packed words take.
"""

from __future__ import annotations

import numpy as np
import torch

_TORCH_DTYPES = {
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.uint32): torch.uint32,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.bool_): torch.bool,
}


def to_tensor(a, device=None) -> torch.Tensor:
    """numpy u8/u32/i32/i64/bool array (or bytes) -> tensor of the same dtype
    and bits, on ``device`` (CPU by default).  Never aliases a read-only
    buffer."""
    if isinstance(a, (bytes, bytearray, memoryview)):
        a = np.frombuffer(bytes(a), dtype=np.uint8)
    a = np.asarray(a)
    if a.dtype not in _TORCH_DTYPES:
        raise TypeError(f"no exact tensor dtype for {a.dtype}")
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device if device is not None else "cpu")


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor -> numpy array of the same dtype and bits (host copy)."""
    return t.detach().cpu().numpy()


def u64_to_tensor(bits, device=None) -> torch.Tensor:
    """u64 word stream [..., W] -> uint32 tensor [..., 2W] of its
    little-endian halves (the packed-word form of the codec)."""
    bits = np.ascontiguousarray(bits, dtype="<u8")
    return to_tensor(bits.view("<u4").reshape(*bits.shape[:-1], 2 * bits.shape[-1]), device)


def tensor_to_u64(words: torch.Tensor) -> np.ndarray:
    """uint32 tensor [..., 2W] -> u64 word stream [..., W]."""
    if words.dtype != torch.uint32 or words.shape[-1] % 2:
        raise ValueError(f"expected uint32[..., 2W], got {words.dtype}{tuple(words.shape)}")
    a = np.ascontiguousarray(to_numpy(words))
    return a.view("<u8").reshape(*a.shape[:-1], a.shape[-1] // 2)


def nt4(x: torch.Tensor) -> torch.Tensor:
    """Byte stream u8[..., 4k] -> its nt4 view uint32[..., k] (no copy)."""
    return x.view(torch.uint32)


def nt4_bytes(w: torch.Tensor) -> torch.Tensor:
    """nt4 uint32[..., k] -> the byte stream u8[..., 4k] (no copy)."""
    return w.view(torch.uint8)

