"""User-facing codec API: host bytes in, u64 words out, and back.

Counterpart of ``n_to_bits``/``bits_to_n`` (2-bit) and ``n_to_bits2``/
``bits_to_n2`` (base-5) in ``cute_nucleotides_tpu/api.py`` with the
reference's exact semantics (u64 packed words, explicit decode length).
Tiers:

* ``oracle`` -- the host C++ oracle (:mod:`.ops.native`);
* ``torch``  -- eager PyTorch (:mod:`.ops.eager`);
* ``cuda``   -- the hand-written kernels (:mod:`.ops.kernels`);
* ``auto``   -- ``cuda`` on a CUDA device, ``torch`` on the CPU.

``device=None`` puts ``auto`` on the card when there is one.  The stream is
padded with 'A' only to the kernels' unit (16 nt for 2-bit, one 27-nt word
for base-5); the pad packs to the zero bits and digits the reference leaves
in its last word.  For resident batches use :class:`.models.TwoBitCodec`
and :class:`.models.Base5Codec`.
"""

from __future__ import annotations

import numpy as np
import torch

from . import TIERS, interop, models
from .ops import eager, kernels, native, oracle, spec

__all__ = ["n_to_bits", "bits_to_n", "n_to_bits2", "bits_to_n2"]

_as_u8 = oracle._as_u8


def _resolve(tier: str, device) -> tuple[str, torch.device | None]:
    if tier not in TIERS:
        raise ValueError(f"unknown tier {tier!r}; expected one of {TIERS}")
    if tier == "oracle":
        return tier, None
    dev = models.resolve_device(tier, device)
    return models.resolve_tier(tier, dev), dev


def _validate_input(seq: np.ndarray, allow_n: bool = False) -> None:
    pos = native.find_invalid(seq, allow_n=allow_n)
    if pos >= 0:
        raise ValueError(
            f"invalid byte {bytes(seq[pos:pos + 1])!r} at position {pos} "
            f"(alphabet: ACGTU{'N' if allow_n else ''}, either case)"
        )


def _padded(n: np.ndarray, unit: int, dev: torch.device) -> torch.Tensor:
    """The bytes on ``dev``, padded with 'A' to a multiple of ``unit``."""
    x = torch.empty(spec.cdiv(n.size, unit) * unit, dtype=torch.uint8, device=dev)
    x[: n.size].copy_(interop.to_tensor(n))
    x[n.size :].fill_(ord("A"))
    return x


def _encode_words(x: torch.Tensor, tier: str, variant: str) -> torch.Tensor:
    if tier == "cuda":
        return kernels.encode_2bit_words(x, variant)
    if variant == "mxu":
        # the pext slot has no eager form of its own: the torch tier runs
        # the plain version of its kernel
        return kernels.encode_2bit_nt4_mxu_plain(x.view(1, -1).view(torch.uint32)).view(-1)
    return eager.encode_2bit_words(x, variant)


def n_to_bits(
    seq, *, tier: str = "auto", variant: str | None = None,
    validate: bool = False, device=None,
) -> np.ndarray:
    """Encode {A,C,G,T/U} bytes to 2-bit packed u64 words (LSB-first).

    ``variant=None`` takes the tier's default ("dot" on torch, "mul" on
    cuda).  ``validate=True`` raises ``ValueError`` on the first byte
    outside the alphabet; otherwise every byte encodes as ``(byte >> 1) & 3``.
    """
    tier, dev = _resolve(tier, device)
    n = _as_u8(seq)
    if validate:
        _validate_input(n)
    if tier == "oracle":
        return native.n_to_bits(n)
    if variant is None:
        variant = models.DEFAULT_ENCODE_VARIANT[tier]
    if n.size == 0:
        return np.zeros(0, dtype=np.uint64)
    x = _padded(n, spec.NT_PER_U32_2BIT, dev)
    words = _encode_words(x, tier, variant).cpu().numpy()
    out = np.zeros(2 * spec.num_words_2bit(n.size), dtype=np.uint32)
    out[: words.size] = words  # an odd u32 count leaves the last high half 0
    return out.view("<u8")


def bits_to_n(
    bits, length: int, *, tier: str = "auto", variant: str | None = None, device=None,
) -> np.ndarray:
    """Decode 2-bit packed u64 words to ASCII; ``length`` = nucleotide count.

    Raises ``ValueError`` when ``length`` lies outside ``[0, 32 * words]``.
    ``variant=None`` takes the tier's default ("broadcast" on torch, "swar"
    on cuda).
    """
    tier, dev = _resolve(tier, device)
    bits = np.ascontiguousarray(bits, dtype=np.uint64)
    if not 0 <= length <= bits.size * spec.NT_PER_WORD_2BIT:
        raise ValueError(f"length {length} outside [0, {bits.size * spec.NT_PER_WORD_2BIT}]")
    if tier == "oracle":
        return native.bits_to_n(bits, length)
    if variant is None:
        variant = models.DEFAULT_DECODE_VARIANT[tier]
    if length == 0:
        return np.zeros(0, dtype=np.uint8)
    # only the u32 words that hold the first `length` nt
    w32 = bits.view(np.uint32)[: spec.cdiv(length, spec.NT_PER_U32_2BIT)]
    words = interop.to_tensor(w32, dev)
    if tier == "cuda":
        chars = kernels.decode_2bit_bytes(words, variant)
    else:
        chars = eager.decode_2bit_bytes(words, variant)
    return chars[:length].cpu().numpy()


def n_to_bits2(seq, *, tier: str = "auto", validate: bool = False, device=None) -> np.ndarray:
    """Encode {A,C,G,T/U,N} bytes to base-5 packed u64 words (9 triplets of
    7 bits, LSB-first).

    ``validate=True`` raises ``ValueError`` on the first byte outside
    ACGTUN (either case); otherwise every byte encodes as
    ``DIGIT_LUT8[byte & 7]``.
    """
    tier, dev = _resolve(tier, device)
    n = _as_u8(seq)
    if validate:
        _validate_input(n, allow_n=True)
    if tier == "oracle":
        return native.n_to_bits2(n)
    if n.size == 0:
        return np.zeros(0, dtype=np.uint64)
    x = _padded(n, spec.NT_PER_WORD_B5, dev)
    encode = kernels.encode_b5_words if tier == "cuda" else eager.encode_b5_words
    return encode(x).cpu().numpy().view("<u8")


def bits_to_n2(bits, length: int, *, tier: str = "auto", device=None) -> np.ndarray:
    """Decode base-5 packed u64 words to ASCII; ``length`` = nucleotide count.

    Raises ``ValueError`` when ``length`` lies outside ``[0, 27 * words]``.
    A corrupt word (triplet >= 125) decodes as the host oracle decodes it.
    """
    tier, dev = _resolve(tier, device)
    bits = np.ascontiguousarray(bits, dtype=np.uint64)
    if not 0 <= length <= bits.size * spec.NT_PER_WORD_B5:
        raise ValueError(f"length {length} outside [0, {bits.size * spec.NT_PER_WORD_B5}]")
    if tier == "oracle":
        return native.bits_to_n2(bits, length)
    if length == 0:
        return np.zeros(0, dtype=np.uint8)
    # only the words that hold the first `length` nt
    w32 = bits[: spec.num_words_b5(length)].view(np.uint32)
    words = interop.to_tensor(w32, dev)
    decode = kernels.decode_b5_bytes if tier == "cuda" else eager.decode_b5_bytes
    return decode(words)[:length].cpu().numpy()
