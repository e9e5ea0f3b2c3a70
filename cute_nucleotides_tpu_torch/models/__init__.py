"""Batch codecs: the device-tensor production API of both codecs.

Counterpart of ``cute_nucleotides_tpu/models/__init__.py`` (``TwoBitCodec``
and ``Base5Codec``).  A codec holds a tier and a device and maps resident
tensors of shape ``[batch, length]``:

* ``torch`` -- eager PyTorch (:mod:`..ops.eager`), on any device;
* ``cuda``  -- the hand-written kernels (:mod:`..ops.kernels`), CUDA only;
* ``auto``  -- ``cuda`` on a CUDA device, ``torch`` on the CPU.

Packed words are uint32 tensors whose little-endian stream is the
reference's ``Vec<u64>`` output bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import eager, kernels, seqops, spec, validate

__all__ = ["Base5Codec", "CodecConfig", "TwoBitCodec", "default_decode_variant", "default_encode_variant", "pad_batch",
           "resolve_device", "resolve_tier"]

TIERS = ("torch", "cuda", "auto")

#: default variant per tier: the torch tier's integer-sum and broadcast
#: forms need no bitcast; the kernels default to mul and swar
DEFAULT_ENCODE_VARIANT = {"torch": "dot", "cuda": "mul"}
DEFAULT_DECODE_VARIANT = {"torch": "broadcast", "cuda": "swar"}


def _auto_tier(tier: str) -> str:
    if tier == "auto":
        return "cuda" if torch.cuda.is_available() else "torch"
    return tier


def default_encode_variant(tier: str) -> str:
    """The default 2-bit encode variant of a tier ("auto": the card's if
    there is one)."""
    return DEFAULT_ENCODE_VARIANT[_auto_tier(tier)]


def default_decode_variant(tier: str) -> str:
    """The default 2-bit decode variant of a tier ("auto": the card's if
    there is one)."""
    return DEFAULT_DECODE_VARIANT[_auto_tier(tier)]


#: variants that exist on one tier only
_CUDA_ONLY_ENCODE = ("mxu",)
_TORCH_ONLY_ENCODE = ("dot",)
_TORCH_ONLY_DECODE = ("broadcast",)


def resolve_device(tier: str, device=None) -> torch.device:
    """The device a tier runs on.  ``None`` means the CPU for ``torch``, the
    card for ``cuda``, and the card if there is one for ``auto``.  Raises
    where the tier cannot run: ``cuda`` off a CUDA device or without CUDA."""
    if device is None:
        if tier == "torch":
            device = "cpu"
        elif tier == "cuda" or torch.cuda.is_available():
            device = "cuda"
        else:
            device = "cpu"
    device = torch.device(device)
    if tier == "cuda" and device.type != "cuda":
        raise ValueError(f'tier="cuda" runs on a CUDA device, not {device}')
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


def resolve_tier(tier: str, device: torch.device) -> str:
    if tier not in TIERS:
        raise ValueError(f"unknown tier {tier!r}; expected one of {TIERS}")
    if tier == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    return tier


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Codec configuration.

    Attributes:
      tier: "torch", "cuda" or "auto" (see the module docstring).
      encode_variant: "mul" (multiply-as-bit-shuffle), "shift" (shift-OR
        tree), "interleave" (even/odd code planes, the movemask slot),
        "mxu" (in-thread bit-plane gather, the pext slot; cuda only) or "dot"
        (integer weighted sum; torch only).  None picks the tier's default.
      decode_variant: "swar" (spread multiplies, the pdep slot), "shuffle"
        (packed-LUT shift), "select" (select tree, the clmul slot) or
        "broadcast" (field broadcast; torch only).  None picks the default.
        Variants are the 2-bit codec's; the base-5 codec takes none.
      device: where the codec's tensors live; None as in
        :func:`resolve_device`.
    """

    tier: str = "auto"
    encode_variant: str | None = None
    decode_variant: str | None = None
    device: str | torch.device | None = None

    def resolved_device(self) -> torch.device:
        return resolve_device(self.tier, self.device)

    def resolved_tier(self) -> str:
        return resolve_tier(self.tier, self.resolved_device())

    def resolved_encode_variant(self) -> str:
        return self.encode_variant or default_encode_variant(self.resolved_tier())

    def resolved_decode_variant(self) -> str:
        return self.decode_variant or default_decode_variant(self.resolved_tier())


def pad_batch(
    reads: np.ndarray | list[bytes], block: int, fill: int = ord("A")
) -> tuple[np.ndarray, np.ndarray]:
    """Pad a batch of byte strings to a common block-aligned length.

    Returns ``(batch u8[B, Lpad], lengths i32[B])``.  Padding with 'A'
    (code 0) leaves the unused high bits of the last word zero, as the
    reference does.
    """
    if isinstance(reads, np.ndarray):
        if reads.ndim != 2 or reads.dtype != np.uint8:
            raise TypeError("expected u8[B, L] array or list of bytes")
        lengths = np.full(reads.shape[0], reads.shape[1], dtype=np.int32)
        rem = (-reads.shape[1]) % block
        if rem:
            pad = np.full((reads.shape[0], rem), fill, dtype=np.uint8)
            reads = np.concatenate([reads, pad], axis=1)
        return reads, lengths
    lengths = np.array([len(r) for r in reads], dtype=np.int32)
    lpad = spec.cdiv(max((int(n) for n in lengths), default=0), block) * block
    out = np.full((len(reads), max(lpad, block)), fill, dtype=np.uint8)
    for i, r in enumerate(reads):
        out[i, : len(r)] = np.frombuffer(bytes(r), dtype=np.uint8)
    return out, lengths


class _CodecBase:
    """Tier and device of a codec; inputs must be tensors on its device
    (nothing is moved for the caller)."""

    block: int

    def __init__(self, config: CodecConfig | None = None, **overrides):
        if config is None:
            config = CodecConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        self.config = config
        self.device = config.resolved_device()
        self.tier = resolve_tier(config.tier, self.device)

    def _check(self, t: torch.Tensor) -> None:
        if t.device != self.device and not (
            t.device.type == self.device.type == "cuda" and self.device.index is None
        ):
            raise ValueError(f"tensor on {t.device}, codec on {self.device}")

    def pad(self, reads):
        return pad_batch(reads, self.block)


class TwoBitCodec(_CodecBase):
    """Batched 2-bit codec: u8[..., L] <-> packed u32[..., L // 16].

    L must be a multiple of 16, the kernels' group; :meth:`pad` pads to
    whole u64 words (32 nt), the stream's unit.
    """

    block = spec.NT_PER_WORD_2BIT

    def __init__(self, config: CodecConfig | None = None, **overrides):
        super().__init__(config, **overrides)
        self.encode_variant = self.config.resolved_encode_variant()
        self.decode_variant = self.config.resolved_decode_variant()
        if self.tier == "cuda":
            for v, torch_only in (
                (self.encode_variant, _TORCH_ONLY_ENCODE),
                (self.decode_variant, _TORCH_ONLY_DECODE),
            ):
                if v in torch_only:
                    raise ValueError(f'variant "{v}" is a torch-tier formulation; use tier="torch"')
            encode_variants, decode_variants = kernels.ENCODE_2BIT_VARIANTS, kernels.DECODE_2BIT_VARIANTS
        else:
            if self.encode_variant in _CUDA_ONLY_ENCODE:
                raise ValueError(
                    f'variant "{self.encode_variant}" is a CUDA kernel; use tier="cuda" '
                    '(or "auto" on a CUDA device)'
                )
            encode_variants, decode_variants = eager.ENCODE_2BIT_VARIANTS, eager.DECODE_2BIT_VARIANTS
        eager.check_variant(self.encode_variant, encode_variants)
        eager.check_variant(self.decode_variant, decode_variants)

    def encode(self, reads: torch.Tensor) -> torch.Tensor:
        """u8[..., L] -> u32[..., L // 16]; L must be a multiple of 16."""
        self._check(reads)
        if self.tier == "cuda":
            return kernels.encode_2bit_words(reads, self.encode_variant)
        return eager.encode_2bit_words(reads, self.encode_variant)

    def encode_checked(self, reads: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Encode + per-row flag: u8[..., L] -> (u32[..., L // 16], bool[...]).

        Flag r is True iff row r holds a byte outside {A,C,G,T,U} (either
        case).  On the cuda tier the check is fused into the encode kernel
        of every variant (one read of the input); on the torch tier it is a
        validity pass before the encode.  Diagnose flagged rows with
        :func:`..ops.validate.first_invalid`.
        """
        self._check(reads)
        if self.tier == "cuda":
            return kernels.encode_2bit_words_checked(reads, self.encode_variant)
        bad = (~validate.valid_mask(reads)).any(-1)
        return self.encode(reads), bad

    def decode(self, words: torch.Tensor) -> torch.Tensor:
        """u32[..., W] -> u8[..., 16 * W] (full blocks; caller truncates)."""
        self._check(words)
        if self.tier == "cuda":
            return kernels.decode_2bit_bytes(words, self.decode_variant)
        return eager.decode_2bit_bytes(words, self.decode_variant)

    def encode_nt4(self, nt4: torch.Tensor) -> torch.Tensor:
        """nt4 u32[R, C] -> packed u8[R, C] through the kernel wrappers (on a
        CPU tensor, their plain versions).  With ``encode_variant="mxu"`` the
        output is packed u32 words [R, C // 4] (C % 4 == 0)."""
        self._check(nt4)
        v = self.encode_variant
        if v in _TORCH_ONLY_ENCODE:
            v = DEFAULT_ENCODE_VARIANT["cuda"]
        if v == "mxu":
            return kernels.encode_2bit_nt4_mxu(nt4)
        return kernels.encode_2bit_nt4(nt4, v)

    def decode_nt4(self, packed: torch.Tensor) -> torch.Tensor:
        """packed u8[R, C] -> nt4 u32[R, C] through the kernel wrappers."""
        self._check(packed)
        v = self.decode_variant
        if v in _TORCH_ONLY_DECODE:
            v = DEFAULT_DECODE_VARIANT["cuda"]
        return kernels.decode_2bit_nt4(packed, v)

    def words_per_read(self, length: int) -> int:
        return 2 * spec.num_words_2bit(length)  # u32 count


class Base5Codec(_CodecBase):
    """Batched base-5 codec: u8[..., L] <-> packed u32[..., 2 * (L // 27)].

    L must be a multiple of 27 (one u64 word); the batch is encoded as one
    flat stream, since word boundaries survive the flatten.  Base-5 has no
    variants.  Decoding a corrupt word (triplet >= 125) follows the host
    oracle: its high digit reads as 'N'.
    """

    block = spec.NT_PER_WORD_B5

    def __init__(self, config: CodecConfig | None = None, **overrides):
        super().__init__(config, **overrides)
        if self.config.encode_variant or self.config.decode_variant:
            raise ValueError("the base-5 codec has no variants")

    def encode(self, reads: torch.Tensor) -> torch.Tensor:
        """u8[..., L] -> u32[..., 2 * (L // 27)]; L must be a multiple of 27."""
        self._check(reads)
        if self.tier == "cuda":
            return kernels.encode_b5_words(reads)
        return eager.encode_b5_words(reads)

    def encode_checked(self, reads: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Encode + validity flag: u8[..., L] -> (u32[..., 2 * (L // 27)],
        bool scalar).

        The flag is True iff ANY byte lies outside {A,C,G,T,U,N} (either
        case): one flag per call, as the reference's.  Fused into the encode
        kernel on the cuda tier; a validity pass beside the encode on the
        torch tier.  Diagnose with :func:`..ops.validate.first_invalid`.
        """
        self._check(reads)
        if self.tier == "cuda":
            return kernels.encode_b5_words_checked(reads)
        bad = (~validate.valid_mask(reads, allow_n=True)).any()
        return self.encode(reads), bad

    def decode(self, words: torch.Tensor) -> torch.Tensor:
        """u32[..., 2 * W] -> u8[..., 27 * W] (full blocks; caller truncates)."""
        self._check(words)
        if self.tier == "cuda":
            return kernels.decode_b5_bytes(words)
        return eager.decode_b5_bytes(words)

    def decode_checked(self, words: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Decode + stream-integrity flag: u32[..., 2 * W] -> (u8[..., 27 * W],
        bool scalar).

        The flag is True iff ANY u64 word is corrupt (a triplet >= 125 or
        bit 63 set).  Fused into the decode kernel on the cuda tier; the
        scan :func:`..ops.seqops.first_invalid_word_b5` on the torch tier,
        which also names the word on a flagged batch.
        """
        self._check(words)
        if self.tier == "cuda":
            return kernels.decode_b5_bytes_checked(words)
        bad = (seqops.first_invalid_word_b5(words) >= 0).any()
        return self.decode(words), bad

    def words_per_read(self, length: int) -> int:
        return 2 * spec.num_words_b5(length)  # u32 count
