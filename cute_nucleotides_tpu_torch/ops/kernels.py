"""The ``cuda`` tier: wrappers of the hand-written Hopper kernels in
``csrc/codec2bit.cu``, ``csrc/codec_b5.cu``, ``csrc/search.cu``,
``csrc/kmer.cu``, ``csrc/sketch.cu``, ``csrc/seqops.cu``, ``csrc/sort.cu``
and ``csrc/align.cu``, each beside its plain PyTorch version.

A wrapper runs its plain version only for a tensor on the CPU; for a CUDA
tensor it launches its kernel (building the library on first use) or raises.
Each wrapper counts its launches in a plain integer attribute,
``<wrapper>.launches``, which adds one exactly where the kernel is launched.

Shapes follow the reference's nt4 forms (``cute_nucleotides_tpu/ops/
pallas_kernels.py``): an nt4 array is a uint32 array whose lane j holds
ASCII bytes 4j..4j+3 little-endian (a free view of the byte stream), and a
packed byte holds 4 nt at 2 bits each, LSB-first.  The kernels need no TPU
tiling: any lane count works, except that a checked row and the pext words
need whole 16-nt groups (C % 4 == 0).

The base-5 kernels take flat streams: 27 N ASCII bytes <-> N u64 words as
2 N u32 halves.  A batch u8[..., L] with L % 27 == 0 flattens into one
stream, because word boundaries survive the flatten.  Their planar forms
(the reference's panel API) take rows u8[R, 3456] <-> two u32[R, 128]
planes, the low and high halves of the rows' 128 words.

The search kernels take flat packed streams too and write one u32 of match
bits per stream word (16 starts per 2-bit word, 27 per base-5 word).

The k-mer kernels take 2-bit words cut into rows u32[R, W] beside their
successor words and write planar codes i32[R, 16 W] (or u32 (lo, hi)
planes for k >= 16); the histogram kernel counts codes < 65536 into
i32[256, 256].

The sketch kernels take a flat 2-bit stream: the planar k-mer hashes for
16 <= k <= 31 (u32[rows, 16 W], 0xFFFFFFFF past the valid positions) and
the packed (w, k)-minimizer bits for k <= 15 (u32[ceil(n/16)]).

The base-5 GC kernel takes a flat base-5 stream and returns one int32; the
pair sort takes two u32[n] key planes and returns them sorted.  The Myers
scan takes query bitmasks (Peq) and text rows cut from one flat packed
stream of either codec, and returns scores, best ends or an ends mask;
the base-5 Peq build makes those bitmasks from packed query words.

Every codec kernel is bound by device memory: the 2-bit encoders read 4
bytes and write 1 per 4 nt, the decoder the reverse (5 bytes moved per 4
nt); the base-5 kernels move 27 bytes and one 8-byte word per 27 nt (35
bytes).  The search kernels move less (8 or 12 bytes per word) and are
bound by integer work at short queries.  The k-mer code kernels are bound
by their writes (64 B per 16 nt, twice that for pairs), the histogram by
reading the codes, the hash kernel by its writes (4 B per position).  The
minimizer kernel reads and writes little and is bound by its integer work
(a hash and 2 floor(log2 w) + 2 doubling passes per position).  The GC
kernel is bound by reading its stream, the radix sort by its passes over
the keys, the Myers scan by its integer work (about 40 instructions per
32-row block and text nt), the Peq build by its bytes (the query words in, 20
bytes a 32-row block out).  Times on the H100 beside the plain versions' are in PERF.md.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from . import _build, eager, native, seqops, spec, validate

ENCODE_2BIT_VARIANTS = ("mul", "shift", "interleave", "mxu")
DECODE_2BIT_VARIANTS = ("shuffle", "select", "swar")
_ENCODE_IDS = {"mul": 0, "shift": 1, "interleave": 2}
_DECODE_IDS = {"swar": 0, "shuffle": 1, "select": 2}


def _check_2d(x: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if x.dtype != dtype or x.ndim != 2:
        raise TypeError(f"expected {what}, got {x.dtype}{tuple(x.shape)}")


def _on_cuda(x: torch.Tensor) -> bool:
    """False for a CPU tensor (plain version); True for a CUDA tensor that
    the kernels can take as it is; raises for anything else.  Nothing is
    copied: a view the kernel cannot read is the caller's to fix."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("kernel input must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError(f"kernel input must be 16-byte aligned (data_ptr % 16 == {x.data_ptr() % 16})")
    return True


def _launch(fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


# --- kernel #1: encode ----------------------------------------------------

def encode_2bit_nt4_plain(x: torch.Tensor, variant: str = "mul") -> torch.Tensor:
    """Plain version of :func:`encode_2bit_nt4`."""
    return eager.PACK4[variant](eager.u32_to_i64(x)).to(torch.uint8)


def encode_2bit_nt4(x: torch.Tensor, variant: str = "mul") -> torch.Tensor:
    """Encode nt4 u32[R, C] -> packed u8[R, C].

    Replaces ``cute_nucleotides_tpu/ops/pallas_kernels.py:encode_2bit_nt4``.
    Bound by memory (4 B read, 1 B written per 4 nt); one thread loads 16
    nt as one 16-byte vector and stores their 4 packed bytes as one u32, so
    every warp access is a full coalesced line.  Time on the H100: PERF.md.
    """
    eager.check_variant(variant, _ENCODE_IDS)
    _check_2d(x, torch.uint32, "nt4 u32[R, C]")
    if not _on_cuda(x):
        return encode_2bit_nt4_plain(x, variant)
    out = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    if x.numel():
        lib = _build.load()
        with torch.cuda.device(x.device):
            _launch(lib.cn_encode_2bit, x.data_ptr(), out.data_ptr(), x.numel(),
                    _ENCODE_IDS[variant], _stream(x))
        encode_2bit_nt4.launches += 1
    return out


encode_2bit_nt4.launches = 0


# --- kernel #2: decode ----------------------------------------------------

def decode_2bit_nt4_plain(p: torch.Tensor, variant: str = "swar") -> torch.Tensor:
    """Plain version of :func:`decode_2bit_nt4`."""
    return eager.i64_to_u32(eager.UNPACK4[variant](p.to(torch.int64)))


def decode_2bit_nt4(p: torch.Tensor, variant: str = "swar") -> torch.Tensor:
    """Decode packed u8[R, C] -> nt4 u32[R, C] (always upper-case, T).

    Replaces ``cute_nucleotides_tpu/ops/pallas_kernels.py:decode_2bit_nt4``.
    Bound by memory (1 B read, 4 B written per 4 nt); one thread loads 4
    packed bytes as one u32 and stores their 16 chars as one 16-byte vector.
    Time on the H100: PERF.md.
    """
    eager.check_variant(variant, _DECODE_IDS)
    _check_2d(p, torch.uint8, "packed u8[R, C]")
    if not _on_cuda(p):
        return decode_2bit_nt4_plain(p, variant)
    out = torch.empty(p.shape, dtype=torch.uint32, device=p.device)
    if p.numel():
        lib = _build.load()
        with torch.cuda.device(p.device):
            _launch(lib.cn_decode_2bit, p.data_ptr(), out.data_ptr(), p.numel(),
                    _DECODE_IDS[variant], _stream(p))
        decode_2bit_nt4.launches += 1
    return out


decode_2bit_nt4.launches = 0


# --- kernel #3: encode + per-row validity ------------------------------------

def encode_2bit_nt4_checked_plain(
    x: torch.Tensor, variant: str = "mul"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`encode_2bit_nt4_checked`."""
    w = eager.u32_to_i64(x)
    bad = (eager.invalid_bits(w) != 0).any(-1)
    return eager.PACK4[variant](w).to(torch.uint8), eager.i64_to_u32(bad.to(torch.int64))


def encode_2bit_nt4_checked(
    x: torch.Tensor, variant: str = "mul"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused encode + validity: nt4 u32[R, C] (C % 4 == 0) -> (packed
    u8[R, C], flags u32[R]); flag r is 1 iff row r holds a byte outside
    {A,C,G,T,U} (either case), else 0.

    Replaces ``cute_nucleotides_tpu/ops/pallas_kernels.py:
    encode_2bit_nt4_checked``, whose u32[R, 128] badplane was a TPU tile;
    the per-row flag is the contract.  Bound by memory like the encode: the
    check rides the same 16-byte load, and a warp ORs its flags with one
    ``__reduce_or_sync`` and one ``atomicOr`` (per thread only in a warp
    that straddles two rows).  Time on the H100: PERF.md.
    """
    eager.check_variant(variant, _ENCODE_IDS)
    _check_2d(x, torch.uint32, "nt4 u32[R, C]")
    R, C = x.shape
    if C % 4:
        raise ValueError(f"checked encode needs whole 16-nt groups per row (C % 4 == 0), got C={C}")
    if not _on_cuda(x):
        return encode_2bit_nt4_checked_plain(x, variant)
    out = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    flags = torch.zeros(R, dtype=torch.int32, device=x.device)
    if x.numel():
        lib = _build.load()
        with torch.cuda.device(x.device):
            _launch(lib.cn_encode_2bit_checked, x.data_ptr(), out.data_ptr(), flags.data_ptr(),
                    R, C, _ENCODE_IDS[variant], _stream(x))
        encode_2bit_nt4_checked.launches += 1
    return out, flags.view(torch.uint32)


encode_2bit_nt4_checked.launches = 0


# --- kernel #4: the pext slot -------------------------------------------------

#: the pext slot's plane gather (``csrc/codec2bit.cu`` ``gather_planes``):
#: each plane's bits sit at 8j of a lane; times PEXT_PLANE_LO (low plane) or
#: PEXT_PLANE_HI (high plane) they land, carry-free, on bits 24 + 2j and
#: 25 + 2j, so bits 24..31 of the sum are the lane's packed byte
PEXT_PLANE_MASK = 0x01010101
PEXT_PLANE_LO = (1 << 24) | (1 << 18) | (1 << 12) | (1 << 6)
PEXT_PLANE_HI = PEXT_PLANE_LO << 1


def encode_2bit_nt4_mxu_plain(x: torch.Tensor, checked: bool = False):
    """Plain version of :func:`encode_2bit_nt4_mxu`, in the kernel's steps on
    int64 lanes: per lane the two bit planes times their multipliers, byte 3
    of the sum (the lane's packed byte), then the 4 bytes of a 16-nt group
    placed into its u32."""
    R, C = x.shape
    w = eager.u32_to_i64(x)
    lo = (w >> 1) & PEXT_PLANE_MASK
    hi = (w >> 2) & PEXT_PLANE_MASK
    packed = ((lo * PEXT_PLANE_LO + hi * PEXT_PLANE_HI) >> 24) & 0xFF  # int64: the u32 drops bits >= 32
    shifts = 8 * torch.arange(4, device=x.device, dtype=torch.int64)
    words = eager.i64_to_u32((packed.reshape(R, C // 4, 4) << shifts).sum(-1))  # disjoint bytes: sum == OR
    if not checked:
        return words
    bad = (eager.invalid_bits(w) != 0).any(-1)
    return words, eager.i64_to_u32(bad.to(torch.int64))


def encode_2bit_nt4_mxu(x: torch.Tensor, checked: bool = False):
    """Encode nt4 u32[R, C] (C % 4 == 0) -> packed u32 words [R, C // 4];
    variant ``mxu``, the slot of the reference's ``n_to_bits_pext``.  With
    ``checked=True`` it returns ``(words, flags u32[R])`` with the flags of
    :func:`encode_2bit_nt4_checked`, computed on the same loads.

    Replaces ``cute_nucleotides_tpu/ops/pallas_kernels.py:
    encode_2bit_nt4_mxu``, whose constant matmul gathered packed bytes on
    the TPU's matrix unit.  Here the gather is a bit-plane gather inside
    each thread: a 16-nt group (one 16-byte load) maps to one output u32,
    and per lane of 4 nt the codes' low and high bit planes are each placed
    on the packed byte's even and odd bits by one carry-free multiply-mask
    (``PEXT_PLANE_LO``, ``PEXT_PLANE_HI``).  A thread takes 2 groups and
    stores their words as one 8-byte vector.  Bound by memory like the
    encode.  Time on the H100: PERF.md.
    """
    _check_2d(x, torch.uint32, "nt4 u32[R, C]")
    R, C = x.shape
    if C % 4:
        raise ValueError(f"the pext encode emits whole u32 words: C % 4 == 0, got C={C}")
    if not _on_cuda(x):
        return encode_2bit_nt4_mxu_plain(x, checked)
    out = torch.empty((R, C // 4), dtype=torch.uint32, device=x.device)
    flags = torch.zeros(R, dtype=torch.int32, device=x.device) if checked else None
    if out.numel():
        lib = _build.load()
        with torch.cuda.device(x.device):
            _launch(lib.cn_encode_2bit_pext, x.data_ptr(), out.data_ptr(),
                    flags.data_ptr() if checked else None, out.numel(), 4 * C, _stream(x))
        encode_2bit_nt4_mxu.launches += 1
    return (out, flags.view(torch.uint32)) if checked else out


encode_2bit_nt4_mxu.launches = 0


# --- kernel #5: base-5 encode (+ validity flag) --------------------------------

def _check_stream(x: torch.Tensor, dtype: torch.dtype, unit: int, what: str) -> int:
    """The unit count of a flat stream of ``unit`` elements per unit."""
    if x.dtype != dtype or x.ndim != 1:
        raise TypeError(f"expected {what}, got {x.dtype}{tuple(x.shape)}")
    if x.numel() % unit:
        raise ValueError(f"{what}: length {x.numel()} is not a multiple of {unit}")
    return x.numel() // unit


def encode_b5_stream_plain(x: torch.Tensor, checked: bool = False):
    """Plain version of :func:`encode_b5_stream`: digits, triplets, then the
    9 triplets shifted into an int64 word."""
    d = eager.b5_digits(x).reshape(-1, spec.TRIPLETS_PER_WORD, 3)
    t = (d[..., 0] + 5 * d[..., 1] + 25 * d[..., 2]).to(torch.int64)
    shifts = 7 * torch.arange(spec.TRIPLETS_PER_WORD, device=x.device, dtype=torch.int64)
    words = eager.b5_word_halves((t << shifts).sum(-1))  # disjoint bit fields: sum == OR
    if not checked:
        return words
    bad = (~validate.valid_mask(x, allow_n=True)).any()
    return words, eager.i64_to_u32(bad.to(torch.int64).reshape(1))


def encode_b5_stream(x: torch.Tensor, checked: bool = False):
    """Encode a flat ASCII stream u8[27 N] -> packed u32[2 N], the u32
    halves of N base-5 u64 words.  With ``checked=True`` it returns
    ``(words, flag u32[1])``; the flag is 1 iff some byte lies outside
    {A,C,G,T,U,N} (either case), one flag per call as the reference's.

    Replaces ``cute_nucleotides_tpu/ops/pallas_kernels.py:
    _encode_b5_panels_call`` (the interleaved panel encoder and its checked
    mode), whose constant bf16 matmul did the 7-bit packing because the TPU
    has no byte gather.  Here one thread packs one word: a block stages
    3456 bytes (128 words) into shared memory with 16-byte loads, each
    thread realigns its 27 bytes with funnel shifts and writes one 8-byte
    word.  Bound by memory (27 B read, 8 B written per 27 nt); the digits
    and the validity test work on 4 bytes per u32 op, so the integer pipes
    keep up (the checked mode adds one ``__reduce_or_sync`` per warp and
    one ``atomicOr``).  Time on the H100: PERF.md.
    """
    n = _check_stream(x, torch.uint8, spec.NT_PER_WORD_B5, "ASCII u8[27 N]")
    if not _on_cuda(x):
        return encode_b5_stream_plain(x, checked)
    out = torch.empty(2 * n, dtype=torch.uint32, device=x.device)
    flag = torch.zeros(1, dtype=torch.int32, device=x.device) if checked else None
    if n:
        lib = _build.load()
        with torch.cuda.device(x.device):
            _launch(lib.cn_encode_b5, x.data_ptr(), out.data_ptr(),
                    flag.data_ptr() if checked else None, n, _stream(x))
        encode_b5_stream.launches += 1
    return (out, flag.view(torch.uint32)) if checked else out


encode_b5_stream.launches = 0


# --- kernel #6: base-5 decode (chars, checked, digits) --------------------------

#: the kernel's modes (``DecodeMode`` in csrc/codec_b5.cu)
_B5_CHARS, _B5_CHECKED, _B5_DIGITS = 0, 1, 2


def _b5_decode_mode(checked: bool, digits: bool) -> int:
    if checked and digits:
        raise ValueError(
            "checked digit decode is not a mode of the kernel: the checked "
            "decode emits chars (decode digits without the check)"
        )
    return _B5_CHECKED if checked else _B5_DIGITS if digits else _B5_CHARS


def decode_b5_stream_plain(words: torch.Tensor, checked: bool = False, digits: bool = False):
    """Plain version of :func:`decode_b5_stream`."""
    _b5_decode_mode(checked, digits)
    pair = eager.u32_to_i64(words).reshape(-1, 2)
    t = eager.b5_word_triplets(pair[:, 0], pair[:, 1])
    d = eager.b5_triplet_digits(t)
    out = (d if digits else eager.b5_digit_chars(d)).to(torch.uint8).reshape(-1)
    if not checked:
        return out
    bad = seqops.first_invalid_word_b5(words) >= 0
    return out, eager.i64_to_u32(bad.to(torch.int64).reshape(1))


def decode_b5_stream(words: torch.Tensor, checked: bool = False, digits: bool = False):
    """Decode packed u32[2 N] (N base-5 u64 words) -> u8[27 N]: upper-case
    ASCII 'ACTGN', or with ``digits=True`` the digit bytes 0..4 in that
    order.  With ``checked=True`` it returns ``(bytes, flag u32[1])``; the
    flag is 1 iff some word has a triplet >= 125 or bit 63 set.  A corrupt
    triplet decodes as the host oracle's (high digit clamped to 4).

    Replaces ``cute_nucleotides_tpu/ops/pallas_kernels.py:
    _decode_b5_inter_call`` (chars, checked and digits modes), whose bf16
    gather and int8 scatter matmuls stood in for the TPU's missing byte
    shuffle.  Here one thread decodes one word (one coalesced 8-byte load),
    splits its triplets with exact multiply-shifts, and writes 27 digit
    bytes into shared memory; the block stores its 3456-byte tile with
    16-byte vectors, turning digits into chars 4 bytes per u32 op on the
    way.  Bound by memory (8 B read, 27 B written per 27 nt).  Time on the
    H100: PERF.md.
    """
    mode = _b5_decode_mode(checked, digits)
    n = _check_stream(words, torch.uint32, 2, "packed u32[2 N]")
    if not _on_cuda(words):
        return decode_b5_stream_plain(words, checked, digits)
    out = torch.empty(spec.NT_PER_WORD_B5 * n, dtype=torch.uint8, device=words.device)
    flag = torch.zeros(1, dtype=torch.int32, device=words.device) if checked else None
    if n:
        lib = _build.load()
        with torch.cuda.device(words.device):
            _launch(lib.cn_decode_b5, words.data_ptr(), out.data_ptr(),
                    flag.data_ptr() if checked else None, n, mode, _stream(words))
        decode_b5_stream.launches += 1
    return (out, flag.view(torch.uint32)) if checked else out


decode_b5_stream.launches = 0

# --- kernels #15-#17: the planar (lo, hi) layout of the base-5 codec ------------

#: nt per row of the planar layout (128 words), the reference's panel width
B5_ROW_NT = 3456
#: words per row of the planar layout
B5_ROW_WORDS = 128
#: 432-nt slices per row
B5_SLICES = 8
#: u32 lanes of a padded nt4 row: per slice 108 lanes of chars and 4 of 'AAAA'
B5_NT4_PAD_LANES = 896


def _name(dtype: torch.dtype) -> str:
    """A dtype as numpy names it ("uint8"), so that messages read as the
    reference's."""
    return str(dtype).removeprefix("torch.")


def _check_planes(lo: torch.Tensor, hi: torch.Tensor) -> int:
    if lo.shape != hi.shape or lo.ndim != 2 or lo.shape[1] != B5_ROW_WORDS:
        raise TypeError(f"expected u32[R, {B5_ROW_WORDS}] planes, got {tuple(lo.shape)}/{tuple(hi.shape)}")
    if lo.dtype != torch.uint32 or hi.dtype != torch.uint32:
        raise TypeError(f"expected u32[R, {B5_ROW_WORDS}] planes, got {_name(lo.dtype)}/{_name(hi.dtype)}")
    return lo.shape[0]


def _interleave(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Planes u32[R, 128] -> the interleaved stream u32[256 R]."""
    return torch.stack([lo.view(torch.int32), hi.view(torch.int32)], -1).view(-1).view(torch.uint32)


def encode_b5_planar_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`encode_b5_planar`: :func:`encode_b5_stream_plain`
    with the word halves split into two planes."""
    R = x.shape[0]
    pair = encode_b5_stream_plain(x.reshape(-1)).view(torch.int32).view(R, B5_ROW_WORDS, 2)
    return pair[..., 0].contiguous().view(torch.uint32), pair[..., 1].contiguous().view(torch.uint32)


def encode_b5_planar(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Encode u8[R, 3456] nt rows -> planar (lo, hi) u32[R, 128] planes;
    ``lo[r, w] | hi[r, w] << 32`` is word ``128 r + w`` of the base-5 stream.

    Replaces ``cute_nucleotides_tpu/ops/pallas_kernels.py:encode_b5_planar``,
    whose constant bf16 matmul built three 21-bit chunks per word because
    the TPU has no byte gather.  Here it is the planar store mode of the
    kernel of :func:`encode_b5_stream`: the same staging, funnel shifts and
    SWAR digits, and each word stored as two coalesced 4-byte halves.
    Bound by memory (27 B read, 8 B written per 27 nt).  Time on the H100:
    PERF.md.
    """
    if x.dtype != torch.uint8 or x.ndim != 2 or x.shape[1] != B5_ROW_NT:
        raise TypeError(f"expected u8[R, {B5_ROW_NT}], got {_name(x.dtype)}{tuple(x.shape)}")
    if not _on_cuda(x):
        return encode_b5_planar_plain(x)
    R = x.shape[0]
    lo = torch.empty((R, B5_ROW_WORDS), dtype=torch.uint32, device=x.device)
    hi = torch.empty_like(lo)
    if R:
        lib = _build.load()
        with torch.cuda.device(x.device):
            _launch(lib.cn_encode_b5_planar, x.data_ptr(), lo.data_ptr(), hi.data_ptr(), R * B5_ROW_WORDS,
                    _stream(x))
        encode_b5_planar.launches += 1
    return lo, hi


encode_b5_planar.launches = 0


def decode_b5_panels_plain(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`decode_b5_panels`: the planes interleaved, then
    :func:`decode_b5_stream_plain`."""
    return decode_b5_stream_plain(_interleave(lo, hi)).view(lo.shape[0], B5_ROW_NT)


def decode_b5_nt4_panels_plain(lo: torch.Tensor, hi: torch.Tensor, *, padded: bool = True) -> torch.Tensor:
    """Plain version of :func:`decode_b5_nt4_panels`: :func:`decode_b5_panels_plain`
    as u32 lanes, with four 'AAAA' lanes after every 108 when padded."""
    R = lo.shape[0]
    chars = decode_b5_panels_plain(lo, hi)
    if not padded:
        return chars.view(torch.uint32)
    out = torch.full((R, B5_SLICES, 4 * B5_NT4_PAD_LANES // B5_SLICES), ord("A"), dtype=torch.uint8,
                     device=lo.device)
    out[:, :, : B5_ROW_NT // B5_SLICES] = chars.view(R, B5_SLICES, B5_ROW_NT // B5_SLICES)
    return out.view(R, 4 * B5_NT4_PAD_LANES).view(torch.uint32)


def _launch_decode_planar(lo: torch.Tensor, hi: torch.Tensor, out: torch.Tensor, padded: bool) -> None:
    lib = _build.load()
    with torch.cuda.device(lo.device):
        _launch(lib.cn_decode_b5_planar, lo.data_ptr(), hi.data_ptr(), out.data_ptr(), lo.shape[0] * B5_ROW_WORDS,
                int(padded), _stream(lo))


def decode_b5_nt4_panels(lo: torch.Tensor, hi: torch.Tensor, *, padded: bool = True) -> torch.Tensor:
    """Decode planar u32[R, 128] planes -> nt4 u32 lanes (4 chars each,
    little-endian): u32[R, 896] when ``padded`` (slice g of the row at lanes
    [112 g, 112 g + 108), its 4 pad lanes 'AAAA'; :func:`depad_nt4_host`
    strips them), else the compact u32[R, 864].  Upper-case 'ACTGN'; a
    corrupt triplet decodes as in :func:`decode_b5_stream`.

    Replaces ``cute_nucleotides_tpu/ops/pallas_kernels.py:
    decode_b5_nt4_panels``, whose int8 scatter matmul and 896-lane padding
    served the TPU (no byte shuffle; a u32[R, 864] result cost XLA a
    relayout).  Here it is the planar load mode of the kernel of
    :func:`decode_b5_stream`; compact is the very launch of
    :func:`decode_b5_panels` (the same bytes, seen as u32), and padded a
    store mode that writes each slice's 27 16-byte vectors and one vector of
    'AAAA'.  Bound by memory (8 B read per 27 nt; 27 B written, 28 padded).
    Time on the H100: PERF.md.
    """
    R = _check_planes(lo, hi)
    if not _same_device(lo, hi):
        return decode_b5_nt4_panels_plain(lo, hi, padded=padded)
    out = torch.empty((R, B5_NT4_PAD_LANES if padded else B5_ROW_NT // 4), dtype=torch.uint32, device=lo.device)
    if R:
        _launch_decode_planar(lo, hi, out, padded)
        decode_b5_nt4_panels.launches += 1
    return out


decode_b5_nt4_panels.launches = 0


def decode_b5_panels(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Decode planar u32[R, 128] planes -> u8[R, 3456] upper-case 'ACTGN'.

    Replaces ``cute_nucleotides_tpu/ops/pallas_kernels.py:decode_b5_panels``
    (bf16 gather and scatter matmuls on the TPU).  The same launch as the
    compact :func:`decode_b5_nt4_panels`, returned as bytes.  Bound by
    memory (8 B read, 27 B written per 27 nt).  Time on the H100: PERF.md.
    """
    R = _check_planes(lo, hi)
    if not _same_device(lo, hi):
        return decode_b5_panels_plain(lo, hi)
    out = torch.empty((R, B5_ROW_NT), dtype=torch.uint8, device=lo.device)
    if R:
        _launch_decode_planar(lo, hi, out, False)
        decode_b5_panels.launches += 1
    return out


decode_b5_panels.launches = 0


def depad_nt4_host(panels: np.ndarray) -> np.ndarray:
    """Host-side de-pad: padded nt4 rows u32[R, 896] -> the flat u8 chars
    (each slice's first 432 bytes), as the reference's ``depad_nt4_host``:
    the shape is checked before the native copy, which would read a narrower
    array out of bounds."""
    panels = np.ascontiguousarray(panels)
    if panels.ndim != 2 or panels.shape[1] != B5_NT4_PAD_LANES:
        raise TypeError(f"expected padded nt4 panels (R, {B5_NT4_PAD_LANES}), got {panels.shape}")
    return native.depad_nt4(panels)

# --- kernels #8 and #9: packed-domain search ------------------------------------

@functools.lru_cache(maxsize=64)
def _device_table(buf: bytes, device: torch.device) -> torch.Tensor:
    """A query table (u32 values as bytes) on ``device``, uploaded once per
    query and device, so that repeated scans launch without a host copy."""
    return torch.from_numpy(np.frombuffer(buf, np.int32).copy()).to(device)


def _clear_tail(bits: torch.Tensor, n_starts: int, per_word: int) -> torch.Tensor:
    """Clear the bits of starts >= n_starts (bit s of word w is start
    per_word * w + s)."""
    lim = n_starts - per_word * torch.arange(bits.numel(), device=bits.device, dtype=torch.int64)
    lim = lim.clamp(0, per_word)
    return bits & ((torch.ones_like(lim) << lim) - 1)


def _query_words(q, care) -> tuple[np.ndarray, np.ndarray]:
    q, care = np.asarray(q, dtype=np.uint32), np.asarray(care, dtype=np.uint32)
    if q.ndim != 1 or q.shape != care.shape or q.size == 0:
        raise ValueError(f"expected non-empty q and care of one length, got {q.shape} and {care.shape}")
    return q, care


#: the 2-bit kernel's table: a head of u32[4] (n_first, n_steps, look,
#: anchor), then two u32 a step
_MATCH_HEAD, _MATCH_STEP = 4, 2

#: a 2-bit code replicated into the 16 fields of a word, and the low bit of
#: each field
_REP2 = _EVEN2 = 0x55555555


def _match_table(q, care) -> np.ndarray:
    """The 2-bit kernel's query table (u32): one step per concrete query nt
    i = 16 a + r (care field 0b11; 0b00 is an N and has no step), as the
    pair ``a << 5 | 2 r`` and its code times 0x55555555 (replicated into the
    16 fields).  The anchor word's steps come first -- the query word with
    the most cared-for bits, the first of equals, as the reference's
    prefilter chooses it (``search.py:_match_bits_kernel``) -- then the
    other words' in order, each in nt order.  The head is n_first (the
    anchor's steps), n_steps, look (the largest step offset + 1: the words
    a thread reads past its own) and the anchor word.  Built once per query
    and cached (a read-only array), so a repeated scan spends no Python on
    it."""
    q, care = _query_words(q, care)
    return _match_table_of(q.tobytes(), care.tobytes())


@functools.lru_cache(maxsize=64)
def _match_table_of(q_bytes: bytes, care_bytes: bytes) -> np.ndarray:
    q, care = np.frombuffer(q_bytes, np.uint32), np.frombuffer(care_bytes, np.uint32)
    fields = [(int(care[a]) >> (2 * r)) & 3 for a in range(q.size) for r in range(spec.NT_PER_U32_2BIT)]
    if any(f not in (0, 3) for f in fields):
        raise ValueError("care must hold 0b11 or 0b00 in each 2-bit field")
    anchor = max(range(q.size), key=lambda a: bin(int(care[a])).count("1"))
    steps = [(a << 5 | 2 * r, ((int(q[a]) >> (2 * r)) & 3) * _REP2)
             for a in [anchor] + [a for a in range(q.size) if a != anchor]
             for r in range(spec.NT_PER_U32_2BIT) if fields[spec.NT_PER_U32_2BIT * a + r]]
    n_first = bin(int(care[anchor])).count("1") // 2
    look = max((e >> 5 for e, _ in steps), default=0) + 1
    table = np.array([n_first, len(steps), look, anchor, *(v for step in steps for v in step)], dtype=np.uint32)
    table.flags.writeable = False
    return table


def _compact_even(e: torch.Tensor) -> torch.Tensor:
    """Bit 2 s of e (odd bits clear, 32 bits) moved to bit s, by the
    kernel's four multiply-masks (``compact_even`` in csrc/search.cu)."""
    e = (e * 3) & 0x66666666
    e = (e * 5) & 0x78787878
    e = (e * 17) & 0x7F807F80
    return ((e * 514) >> 16) & 0xFFFF


def match_bits_stream_plain(words: torch.Tensor, q, care, n_starts: int) -> torch.Tensor:
    """Plain version of :func:`match_bits_stream`, in the kernel's own
    arithmetic on int64 lanes (O(W) memory): per step of
    :func:`_match_table`, the stream's 32-bit window at the step's word
    offset and shift, xor the step's replicated code, OR-ed into v; then
    the zero-field test ~(v | v >> 1) & 0x55555555 and the compaction of
    its even bits."""
    table = _match_table(q, care)
    W, n_steps, look = words.numel(), int(table[1]), int(table[2])
    x = torch.cat([eager.u32_to_i64(words), words.new_zeros(look + 1, dtype=torch.int64)])
    v = torch.zeros(W, dtype=torch.int64, device=words.device)
    for e, c in table[_MATCH_HEAD:].reshape(n_steps, _MATCH_STEP).tolist():
        a, sh = e >> 5, e & 31
        win = x[a : a + W] if sh == 0 else ((x[a : a + W] >> sh) | (x[a + 1 : a + 1 + W] << (32 - sh))) & eager.U32
        v |= win ^ c
    bits = _compact_even(~(v | (v >> 1)) & _EVEN2)
    return eager.i64_to_u32(_clear_tail(bits, n_starts, spec.NT_PER_U32_2BIT))


def match_bits_stream(words: torch.Tensor, q, care, n_starts: int) -> torch.Tensor:
    """2-bit exact search: packed u32[W] stream -> match bits u32[W]; bit s
    of word w is 1 iff the query (``q``/``care`` u32[Wq] from
    ``search.compile_query``: care is 0b11 per concrete field, 0b00 at an N
    wildcard) matches at nt 16 w + s < n_starts.  Stream words past W read
    as 0.

    Replaces ``cute_nucleotides_tpu/ops/search.py:match_bits_rows``, whose
    (base, halo) rows of 512 lanes and per-query compiled constants were TPU
    artefacts.  The query becomes a device table (:func:`_match_table`, once
    per query and device) of one step per concrete nt.  A block of 128
    threads stages its 1024 words and up to 256 lookahead words in shared
    memory (longer lookahead reads through ``__ldg``); each thread takes 8
    words, and a step -- one funnel shift and one xor-or a word -- tests all
    16 starts of a word at once.  The anchor word's steps run first, and
    after at most 10 of them the rest run only where a start is still alive
    in some lane of the warp.
    One zero test per word and four multiply-masks give the 16 start bits.
    :func:`match_bits_stream_plain` repeats this arithmetic.  About two
    integer-ALU instructions a word per concrete query nt; 8 bytes move per
    16 nt.  Time on the H100: PERF.md.
    """
    W = _check_stream(words, torch.uint32, 1, "packed u32[W]")
    table = _match_table(q, care)
    if not _on_cuda(words):
        return match_bits_stream_plain(words, q, care, n_starts)
    out = torch.empty(W, dtype=torch.uint32, device=words.device)
    if W:
        n_first, n_steps, look, anchor = (int(v) for v in table[:_MATCH_HEAD])
        dev_table = _device_table(table[_MATCH_HEAD:].tobytes(), words.device)
        lib = _build.load()
        with torch.cuda.device(words.device):
            _launch(lib.cn_match_2bit, words.data_ptr(), W, dev_table.data_ptr(), n_first, n_steps, look, anchor,
                    n_starts, out.data_ptr(), _stream(words))
        match_bits_stream.launches += 1
    return out


match_bits_stream.launches = 0

#: anchor taps per phase for the base-5 prefilter (~4 triplets = 12 nt)
_B5_ANCHOR_TAPS = 4

#: taps per phase the base-5 kernel stages for (a 1024-nt query's 342)
_B5_MAX_TAPS = 342


def _b5_anchor_taps(qc) -> tuple | None:
    """Per-phase anchor tap indices of the prefilter, or None when the query
    is too short for a split to pay (the reference's choice,
    ``pallas_kernels.py:_b5_anchor_taps``)."""
    taps = []
    for _, care8 in qc:
        order = sorted(range(len(care8)), key=lambda i: bin(int(care8[i])).count("1"), reverse=True)
        taps.append(frozenset(order[:_B5_ANCHOR_TAPS]))
    if min(len(qc[p][0]) - len(taps[p]) for p in range(3)) < _B5_ANCHOR_TAPS:
        return None
    return tuple(taps)


#: the base-5 kernel's table: a head of u32[8] (n_first, n_steps, six
#: zeros), then twelve u32 a step
_B5_HEAD, _B5_STEP = 8, 12

#: a base-5 digit replicated into the nine 3-bit fields of a digit word
_B5_REP = 0x1249249

#: the low two bits, and the high bit, of each of the nine 3-bit fields
_B5_LOW2, _B5_HIGH = 0x36DB6DB, 0x4924924


def _b5_table(qc) -> tuple[np.ndarray, int]:
    """The kernel's query table and the lookahead words its steps reach.

    A step is one triplet offset i = 9 a + r, shared by the three phases:
    its first u32 is ``a << 16 | kinds << 5 | 3 r``, where bit 3 p + d of
    kinds says that phase p's tap at offset i cares for digit d (a, b, c)
    of the triplet, and u32 1 + 3 p + d holds that digit times 0x1249249
    (replicated into the nine 3-bit fields); u32 10 and 11 are 0.  The head
    is n_first, n_steps: the first n_first steps hold each phase's anchor
    taps (the reference's prefilter, ``_b5_anchor_taps``), the rest its
    other taps, each part in offset order.  Taps that care for nothing
    are left out."""
    if len(qc) != 3:
        raise ValueError(f"expected three phase tables, got {len(qc)}")
    max_taps = max(len(q8) for q8, _ in qc)
    if max_taps > _B5_MAX_TAPS:
        raise ValueError(f"the base-5 search kernel takes at most {_B5_MAX_TAPS} triplets per "
                         f"phase (a 1024-nt query), got {max_taps}")
    anchors = _b5_anchor_taps(qc)
    parts = ({}, {})  # offset -> [kinds, q u32[9]], anchor taps then the rest
    for p, (q8, care8) in enumerate(qc):
        for i in range(len(care8)):
            if not care8[i]:
                continue
            step = parts[anchors is not None and i not in anchors[p]].setdefault(i, [0, [0] * 9])
            for d in range(3):
                if (int(care8[i]) >> (3 * d)) & 7:
                    step[0] |= 1 << (3 * p + d)
                    step[1][3 * p + d] = ((int(q8[i]) >> (3 * d)) & 7) * _B5_REP
    steps = [(i, *parts[k][i]) for k in (0, 1) for i in sorted(parts[k])]
    table = np.zeros(_B5_HEAD + _B5_STEP * len(steps), dtype=np.uint32)
    table[0], table[1] = len(parts[0]), len(steps)
    for k, (i, kinds, q) in enumerate(steps):
        at = _B5_HEAD + _B5_STEP * k
        table[at] = (i // 9) << 16 | kinds << 5 | 3 * (i % 9)
        table[at + 1 : at + 10] = q
    max_off = max((i for i, _, _ in steps), default=0)
    return table, (max_off + 8) // 9 + 1


def _b5_digit_words(words: torch.Tensor) -> torch.Tensor:
    """Packed u32[2 N] -> the digit words int64[3, N]: row d holds digit d
    (a, b, c of t = a + 5 b + 25 c) of triplet j at bits 3 j, split
    unclamped (``eager.b5_b8_slots``), so a corrupt triplet's c is 5."""
    pair = eager.u32_to_i64(words).reshape(-1, 2)
    slots = eager.b5_b8_slots(eager.b5_word_triplets(pair[:, 0], pair[:, 1]))
    shifts = 3 * torch.arange(spec.TRIPLETS_PER_WORD, device=words.device, dtype=torch.int64)
    return torch.stack([(((slots >> (3 * d)) & 7) << shifts).sum(-1) for d in range(3)])  # disjoint: sum == OR


def _b5_zero_fields(v: torch.Tensor) -> torch.Tensor:
    """Bit 3 j + 2 set iff 3-bit field j < 9 of v is zero (one add finds the
    nonzero fields: (v & 3) + 3 <= 6 cannot carry out of a field)."""
    return ~(((v & _B5_LOW2) + _B5_LOW2) | v) & _B5_HIGH


def match_b5_bits_stream_plain(words: torch.Tensor, qc, n_starts: int) -> torch.Tensor:
    """Plain version of :func:`match_b5_bits_stream`, in the kernel's own
    arithmetic on int64 lanes (O(W) memory): the stream's digit words; per
    step of :func:`_b5_table`, the 27-bit window of each digit word at the
    step's offset, xor-ed with each caring phase's replicated query digit
    and OR-ed into that phase's differences; then one zero-field test per
    phase, whose hits at bits 3 j + 2 shift down to 3 j + p."""
    n = _check_stream(words, torch.uint32, 2, "packed u32[2 N]")
    table, look = _b5_table(qc)
    dig = torch.cat([_b5_digit_words(words), words.new_zeros((3, look + 1), dtype=torch.int64)], dim=1)
    diff = torch.zeros((3, n), dtype=torch.int64, device=words.device)
    for k in range(int(table[1])):
        at = _B5_HEAD + _B5_STEP * k
        a, kinds, sh = int(table[at]) >> 16, int(table[at]) >> 5 & 0x1FF, int(table[at]) & 31
        for d in range(3):
            if kinds & (0b1001001 << d):
                win = (dig[d, a : a + n] >> sh) | (dig[d, a + 1 : a + 1 + n] << (27 - sh))
                for p in range(3):
                    if kinds >> (3 * p + d) & 1:
                        diff[p] |= win ^ int(table[at + 1 + 3 * p + d])
    bits = sum(_b5_zero_fields(diff[p]) >> (2 - p) for p in range(3))  # disjoint bits: sum == OR
    return eager.i64_to_u32(_clear_tail(bits, n_starts, spec.NT_PER_WORD_B5))


def match_b5_bits_stream(words: torch.Tensor, qc, n_starts: int) -> torch.Tensor:
    """Base-5 exact search: packed u32[2 N] stream (N u64 words) -> match
    bits u32[N]; bit 3 j + p of word w is 1 iff the query (``qc``, the three
    phase tables of ``search.compile_query_b5``: N literal, ? wildcard)
    matches at nt 27 w + 3 j + p < n_starts.  Queries up to 1024 nt.

    Replaces ``cute_nucleotides_tpu/ops/pallas_kernels.py:
    match_b5_bits_rows``, whose bf16 de-interleave matmuls, (1024 + 256)-lane
    rows and per-query compiled constants were TPU artefacts.  A block of
    128 threads splits its 512 words and up to 40 lookahead words once into
    digit words in shared memory: the a, b and c digits of the nine
    triplets in 3-bit fields, by exact divisions, unclamped, so a corrupt
    triplet's c = 5 fits and never equals a literal N.  Each thread then
    takes 4 words.  One step of :func:`_b5_table` (one triplet offset)
    funnel-shifts each digit word it needs once and serves the three
    phases: the window xor the phase's query digit, replicated into the nine
    fields, tests all nine starts of a word at once, and one add per phase
    finds the starts where every field agreed.  The anchor steps run first,
    the rest only where an anchor left a start alive in some lane of the
    warp.  :func:`match_b5_bits_stream_plain` repeats this arithmetic.
    Bound by the integer ALU pipe (the steps' shifts and logic ops, at half
    the dispatch rate); 12 bytes move per 27 nt.  Time on the H100: PERF.md.
    """
    n = _check_stream(words, torch.uint32, 2, "packed u32[2 N]")
    table, look = _b5_table(qc)
    if not _on_cuda(words):
        return match_b5_bits_stream_plain(words, qc, n_starts)
    out = torch.empty(n, dtype=torch.uint32, device=words.device)
    if n:
        dev_table = _device_table(table.tobytes(), words.device)
        lib = _build.load()
        with torch.cuda.device(words.device):
            _launch(lib.cn_match_b5, words.data_ptr(), n, dev_table.data_ptr(), look, n_starts,
                    out.data_ptr(), _stream(words))
        match_b5_bits_stream.launches += 1
    return out


match_b5_bits_stream.launches = 0

# --- kernels #10, #11 and #13: k-mer codes and their histogram -------------------

def _same_device(first: torch.Tensor, *rest: torch.Tensor) -> bool:
    """:func:`_on_cuda` for several inputs, which must share one device."""
    on_cuda = _on_cuda(first)
    for t in rest:
        if t.device != first.device:
            raise ValueError(f"inputs on {first.device} and {t.device}")
        _on_cuda(t)
    return on_cuda


def _check_kmer_inputs(k: int, lo: int, hi: int, words: torch.Tensor, *succ: torch.Tensor) -> None:
    if not lo <= k <= hi:
        raise ValueError(f"k must be in [{lo}, {hi}], got {k}")
    _check_2d(words, torch.uint32, "u32[R, W] words")
    for t in succ:
        if t.dtype != torch.uint32 or t.shape != words.shape:
            raise TypeError(f"successor words {t.dtype}{tuple(t.shape)} do not match u32{tuple(words.shape)}")


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical ``x >> s`` (0 < s < 32) of the u32 bits in an int32 tensor
    (torch's ``>>`` on int32 sign-extends)."""
    return (x >> s) & ((1 << (32 - s)) - 1)


def _funnel(a: torch.Tensor, b: torch.Tensor, s: int) -> torch.Tensor:
    """Low 32 bits of (b:a) >> s, 0 < s < 32, on int32 tensors."""
    return _shr(a, s) | (b << (32 - s))


def kmer_codes_planar_plain(words: torch.Tensor, nxt: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version of :func:`kmer_codes_planar`, on int32 lanes (no int64
    temporaries), one shift plane at a time."""
    R, W = words.shape
    a, b = words.view(torch.int32), nxt.view(torch.int32)
    mask = (1 << (2 * k)) - 1
    out = torch.empty((R, spec.NT_PER_U32_2BIT, W), dtype=torch.int32, device=words.device)
    out[:, 0] = a & mask
    for s in range(1, spec.NT_PER_U32_2BIT):
        out[:, s] = _funnel(a, b, 2 * s) & mask
    return out.view(R, spec.NT_PER_U32_2BIT * W)


def kmer_codes_planar(words: torch.Tensor, nxt: torch.Tensor, k: int) -> torch.Tensor:
    """Planar k-mer codes, 1 <= k <= 15: words and their successor words
    u32[R, W] -> i32[R, 16 W].  Column ``W s + w`` of row r holds the code
    of the k-mer at nt ``16 w + s`` of the row: the 2k bits at bit 2s of
    ``(words[r, w], nxt[r, w])``, first nt in the low bits.  Any W.

    Replaces ``cute_nucleotides_tpu/ops/kmer.py:kmer_codes_planar``, whose
    (rows, 512)-lane panels were TPU blocks.  One thread per input word
    writes its 16 codes, one coalesced store per shift.  Bound by memory
    (8 B read, 64 B written per 16 nt).  Time on the H100: PERF.md.
    """
    _check_kmer_inputs(k, 1, 15, words, nxt)
    if not _same_device(words, nxt):
        return kmer_codes_planar_plain(words, nxt, k)
    R, W = words.shape
    out = torch.empty((R, spec.NT_PER_U32_2BIT * W), dtype=torch.int32, device=words.device)
    if words.numel():
        lib = _build.load()
        with torch.cuda.device(words.device):
            _launch(lib.cn_kmer_codes, words.data_ptr(), nxt.data_ptr(), out.data_ptr(), R, W, k,
                    _stream(words))
        kmer_codes_planar.launches += 1
    return out


kmer_codes_planar.launches = 0


def kmer_codes_planar_pair_plain(
    words: torch.Tensor, nxt: torch.Tensor, nxt2: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`kmer_codes_planar_pair`, on int32 lanes."""
    R, W = words.shape
    a, b, c = (t.view(torch.int32) for t in (words, nxt, nxt2))
    mask_hi = (1 << (2 * k - 32)) - 1  # 0 at k = 16
    lo = torch.empty((R, spec.NT_PER_U32_2BIT, W), dtype=torch.int32, device=words.device)
    hi = torch.empty_like(lo)
    lo[:, 0], hi[:, 0] = a, b & mask_hi
    for s in range(1, spec.NT_PER_U32_2BIT):
        lo[:, s] = _funnel(a, b, 2 * s)
        hi[:, s] = _funnel(b, c, 2 * s) & mask_hi
    shape = (R, spec.NT_PER_U32_2BIT * W)
    return lo.view(shape).view(torch.uint32), hi.view(shape).view(torch.uint32)


def kmer_codes_planar_pair(
    words: torch.Tensor, nxt: torch.Tensor, nxt2: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Planar k-mer codes, 16 <= k <= 31: words and their one- and two-ahead
    successors u32[R, W] -> (lo, hi) u32[R, 16 W]; ``lo | hi << 32`` is the
    2k-bit code, laid out as in :func:`kmer_codes_planar` (hi keeps 2k - 32
    bits, none at k = 16).

    Replaces ``cute_nucleotides_tpu/ops/kmer.py:kmer_codes_planar_pair``.
    One thread per input word writes its 16 (lo, hi) pairs, one coalesced
    store per shift and plane.  Bound by memory (12 B read, 128 B written
    per 16 nt).  Time on the H100: PERF.md.
    """
    _check_kmer_inputs(k, 16, 31, words, nxt, nxt2)
    if not _same_device(words, nxt, nxt2):
        return kmer_codes_planar_pair_plain(words, nxt, nxt2, k)
    R, W = words.shape
    lo = torch.empty((R, spec.NT_PER_U32_2BIT * W), dtype=torch.uint32, device=words.device)
    hi = torch.empty_like(lo)
    if words.numel():
        lib = _build.load()
        with torch.cuda.device(words.device):
            _launch(lib.cn_kmer_codes_pair, words.data_ptr(), nxt.data_ptr(), nxt2.data_ptr(), lo.data_ptr(),
                    hi.data_ptr(), R, W, k, _stream(words))
        kmer_codes_planar_pair.launches += 1
    return lo, hi


kmer_codes_planar_pair.launches = 0

#: code values the histogram counts: [0, 65536), the k <= 8 codes
HIST_BINS = 1 << 16


def count_codes_plain(codes: torch.Tensor, bins: int, step: int = 1 << 24) -> torch.Tensor:
    """i32[bins] count of each value of ``codes`` in [0, bins) (others are
    not counted), by ``index_add_`` on chunks of ``step`` codes, so that the
    selected copies stay small."""
    flat = codes.reshape(-1)
    counts = torch.zeros(bins, dtype=torch.int32, device=codes.device)
    for i in range(0, flat.numel(), step):
        c = flat[i : i + step]
        c = c[(c >= 0) & (c < bins)]
        counts.index_add_(0, c, torch.ones_like(c))
    return counts


def hist_codes_plain(codes: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`hist_codes`."""
    return count_codes_plain(codes, HIST_BINS).view(256, 256)


def hist_codes(codes: torch.Tensor) -> torch.Tensor:
    """Histogram of k-mer codes: i32[R, C] (any order) -> counts i32[256,
    256]; ``counts[j1, j2]`` is the number of codes ``256 j1 + j2``.  Codes
    outside [0, 65536) are not counted, as the reference's one-hots drop
    them.

    Replaces ``cute_nucleotides_tpu/ops/kmer.py:_hist_mxu``, whose int8
    one-hot matmuls on the TPU's matrix unit stood in for a scatter-add.
    Here one block per SM keeps the 65,536 bins as u16 counter pairs in 128
    KiB of shared memory (a counter that reaches 32768 moves that to the
    global bin), and code 0, where callers mask every out-of-range position,
    is counted by warp ballots instead of contended atomics.  Bound by
    reading the codes (4 B per code).  Time on the H100: PERF.md.
    """
    _check_2d(codes, torch.int32, "codes i32[R, C]")
    if not _on_cuda(codes):
        return hist_codes_plain(codes)
    counts = torch.zeros(HIST_BINS, dtype=torch.int32, device=codes.device)
    if codes.numel():
        lib = _build.load()
        with torch.cuda.device(codes.device):
            _launch(lib.cn_hist_codes, codes.data_ptr(), codes.numel(), counts.data_ptr(), _stream(codes))
        hist_codes.launches += 1
    return counts.view(256, 256)


hist_codes.launches = 0

# --- kernels #12 and #14: k-mer hashes and minimizers -----------------------------

#: words per row of the planar layout (the reference's ``kmer._PLANAR_W``)
PLANAR_W = 512

def _check_words(words: torch.Tensor, k: int, lo: int, hi: int) -> int:
    if not lo <= k <= hi:
        raise ValueError(f"k must be in [{lo}, {hi}], got {k}")
    return _check_stream(words, torch.uint32, 1, "packed u32[W]")


def kmer_hashes_planar_pair_plain(
    words: torch.Tensor, k: int, n_valid: int, *, canonical: bool = True, seg: int = 0
) -> torch.Tensor:
    """Plain version of :func:`kmer_hashes_planar_pair`: the successor
    panels, the planar pair codes (:func:`kmer_codes_planar_pair_plain`), the
    eager canonical fold and fmix32 of ``ops.kmer``, and the tail mask."""
    from . import kmer  # kmer imports this module

    Wt = _check_words(words, k, 16, 31)
    rows = spec.cdiv(Wt, PLANAR_W)
    total = rows * PLANAR_W
    seg = seg or Wt
    ext = torch.zeros(total + 2, dtype=torch.int32, device=words.device)
    ext[:Wt] = words.view(torch.int32)
    j = torch.arange(total, device=words.device) % seg
    panels = [ext[:total]] + [ext[d : total + d].masked_fill(j + d >= seg, 0) for d in (1, 2)]
    lo, hi = kmer_codes_planar_pair_plain(*(p.view(rows, PLANAR_W).view(torch.uint32) for p in panels), k)
    del panels, j
    if canonical:
        lo, hi = kmer.canonical_codes_pair(lo, hi, k)
    h = kmer._mix32(lo.view(torch.int32) ^ kmer._mix32(hi))
    kmer._mask_tail(h, n_valid, -1)
    return h.view(torch.uint32)


def kmer_hashes_planar_pair(
    words: torch.Tensor, k: int, n_valid: int, *, canonical: bool = True, seg: int = 0
) -> torch.Tensor:
    """Planar k-mer hashes for 16 <= k <= 31: a flat packed stream u32[W] ->
    u32[rows, 16 PLANAR_W], rows = ceil(W / PLANAR_W).  Column ``PLANAR_W s
    + c`` of row r holds fmix32(lo ^ fmix32(hi)) of the (canonical, with
    ``canonical``) 2k-bit code at position ``16 (PLANAR_W r + c) + s``, or
    0xFFFFFFFF where that position is >= ``n_valid``.  The successor words of
    a word are the next two of its segment (``seg`` words; 0 means the whole
    stream), and 0 past it, so a batch u32[B, Wr] hashes as B streams with
    ``seg = Wr``.

    Replaces ``cute_nucleotides_tpu/ops/kmer.py:kmer_hashes_planar`` (its
    inline pallas_call of ``_hashes_planar_pair_kernel``), whose one- and
    two-ahead successor panels were copies made for the TPU's blocks.  One
    thread per stream word reads its word and the next two straight from the
    stream, takes the reverse complement of those 48 nt once, cuts each
    k-mer's forward and reverse codes out with funnel shifts, folds them
    with a native unsigned 64-bit compare and writes its 16 hashes, one
    coalesced store per shift.  About 28 integer instructions and 4 bytes
    written per position.  Time on the H100: PERF.md.
    """
    Wt = _check_words(words, k, 16, 31)
    if seg < 0:
        raise ValueError(f"seg must be >= 0, got {seg}")
    if not _on_cuda(words):
        return kmer_hashes_planar_pair_plain(words, k, n_valid, canonical=canonical, seg=seg)
    rows = spec.cdiv(Wt, PLANAR_W)
    out = torch.empty((rows, spec.NT_PER_U32_2BIT * PLANAR_W), dtype=torch.uint32, device=words.device)
    if Wt:
        lib = _build.load()
        with torch.cuda.device(words.device):
            _launch(lib.cn_kmer_hashes_pair, words.data_ptr(), Wt, seg or Wt, PLANAR_W, rows, n_valid, k,
                    int(canonical), out.data_ptr(), _stream(words))
        kmer_hashes_planar_pair.launches += 1
    return out


kmer_hashes_planar_pair.launches = 0

#: lead/trail overlap words of the reference's minimizer panels
#: (pallas_kernels.MZ_OV): windows and k-mer taps span at most 16 * MZ_OV nt
MZ_OV = 128


def _check_minimizer_args(k: int, w: int) -> None:
    if not 1 <= k <= 15:
        raise ValueError("kernel minimizers cover k in [1, 15]")
    if not 1 <= w - 1 <= 16 * MZ_OV - k:
        raise ValueError(f"window w out of kernel range (got {w})")


def minimizer_bits_stream_plain(words: torch.Tensor, n: int, k: int, w: int, *, canonical: bool = True) -> torch.Tensor:
    """Plain version of :func:`minimizer_bits_stream`: the gather hashes of
    ``ops.kmer`` (the stream read as 0 past its end), the windowed torch
    passes and the packed mask."""
    from . import kmer  # kmer imports this module

    W = _check_stream(words, torch.uint32, 1, "packed u32[W]")
    _check_minimizer_args(k, w)
    length = n + k - 1
    cap = spec.cdiv(length, spec.NT_PER_U32_2BIT)
    if cap > W:
        words = torch.cat([words.view(torch.int32), words.new_zeros(cap - W, dtype=torch.int32)]).view(torch.uint32)
    h = kmer.kmer_hashes(words, length, k, canonical=canonical)
    return kmer.pack_bits(kmer._windowed_mask(h, w))


def minimizer_bits_stream(words: torch.Tensor, n: int, k: int, w: int, *, canonical: bool = True) -> torch.Tensor:
    """(w, k)-minimizer bits of the first n k-mers of a flat packed stream
    u32[W] (read as 0 past its end): -> u32[ceil(n/16)]; bit ``p % 16`` of
    word ``p // 16`` is 1 iff the hash of position p (fmix32 of its canonical
    code, with ``canonical``) is the least of some window of w hashes whose
    start lies in [0, n - w].  Bits 16..31 of every word are 0.  k <= 15,
    1 <= w - 1 <= 2048 - k.

    Replaces ``cute_nucleotides_tpu/ops/pallas_kernels.py:
    minimizer_bits_panels``, whose sixteen s-planes of 1280-lane panels
    stood in for a lane shift the TPU lacks.  Here a block of 256 threads
    (1024 once the halo passes 256 nt) covers 8 positions a thread: its own
    span and a halo of w - 1 nt (rounded up to whole words) on each side.
    Each thread hashes its 8 positions into registers and takes the forward
    windowed min and the backward windowed max by doubling (a sparse table:
    floor(log2 w) passes of a pairwise min or max at offsets 1, 2, 4, ..,
    then one pass that joins two overlapping halves of each window; 8
    passes at w = 10, none with a division or a value carried between
    steps).  Offsets below 8 stay in registers and warp shuffles, larger
    ones and the joins trade values through shared memory.  Two threads
    write each 16-bit output word.  Bound by integer work (the hashes and
    the passes); 4 bytes read per 16 positions.  Time on the H100: PERF.md.
    """
    W = _check_stream(words, torch.uint32, 1, "packed u32[W]")
    _check_minimizer_args(k, w)
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    if not _on_cuda(words):
        return minimizer_bits_stream_plain(words, n, k, w, canonical=canonical)
    out = torch.empty(spec.cdiv(n, spec.NT_PER_U32_2BIT), dtype=torch.uint32, device=words.device)
    lib = _build.load()
    with torch.cuda.device(words.device):
        _launch(lib.cn_minimizer_bits, words.data_ptr(), W, n, k, w, int(canonical), out.data_ptr(),
                _stream(words))
    minimizer_bits_stream.launches += 1
    return out


minimizer_bits_stream.launches = 0

# --- kernel #7: base-5 GC count -----------------------------------------------------

def gc_b5_stream_plain(words: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gc_b5_stream`: the parity formula of every
    triplet (:func:`.seqops.b5_word_gc`), summed."""
    _check_stream(words, torch.uint32, 2, "packed u32[2 N]")
    return seqops.b5_word_gc(seqops._b5_words(words)).sum().to(torch.int32)


def gc_b5_stream(words: torch.Tensor) -> torch.Tensor:
    """GC count of a flat base-5 stream u32[2 N] (N u64 words) -> int32
    scalar: over the 9 triplets t of every word, ``((t ^ u) & 1) + ((u ^ v)
    & 1) + (v & 1)`` with u = t // 5, v = t // 25.  Bit 63 lies in no
    triplet, zero words count 0, and a corrupt triplet counts by the same
    formula (t = 125 counts 1, where a decode reads 'AAN').

    Replaces ``cute_nucleotides_tpu/ops/pallas_kernels.py:gc_b5_row_sums``
    (driven by ``gc_content_b5_stream_pallas``), whose bf16 gather-fold on
    the TPU's matrix unit put each triplet on its own lane and whose 256-u32
    panel rows padded the stream.  Here each thread reads 16 bytes (two
    words) per step of a grid-stride loop and looks each triplet's count up
    in a 128-byte table in shared memory (built from the formula; one table
    word per bank, so no conflicts); warp shuffles and one ``atomicAdd`` per
    block sum the counts, and an odd last word is masked in the kernel.
    Bound by memory (8 bytes read per 27 nt).  Time on the H100: PERF.md.
    """
    n = _check_stream(words, torch.uint32, 2, "packed u32[2 N]")
    if not _on_cuda(words):
        return gc_b5_stream_plain(words)
    out = torch.zeros(1, dtype=torch.int32, device=words.device)
    if n:
        lib = _build.load()
        with torch.cuda.device(words.device):
            _launch(lib.cn_gc_b5, words.data_ptr(), n, out.data_ptr(), _stream(words))
        gc_b5_stream.launches += 1
    return out.reshape(())


gc_b5_stream.launches = 0

# --- kernel #18: radix sort of u32 key pairs ---------------------------------------

_SIGN = -(1 << 31)  # the sign bit of an int32


def _check_pairs(hi: torch.Tensor, lo: torch.Tensor) -> int:
    if hi.dtype != torch.uint32 or lo.dtype != torch.uint32 or hi.ndim != 1 or hi.shape != lo.shape:
        raise TypeError(f"expected two u32[n] key planes, got {hi.dtype}{tuple(hi.shape)} and "
                        f"{lo.dtype}{tuple(lo.shape)}")
    return hi.shape[0]


def pair_keys(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """u32 pairs -> int64 keys ``(hi ^ 0x80000000) << 32 | lo``, flat: the
    flipped sign bit makes signed order the pairs' unsigned order, so the
    all-ones pair (``kmer_counts``' sentinel) becomes the int64 maximum and
    sorts last (unflipped it would be -1 and sort first)."""
    key = (hi.reshape(-1).view(torch.int32) ^ _SIGN).to(torch.int64) << 32
    return key.bitwise_or_(lo.reshape(-1).view(torch.int32).to(torch.int64) & eager.U32)


def split_keys(key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`pair_keys`: int64 keys -> (hi, lo) u32."""
    return ((key >> 32).to(torch.int32) ^ _SIGN).view(torch.uint32), key.to(torch.int32).view(torch.uint32)


def bitonic_size(n0: int) -> int:
    """The reference's bitonic network size for n0 pairs: n0 rounded up to
    a power of two, at least 2.  It sets the ``prefer="bitonic"`` route's
    envelope in :func:`.sort.sort_pairs`; the radix kernel needs no padding."""
    return 1 << max((n0 - 1).bit_length(), 1)


#: bits per digit and keys per tile of kernel #18's passes (``kBits`` and
#: ``kTileKeys`` in csrc/sort.cu, whose entry point refuses a status array
#: too short for its own tiles)
SORT_BITS, SORT_TILE = 8, 4096
_SORT_BINS, _SORT_PASSES = 1 << SORT_BITS, 64 // SORT_BITS


def _radix_pass_plain(key: torch.Tensor, shift: int) -> torch.Tensor:
    """One stable pass of kernel #18 on the digit at bit ``shift`` of the
    int64 keys, placed as the kernel places it: at its bin's start (the
    exclusive scan of the digit's histogram), plus the bin's count in all
    earlier tiles of SORT_TILE keys (what the look-back hands over), plus
    its rank among the keys of its bin in its own tile."""
    n, bins = key.numel(), _SORT_BINS
    tiles = spec.cdiv(n, SORT_TILE)
    digit = (key >> shift) & (bins - 1)
    count = torch.bincount(digit, minlength=bins)
    at = (torch.arange(n, device=key.device) // SORT_TILE) * bins + digit  # (tile, bin)
    per_tile = torch.bincount(at, minlength=tiles * bins).view(tiles, bins)
    carried = per_tile.cumsum(0) - per_tile
    dest = (count.cumsum(0) - count)[digit] + carried.view(-1)[at]
    del at, carried
    # the rank in the tile's bin: a key's place in its tile's stable digit
    # order less its bin's first place there (past n0, bin 256 sorts last)
    padded = torch.full((tiles * SORT_TILE,), bins, dtype=torch.int64, device=key.device)
    padded[:n] = digit
    del digit
    order = torch.sort(padded.view(tiles, SORT_TILE), dim=1, stable=True)
    first = torch.cat([per_tile.cumsum(1) - per_tile, per_tile.sum(1, keepdim=True)], 1)
    place = torch.arange(SORT_TILE, device=key.device) - first.gather(1, order.values)
    rank = torch.empty_like(place).scatter_(1, order.indices, place)
    del order, place, padded
    out = torch.empty_like(key)
    out[dest + rank.view(-1)[:n]] = key
    return out


def sort_pairs_bitonic_plain(hi: torch.Tensor, lo: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`sort_pairs_bitonic`: the kernel's eight
    stable passes over the u64 keys ``hi << 32 | lo`` (as int64 bits),
    least significant digit first, each with the kernel's tiles
    (:func:`_radix_pass_plain`)."""
    n0 = _check_pairs(hi, lo)
    if n0 == 0:
        return hi.clone(), lo.clone()
    key = hi.view(torch.int32).to(torch.int64) << 32
    key.bitwise_or_(lo.view(torch.int32).to(torch.int64) & eager.U32)
    for p in range(_SORT_PASSES):
        key = _radix_pass_plain(key, SORT_BITS * p)
    return (key >> 32).to(torch.int32).view(torch.uint32), key.to(torch.int32).view(torch.uint32)


def sort_pairs_bitonic(hi: torch.Tensor, lo: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort u32 pairs (hi, lo)[n] ascending, unsigned and lexicographic ->
    (hi_sorted, lo_sorted) u32[n], by radix; n < 2^30 on the card.  The name
    is the reference's route (``sort_pairs(prefer="bitonic")``).

    Replaces ``cute_nucleotides_tpu/ops/sort.py:_sort_pairs_bitonic`` (its
    ``_k1_kernel``/``_k2_kernel`` through ``_strip_call``), a bitonic
    network in row and transposed layouts that served the TPU's VMEM and
    its missing scatter.  Here each pair is the u64 key ``hi << 32 | lo``,
    sorted least significant digit first in eight stable passes of 8-bit
    digits over the n pairs themselves: one kernel counts every digit's
    histogram, then each pass ranks a tile of 4096 keys by digit in shared
    memory (warp multisplit with ``__match_any_sync``), learns the bins'
    counts in earlier tiles by decoupled look-back and writes its keys out
    one run per bin.  Bound by memory: 136 B moved per pair, against the
    16 B of one read and one write.  Time on the H100: PERF.md.

    ``.launches`` counts calls of this wrapper: one call launches the
    histogram kernel and the eight passes, after nine memsets (the
    histograms, and the status array before each pass).
    """
    n0 = _check_pairs(hi, lo)
    if not _same_device(hi, lo):
        return sort_pairs_bitonic_plain(hi, lo)
    hi_s, lo_s = torch.empty_like(hi), torch.empty_like(lo)
    if n0:
        dev = hi.device
        keys = torch.empty(2 * n0, dtype=torch.int64, device=dev)
        hist = torch.empty(_SORT_PASSES * _SORT_BINS, dtype=torch.int32, device=dev)
        status = torch.empty((spec.cdiv(n0, SORT_TILE) + 1) * _SORT_BINS, dtype=torch.int32, device=dev)
        lib = _build.load()
        with torch.cuda.device(dev):
            _launch(lib.cn_sort_pairs_radix, hi.data_ptr(), lo.data_ptr(), keys.data_ptr(), hist.data_ptr(),
                    status.data_ptr(), status.numel(), hi_s.data_ptr(), lo_s.data_ptr(), n0, _stream(hi))
        sort_pairs_bitonic.launches += 1
    return hi_s, lo_s


sort_pairs_bitonic.launches = 0

# --- kernel #19: the Myers bit-vector scan ---------------------------------------

#: the scan's modes, as csrc/align.cu numbers them
MYERS_MODES = {"global": 0, "semiglobal": 1, "prefix": 2, "ends": 3}
#: query rows per Peq block
MYERS_BLOCK = 32
#: ``cn_myers`` refuses more blocks than this without a scratch
_MYERS_SCRATCH_FROM = 8
#: text positions whose Eq the plain version gathers at once
_MYERS_PLAIN_SPAN = 256


def overlap_rows(flat: torch.Tensor, R: int, wrb: int, H: int) -> torch.Tensor:
    """Overlapping row panels u32[R, wrb + H] of a flat stream: row ``r`` is
    ``flat[r*wrb : r*wrb + wrb + H]``, zeros past the stream.  The reference's
    ``_overlap_rows`` (``ops/align.py:706``): no gather, and a halo that spans
    more rows than exist takes an all-``R`` zero block."""
    flat = flat.view(torch.int32).reshape(-1)  # zeros and copies on the int32 view: the card's uint32 has few ops
    pad = R * wrb - flat.numel()
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    b = flat.reshape(R, wrb)
    parts = [b]
    h, k = H, 1
    while h > 0:  # a halo wider than a row spans successive successors
        take = min(wrb, h)
        parts.append(torch.cat([b[k:, :take], b.new_zeros(min(k, R), take)]))
        h -= take
        k += 1
    return torch.cat(parts, 1).view(torch.uint32)


def text_codes(rows: torch.Tensor, b5: bool) -> torch.Tensor:
    """Text rows u32[R, L] -> int64 codes [R, n]: 2-bit, 16 codes a u32
    (LSB first); base-5, 27 digits a u32 pair (9 triplets of 7 bits, each
    split by t * 205 >> 10 and t * 41 >> 10, so a corrupt triplet's high
    digit is 5)."""
    R, L = rows.shape
    if not b5:
        w = eager.u32_to_i64(rows)
        return ((w[..., None] >> (2 * torch.arange(16, device=w.device))) & 3).reshape(R, 16 * L)
    t = (seqops._b5_words(rows)[..., None] >> (7 * torch.arange(9, device=rows.device))) & 0x7F
    return torch.stack(seqops._b5_digits(t), -1).reshape(R, 27 * (L // 2))


def myers_plan(nb: int, rows: int, mode: str = "global", device=None) -> tuple[int, int]:
    """#19's launch plan for ``rows`` pairs of ``nb``-block queries in
    ``mode`` on a card (the current one by default), as ``csrc/align.cu``
    makes it: (lanes a pair, blocks a lane), blocks 0 being the scratch
    form.  Reads it from the entry point ``cn_myers_plan``; needs CUDA."""
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(device):
        _launch(_build.load().cn_myers_plan, nb, rows, MYERS_MODES[mode], out)
    return out[0], out[1]


def _check_myers(peq, qlens, words, tlens, row_stride: int, row_len: int, mode: str, b5: bool,
                 max_errors) -> tuple[int, int, int]:
    if mode not in MYERS_MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {tuple(MYERS_MODES)}")
    if peq.dtype != torch.uint32 or peq.ndim != 3:
        raise TypeError(f"expected Peq u32[R, A, NB], got {peq.dtype}{tuple(peq.shape)}")
    R, A, nb = peq.shape
    if A != (5 if b5 else 4):
        raise ValueError(f"expected {5 if b5 else 4} Peq planes, got {A}")
    if mode == "ends" and b5:
        raise ValueError("the base-5 scan has no ends mode")
    lens = (("qlens", qlens), ("tlens", tlens)) + ((("max_errors", max_errors),) if mode == "ends" else ())
    for name, t in lens:
        if t is None or t.dtype != torch.int32 or tuple(t.shape) != (R,):
            raise TypeError(f"expected {name} i32[{R}], got {None if t is None else (t.dtype, tuple(t.shape))}")
    if words.dtype != torch.uint32 or words.ndim != 1:
        raise TypeError(f"expected a flat u32 text stream, got {words.dtype}{tuple(words.shape)}")
    if b5 and (row_stride % 2 or row_len % 2):
        raise ValueError("base-5 text rows must hold whole u32 pairs")
    if not 0 <= row_stride <= row_len or R * row_stride < words.numel():
        raise ValueError(f"{R} rows of {row_len} u32 every {row_stride} do not cover {words.numel()} u32")
    return R, A, nb


def myers_scan_plain(peq, qlens, words, tlens, row_stride: int, row_len: int, *, mode: str, b5: bool = False,
                     max_errors=None):
    """Plain version of :func:`myers_scan`: the reference's char step
    (``ops/align.py:_scan_setup``) over (R,) vectors on int64 lanes, masked
    to 32 bits after each operation, one text position at a time, every
    row's state frozen past its ``tlens`` -- a few dozen tensor operations a
    position.  The rows come from :func:`overlap_rows`, Eq is a gather of
    the code's plane (digit 5 takes plane 0)."""
    R, A, nb = _check_myers(peq, qlens, words, tlens, row_stride, row_len, mode, b5, max_errors)
    dev, M = words.device, eager.U32
    codes = text_codes(overlap_rows(words, R, row_stride, row_len - row_stride), b5)
    codes = torch.where(codes < A, codes, 0)  # a corrupt base-5 digit 5 selects plane 0
    P = eager.u32_to_i64(peq)
    ql, tl = qlens.to(torch.int64), tlens.to(torch.int64)
    m1 = ql.clamp(min=1) - 1
    # the score reads bit m1 % 32 of block m1 // 32 (no block when the query outruns them)
    hmask = torch.where(torch.arange(nb, device=dev) == (m1 // MYERS_BLOCK)[:, None], 1 << (m1 % MYERS_BLOCK)[:, None], 0)
    pv = torch.full((R, nb), M, dtype=torch.int64, device=dev)
    mv = torch.zeros_like(pv)
    score, best = ql.clone(), ql.clone()
    best_end = torch.zeros_like(ql)
    phin0 = torch.full((R, 1), 0 if mode in ("semiglobal", "ends") else 1, dtype=torch.int64, device=dev)
    track, emit = mode in ("semiglobal", "prefix"), mode == "ends"
    rows = torch.arange(R, device=dev)[:, None]
    cols = []
    n = min(codes.shape[1], max(int(tl.max()), 0) if R else 0)
    for j0 in range(0, n, _MYERS_PLAIN_SPAN):  # Eq and validity a span of positions at a time
        eqs = P[rows, codes[:, j0 : j0 + _MYERS_PLAIN_SPAN]]  # (R, span, NB)
        valids = (j0 + torch.arange(eqs.shape[1], device=dev)) < tl[:, None]
        for k in range(eqs.shape[1]):
            e, valid, j = eqs[:, k], valids[:, k], j0 + k
            a = e & pv
            if nb == 1:
                s = (a + pv) & M
            else:
                s = torch.empty_like(a)
                cin = 0
                for b in range(nb):  # the adder's carry runs up the blocks
                    t = a[:, b] + pv[:, b] + cin
                    s[:, b], cin = t & M, t >> 32
            xv = e | mv
            xh = (s ^ pv) | e
            ph = mv | (~(xh | pv) & M)
            mh = pv & xh
            new_score = score + ((ph & hmask) != 0).sum(1) - ((mh & hmask) != 0).sum(1)
            ps = ((ph << 1) & M) | torch.cat([phin0, ph[:, :-1] >> 31], 1)
            ms = ((mh << 1) & M) | torch.cat([torch.zeros_like(phin0), mh[:, :-1] >> 31], 1)
            pv = torch.where(valid[:, None], ms | (~(xv | ps) & M), pv)
            mv = torch.where(valid[:, None], ps & xv, mv)
            score = torch.where(valid, new_score, score)
            if track:
                better = valid & (score < best)
                best = torch.where(better, score, best)
                best_end = torch.where(better, j + 1, best_end)
            if emit:
                cols.append(valid & (score <= max_errors))
    if emit:
        out = torch.zeros((R, 16 * row_len), dtype=torch.bool, device=dev)
        if cols:
            out[:, : len(cols)] = torch.stack(cols, 1)
        return out
    if mode == "global":
        return score.to(torch.int32)
    return best.to(torch.int32), best_end.to(torch.int32)


def _myers_on_cuda(peq: torch.Tensor, *rest: torch.Tensor) -> bool:
    """False when every input lies on the CPU; True when all lie on one
    CUDA device in a layout the kernel reads: Peq's planes contiguous per
    row (any row stride, 0 for one query broadcast by ``expand``), the rest
    contiguous.  Raises for anything else; nothing is copied."""
    dev = peq.device
    if any(t.device != dev for t in rest):
        raise ValueError(f"inputs on {sorted({str(t.device) for t in (peq, *rest)})}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    _, A, nb = peq.shape
    if (nb > 1 and peq.stride(2) != 1) or (A > 1 and peq.stride(1) != nb) or peq.stride(0) < 0:
        raise ValueError(f"Peq planes must be contiguous per row, got strides {peq.stride()}")
    for t in rest:
        if not t.is_contiguous():
            raise ValueError("kernel input must be contiguous")
    return True


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def myers_scan(peq, qlens, words, tlens, row_stride: int, row_len: int, *, mode: str, b5: bool = False,
               max_errors=None):
    """Myers bit-vector scan of R (query, text) pairs.  Row r's query is
    ``peq[r]`` (u32[A, NB]: bit i of block i // 32 of plane c is set where
    query nt i matches code c; A = 4 codes, or 5 digits with ``b5``) of
    length ``qlens[r]``; its text is ``row_len`` u32 from u32 ``r *
    row_stride`` of the flat stream ``words`` (zeros past its end: 16 2-bit
    codes a u32, or 27 base-5 digits a u32 pair), of which the first
    ``tlens[r]`` nt count.  Returns, by ``mode``:

    * ``"global"``: the score D[m][n] (row 0's input +1), i32[R];
    * ``"semiglobal"``: (best, first end) over end positions with row 0's
      input 0, i32[R] each; ``"prefix"``: the same with input +1;
    * ``"ends"`` (2-bit): bool[R, 16 row_len], position j set where j <
      tlens[r] and the semiglobal score ending at j + 1 is <= max_errors[r].

    A batch u32[R, Wt] is ``words = twords.view(-1)``, ``row_stride =
    row_len = Wt``; a long stream in rows with a halo is ``row_stride =
    wrb``, ``row_len = wrb + H``.

    Replaces the word scans of ``cute_nucleotides_tpu/ops/align.py``
    (``_myers_scan_words`` :336, ``_myers_scan_words_b5`` :385), which are
    ``lax.scan`` loops and not Pallas kernels.  A wavefront over a warp's
    lanes (``csrc/align.cu``): a pair takes L lanes, each holding one or two
    32-row blocks' PV and MV in registers and their Eq planes in shared
    memory; lane b takes text char s - D b at step s and gets the carry and
    the Ph and Mh bits of the lane below by ``__shfl_up_sync``; the mode is
    a template argument, global mode reads its score from the last column.
    The launch plan (:func:`myers_plan` reads it) gives one lane to one or
    two blocks, else pow2(nb) lanes of one block, or half as many of two
    once those would pass one warp on each of the card's schedulers (SMs x
    4 x 32 lanes; two warps in semiglobal mode); queries past 32 blocks
    (1024 nt) take the scratch form, one pair a thread.  Bound by integer
    issue: at least 11 NB + 2 (global) to 8 (semiglobal, prefix)
    instructions per 2-bit text nt, 5/3 more for base-5
    (``utils.profiling.myers_ops``).  Time on the H100: PERF.md.
    """
    R, A, nb = _check_myers(peq, qlens, words, tlens, row_stride, row_len, mode, b5, max_errors)
    rest = (qlens, words, tlens) + ((max_errors,) if mode == "ends" else ())
    if not _myers_on_cuda(peq, *rest):
        return myers_scan_plain(peq, qlens, words, tlens, row_stride, row_len, mode=mode, b5=b5,
                                max_errors=max_errors)
    dev = words.device
    score = best = best_end = ends = scratch = None
    if mode == "global":
        score = torch.empty(R, dtype=torch.int32, device=dev)
    elif mode == "ends":
        ends = torch.zeros((R, 16 * row_len), dtype=torch.bool, device=dev)
    else:
        best, best_end = torch.empty(R, dtype=torch.int32, device=dev), torch.empty(R, dtype=torch.int32, device=dev)
    if nb > _MYERS_SCRATCH_FROM:  # the entry point's rule; only the scratch form reads it
        scratch = torch.empty(2 * nb * R, dtype=torch.uint32, device=dev)
    if R:
        lib = _build.load()
        with torch.cuda.device(dev):
            _launch(lib.cn_myers, peq.data_ptr(), peq.stride(0), nb, qlens.data_ptr(), words.data_ptr(),
                    words.numel(), row_stride, row_len, tlens.data_ptr(), _ptr(max_errors), MYERS_MODES[mode],
                    int(b5), R, _ptr(score), _ptr(best), _ptr(best_end), _ptr(ends), _ptr(scratch), _stream(words))
        myers_scan.launches += 1
    if mode == "global":
        return score
    return ends if mode == "ends" else (best, best_end)


myers_scan.launches = 0

#: query blocks the stream form takes (``csrc/align.cu`` ``kRegBlocks``)
_MYERS_STREAM_BLOCKS = 32


def _stream_peq(peq, b5: bool) -> np.ndarray:
    """The query's Peq as host u32[A, NB], contiguous (a tensor on the card
    is refused by its conversion to numpy)."""
    peq = np.ascontiguousarray(peq, dtype=np.uint32)
    if peq.ndim != 2 or peq.shape[0] != (5 if b5 else 4) or peq.shape[1] < 1:
        raise TypeError(f"expected Peq u32[{5 if b5 else 4}, NB], got {peq.shape}")
    return peq


def _stream_key_by_rows(scan, peq: np.ndarray, m: int, words, length: int, rows: int, row_stride: int,
                        row_len: int, b5: bool) -> torch.Tensor:
    """The stream's rows through ``scan`` (:func:`myers_scan` or its plain
    version), each row's text length and query made as tensors, then the
    key's reduction in eager ops on the words' device."""
    dev = words.device
    nt, unit = (spec.NT_PER_WORD_B5, 2) if b5 else (spec.NT_PER_U32_2BIT, 1)  # nt per text unit, u32 per unit
    base = nt * (row_stride // unit) * torch.arange(rows, dtype=torch.int64, device=dev)
    tl = (length - base).clamp(0, nt * (row_len // unit)).to(torch.int32)
    p = torch.from_numpy(peq).to(dev)
    best, end = scan(p[None].expand(rows, *p.shape), torch.full((rows,), m, dtype=torch.int32, device=dev), words, tl,
                     row_stride, row_len, mode="semiglobal", b5=b5)
    best = best.to(torch.int64)
    return ((best << 32) | torch.where(best < m, base + end, 0)).min()


def myers_stream_best_plain(peq, m: int, words, length: int, rows: int, row_stride: int, row_len: int, *,
                            b5: bool = False) -> torch.Tensor:
    """Plain version of :func:`myers_stream_best`: :func:`myers_scan_plain`
    over the same rows, then the same key, the least of each row's ``(best
    << 32) | global end``."""
    return _stream_key_by_rows(myers_scan_plain, _stream_peq(peq, b5), m, words, length, rows, row_stride, row_len,
                               b5)


def myers_stream_best(peq, m: int, words, length: int, rows: int, row_stride: int, row_len: int, *,
                      b5: bool = False, out: torch.Tensor | None = None) -> torch.Tensor:
    """The best semiglobal match of ONE query over ``rows`` rows of one flat
    stream ``words`` (u32; row r is ``row_len`` u32 from u32 ``r *
    row_stride``, zeros past the end) that holds ``length`` nt, as one int64
    0-d tensor on the words' device, the key ``(dist << 32) | end``: the
    least edit distance of the whole query against any substring of a row
    and the first global end reaching it, ``end`` 0 where nothing beats the
    trivial distance ``m`` (``(m << 32)``).  ``peq`` is the query's Peq in
    host memory (u32[A, NB], a numpy array or a CPU tensor: A = 4 codes, or
    5 digits with ``b5``) and ``m`` its length; row r scans ``min(max(length
    - r * nt_per_row, 0), its capacity)`` nt, ``nt_per_row`` the nt of
    ``row_stride`` u32.

    On the card, queries of up to 32 blocks (1024 nt) take #19's stream form
    (``csrc/align.cu`` ``myers_stream``, entry point ``cn_myers_stream``):
    the Peq by value in the kernel's parameters, each row's text length
    worked out in the kernel, the key folded by a shuffle min a warp and one
    ``atomicMin`` into one slot, which the entry point first sets to all
    ones: one host-to-C call, a memset and a kernel a stream.  Longer
    queries run :func:`myers_scan` over the rows and reduce in eager ops.
    A launch of the stream form counts in ``.launches`` here and in
    ``myers_scan.launches`` (a form of #19).

    ``out``, an int64 0-d tensor on the words' device, takes the key in
    place of a new tensor: a caller that reads each key back before its next
    call keeps one and allocates nothing a call."""
    peq = _stream_peq(peq, b5)
    nb = peq.shape[1]
    if words.dtype != torch.uint32 or words.ndim != 1:
        raise TypeError(f"expected a flat u32 text stream, got {words.dtype}{tuple(words.shape)}")
    if not 1 <= m <= MYERS_BLOCK * nb:
        raise ValueError(f"query length {m} outside the Peq's {nb} blocks")
    if b5 and (row_stride % 2 or row_len % 2):
        raise ValueError("base-5 text rows must hold whole u32 pairs")
    if rows < 1 or not 0 < row_stride <= row_len or rows * row_stride < words.numel():
        raise ValueError(f"{rows} rows of {row_len} u32 every {row_stride} do not cover {words.numel()} u32")
    if not 0 <= length < 2**31:
        raise ValueError(f"stream length {length} outside [0, 2^31)")
    dev = words.device
    if out is not None and (out.dtype != torch.int64 or out.ndim != 0 or out.device != dev):
        raise TypeError(f"expected an int64 0-d key on {dev}, got {out.dtype}{tuple(out.shape)} on {out.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    if dev.type == "cpu" or nb > _MYERS_STREAM_BLOCKS:
        scan = myers_scan_plain if dev.type == "cpu" else myers_scan
        key = _stream_key_by_rows(scan, peq, m, words, length, rows, row_stride, row_len, b5)
        return key if out is None else out.copy_(key)
    if not words.is_contiguous():
        raise ValueError("kernel input must be contiguous")
    key = torch.empty((), dtype=torch.int64, device=dev) if out is None else out
    # the raw stream handle, not _stream's Python Stream object: a call is one launch and the host paces the card
    _launch(_build.load().cn_myers_stream, peq.ctypes.data, nb, m, words.data_ptr(), words.numel(), row_stride,
            row_len, length, int(b5), rows, key.data_ptr(), dev.index, torch._C._cuda_getCurrentRawStream(dev.index))
    myers_stream_best.launches += 1
    myers_scan.launches += 1
    return key


myers_stream_best.launches = 0

# --- the base-5 Peq build ----------------------------------------------------------


def peq_b5_plain(qwords: torch.Tensor, qlens: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`peq_b5`: the digits of :func:`text_codes`,
    each compared with the five values as an int64 one-hot, weighted by its
    row's bit and summed (``ops/align.py``: ``_peq_from_codes`` of
    ``_unpack_digits_b5_t``, the reference's two steps)."""
    from . import align  # align imports this module

    return align._peq_from_codes(align._unpack_digits_b5_t(qwords).T, qlens, 5)


def peq_b5(qwords: torch.Tensor, qlens: torch.Tensor) -> torch.Tensor:
    """Base-5 Peq of packed queries: u32[B, Wq] (Wq even, Wq / 2 u64 words of
    27 digits; rows contiguous, any row stride) and i32[B] lengths -> u32[B,
    5, NB], NB = max(1, ceil(27 Wq / 2 / 32)), the Peq of :func:`myers_scan`
    with ``b5``.  Bit ``i % 32`` of ``peq[b, c, i // 32]`` is set where row
    ``i`` of query ``b`` (digit k of triplet j of word w is row 27 w + 3 j +
    k) is digit ``c`` and ``i < min(qlens[b], 27 Wq / 2)``; a corrupt
    triplet's (125..127) digit 5 sets no plane.

    Replaces no Pallas kernel but the JAX package's jnp build,
    ``cute_nucleotides_tpu/ops/align.py:573`` ``_unpack_digits_b5_t`` and
    ``:605`` ``_peq_from_codes``, which the port ran as eager ops (an int64
    one-hot [B, 5, NB, 32] and its sum).  ``csrc/align.cu``'s
    ``peq_b5_kernel``: a thread builds one query, its words read 16 bytes at
    a time where they align; each triplet is one lookup in a 128-entry table
    in shared memory of its digits sliced by bit, so that a word gives three
    27-bit bit slices and each 32-row block's five plane words are one logic
    op each; a warp stages its 32 queries' rows in shared memory and stores
    them as one run (Peq rows of up to 8 blocks; longer ones word by word).
    Bound by its bytes: the words and the length in, 20 bytes a block out
    (1,048,576 queries of 4 u32: 62.9 MB, 0.019 ms at 3.35 TB/s).  Time on
    the H100: PERF.md.
    """
    if qwords.ndim != 2:
        raise TypeError(f"expected query words u32[B, Wq], got {qwords.dtype}{tuple(qwords.shape)}")
    if qwords.shape[1] % 2:
        raise ValueError("base-5 packed stream must have even u32 count")
    if qwords.dtype != torch.uint32:
        raise TypeError(f"expected uint32 words, got {qwords.dtype}")
    B, wq = qwords.shape
    if qlens.dtype != torch.int32 or tuple(qlens.shape) != (B,):
        raise TypeError(f"expected qlens i32[{B}], got {(qlens.dtype, tuple(qlens.shape))}")
    dev = qwords.device
    if qlens.device != dev:
        raise ValueError(f"inputs on {sorted({str(dev), str(qlens.device)})}")
    if dev.type == "cpu":
        return peq_b5_plain(qwords, qlens)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if wq > 1 and qwords.stride(1) != 1:
        raise ValueError(f"query words must be contiguous within a row, got strides {qwords.stride()}")
    if not qlens.is_contiguous():
        raise ValueError("kernel input must be contiguous")
    nb = max(1, -(-(27 * (wq // 2)) // MYERS_BLOCK))
    peq = torch.empty((B, 5, nb), dtype=torch.uint32, device=dev)
    if B:
        lib = _build.load()
        with torch.cuda.device(dev):
            _launch(lib.cn_peq_b5, qwords.data_ptr(), qwords.stride(0), wq, qlens.data_ptr(), B, nb, peq.data_ptr(),
                    _stream(qwords))
        peq_b5.launches += 1
    return peq


peq_b5.launches = 0

WRAPPERS = (encode_2bit_nt4, decode_2bit_nt4, encode_2bit_nt4_checked, encode_2bit_nt4_mxu,
            encode_b5_stream, decode_b5_stream, match_bits_stream, match_b5_bits_stream,
            kmer_codes_planar, kmer_codes_planar_pair, hist_codes, kmer_hashes_planar_pair,
            minimizer_bits_stream, gc_b5_stream, sort_pairs_bitonic, encode_b5_planar, decode_b5_nt4_panels,
            decode_b5_panels, myers_scan, peq_b5, myers_stream_best)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


# --- (..., L) adapters -------------------------------------------------------

def _rows(t: torch.Tensor, width: int) -> torch.Tensor:
    """View t as [rows, width] without copying (raises if it cannot)."""
    rows = math.prod(t.shape[:-1])
    if t.numel() == 0:  # an empty tensor may carry strides no view accepts
        return t.new_empty((rows, width))
    return t.view(rows, width)


def _as_nt4(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.uint8:
        raise TypeError(f"expected uint8 bytes, got {x.dtype}")
    L = x.shape[-1]
    if L % 16:
        raise ValueError(f"last dim {L} not a multiple of 16")
    return _rows(x, L).view(torch.uint32)


def encode_2bit_words(x: torch.Tensor, variant: str = "mul") -> torch.Tensor:
    """u8[..., L] (L % 16 == 0) -> packed u32[..., L // 16]."""
    eager.check_variant(variant, ENCODE_2BIT_VARIANTS)
    nt4 = _as_nt4(x)
    if variant == "mxu":
        words = encode_2bit_nt4_mxu(nt4)
    else:
        words = encode_2bit_nt4(nt4, variant).view(torch.uint32)
    return words.view(*x.shape[:-1], x.shape[-1] // 16)


def encode_2bit_words_checked(
    x: torch.Tensor, variant: str = "mul"
) -> tuple[torch.Tensor, torch.Tensor]:
    """u8[..., L] -> (u32[..., L // 16], bool[...] row has a bad byte)."""
    eager.check_variant(variant, ENCODE_2BIT_VARIANTS)
    nt4 = _as_nt4(x)
    if variant == "mxu":
        words, flags = encode_2bit_nt4_mxu(nt4, checked=True)
    else:
        packed, flags = encode_2bit_nt4_checked(nt4, variant)
        words = packed.view(torch.uint32)
    words = words.view(*x.shape[:-1], x.shape[-1] // 16)
    return words, (flags.view(torch.int32) != 0).view(x.shape[:-1])


def decode_2bit_bytes(words: torch.Tensor, variant: str = "swar") -> torch.Tensor:
    """u32[..., W] -> ASCII u8[..., 16 * W] (full blocks)."""
    if words.dtype != torch.uint32:
        raise TypeError(f"expected uint32 words, got {words.dtype}")
    W = words.shape[-1]
    nt4 = decode_2bit_nt4(_rows(words, W).view(torch.uint8), variant)
    return nt4.view(torch.uint8).view(*words.shape[:-1], 16 * W)


def _flat(t: torch.Tensor) -> torch.Tensor:
    """View t as one flat stream without copying (raises if it cannot)."""
    return t.new_empty(0) if t.numel() == 0 else t.view(-1)


def _b5_bytes(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.uint8:
        raise TypeError(f"expected uint8 bytes, got {x.dtype}")
    if x.shape[-1] % spec.NT_PER_WORD_B5:
        raise ValueError(f"last dim {x.shape[-1]} not a multiple of 27")
    return _flat(x)


def _b5_words(words: torch.Tensor) -> torch.Tensor:
    if words.dtype != torch.uint32:
        raise TypeError(f"expected uint32 words, got {words.dtype}")
    if words.shape[-1] % 2:
        raise ValueError("base-5 packed stream must have even u32 count")
    return _flat(words)


def _flag(flag: torch.Tensor) -> torch.Tensor:
    """u32[1] kernel flag -> bool scalar tensor."""
    return flag.view(torch.int32)[0] != 0


def _b5_encoded(x: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    return words.view(*x.shape[:-1], 2 * (x.shape[-1] // spec.NT_PER_WORD_B5))


def encode_b5_words(x: torch.Tensor) -> torch.Tensor:
    """u8[..., L] (L % 27 == 0) -> packed u32[..., 2 * (L // 27)]."""
    return _b5_encoded(x, encode_b5_stream(_b5_bytes(x)))


def encode_b5_words_checked(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """u8[..., L] -> (u32[..., 2 * (L // 27)], bool scalar: some byte lies
    outside {A,C,G,T,U,N})."""
    words, flag = encode_b5_stream(_b5_bytes(x), checked=True)
    return _b5_encoded(x, words), _flag(flag)


def _b5_decoded(words: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    return out.view(*words.shape[:-1], spec.NT_PER_WORD_B5 * (words.shape[-1] // 2))


def decode_b5_bytes(words: torch.Tensor) -> torch.Tensor:
    """u32[..., 2 * W] -> ASCII u8[..., 27 * W] (full blocks)."""
    return _b5_decoded(words, decode_b5_stream(_b5_words(words)))


def decode_b5_bytes_checked(words: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """u32[..., 2 * W] -> (u8[..., 27 * W], bool scalar: some word is corrupt)."""
    out, flag = decode_b5_stream(_b5_words(words), checked=True)
    return _b5_decoded(words, out), _flag(flag)


def decode_b5_digits(words: torch.Tensor) -> torch.Tensor:
    """u32[..., 2 * W] -> digit bytes u8[..., 27 * W] (0..4 as A, C, T, G, N)."""
    return _b5_decoded(words, decode_b5_stream(_b5_words(words), digits=True))
