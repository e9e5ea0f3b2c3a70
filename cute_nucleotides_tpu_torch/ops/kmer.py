"""K-mer extraction and counting on the 2-bit packed stream.

Counterpart of ``cute_nucleotides_tpu/ops/kmer.py``, with its names,
argument checks, errors and results bit for bit.  The k-mer at nt ``i`` is
bits ``[2i, 2i + 2k)`` of the packed stream, first nt in the low bits; a
k-mer up to k = 15 is an int32 code, up to k = 31 a u32 pair ``(lo, hi)``.

* Gather tier (:func:`kmer_codes`, :func:`kmer_codes_pair`): codes in
  position order, eager torch on int64 lanes.
* Planar tier: :func:`kmer_codes_planar` and :func:`kmer_codes_planar_pair`
  call the kernels #10 and #11 of :mod:`.kernels`; their output order is
  planar (a fixed permutation of positions, which counting ignores).
* Counting: :func:`kmer_histogram` (k <= 8: planar codes and the histogram
  kernel #13; k 9..12: gather codes and a scatter-add into ``4**k`` bins),
  :func:`kmer_histogram_batch` (a padded read batch, per-read lengths) and
  :func:`kmer_counts` (any k <= 31: planar codes sorted with
  ``torch.sort``, one count per run).
* Hashes (Murmur3 fmix32 of the canonical code): :func:`kmer_hashes` in
  position order (gather tier) and :func:`kmer_hashes_planar` in planar
  order, which runs #10 and the eager fold and mix for k <= 15 and the
  fused kernel #12 for 16 <= k <= 31.
* Minimizers: :func:`minimizers` and :func:`minimizer_bits`; streams of
  1024 words or more with k <= 15 and w - 1 <= 2048 - k take kernel #14,
  the rest the windowed torch form (:func:`_windowed`).

The glue keeps the reference's rows of 512 words, so ``kmer_counts``
returns the reference's padded length ``rows * 8192``.  It never builds a
full-size int64 temporary: codes, masks and per-word limits are int32 or
bool, and positions past the stream's last k-mer are found only in the
last rows, where they lie.  torch's ``>>`` on int32 sign-extends, so the
SWAR reversals mask after each right shift, and unsigned u32 order is
compared with the sign bit flipped.
"""

from __future__ import annotations

import torch

from . import eager, kernels, sort, spec

__all__ = [
    "kmer_codes",
    "kmer_codes_pair",
    "kmer_codes_planar",
    "kmer_codes_planar_pair",
    "revcomp_code",
    "revcomp_code_pair",
    "canonical_codes",
    "canonical_codes_pair",
    "kmer_histogram",
    "kmer_histogram_batch",
    "kmer_counts",
    "kmer_hashes",
    "kmer_hashes_planar",
    "minimizers",
    "minimizer_bits",
]

#: word lanes per panel row (the reference's ``_PLANAR_W``)
PLANAR_W = kernels.PLANAR_W
_NT = spec.NT_PER_U32_2BIT
_INT32_MIN = -(1 << 31)
_INT32_MAX = (1 << 31) - 1
_AA = 0xAAAAAAAA - (1 << 32)  # the complement mask as an int32


def _check_flat(words: torch.Tensor, length: int, k: int, what: str) -> int:
    if words.ndim != 1:
        raise TypeError(f"{what} takes a flat u32 word stream")
    n = length - k + 1
    if n <= 0:
        raise ValueError(f"length {length} too short for k={k}")
    if length > words.shape[0] * _NT:
        raise ValueError("length exceeds stream capacity")
    return n


def _taps(words: torch.Tensor, n: int, ahead: int):
    """For positions 0..n-1: the stream word of each and the ``ahead`` words
    after it (int64 lanes; past the stream they read 0), and the bit shift."""
    w = torch.cat([eager.u32_to_i64(words), words.new_zeros(ahead, dtype=torch.int64)])
    i = torch.arange(n, device=words.device)
    q = i // _NT
    return [w[q + j] for j in range(ahead + 1)], 2 * (i % _NT)


def kmer_codes(words: torch.Tensor, length: int, k: int) -> torch.Tensor:
    """All k-mer codes of a packed u32[W] stream: -> i32[length - k + 1], in
    position order."""
    if not 1 <= k <= 15:
        raise ValueError("k must be in [1, 15]")
    n = _check_flat(words, length, k, "kmer_codes")
    (wl, wh), s = _taps(words, n, 1)
    return (((wl >> s) | (wh << (32 - s))) & ((1 << (2 * k)) - 1)).to(torch.int32)


def kmer_codes_pair(words: torch.Tensor, length: int, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """All k-mer codes for 16 <= k <= 31 as u32 pairs: -> (lo u32[n], hi
    u32[n]), n = length - k + 1; ``lo | hi << 32`` is the 2k-bit code."""
    if not 16 <= k <= 31:
        raise ValueError("kmer_codes_pair covers k in [16, 31]; use kmer_codes below")
    n = _check_flat(words, length, k, "kmer_codes_pair")
    (w0, w1, w2), s = _taps(words, n, 2)
    lo = ((w0 >> s) | (w1 << (32 - s))) & eager.U32  # at s = 0 the second term lies past bit 31
    hi = ((w1 >> s) | (w2 << (32 - s))) & ((1 << (2 * k - 32)) - 1)
    return eager.i64_to_u32(lo), eager.i64_to_u32(hi)


def _as_i32(codes: torch.Tensor) -> torch.Tensor:
    return codes.view(torch.int32) if codes.dtype == torch.uint32 else codes.to(torch.int32)


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical ``x >> s`` (0 < s < 32) of the u32 bits of an int32 tensor."""
    return (x >> s) & ((1 << (32 - s)) - 1)


def _rev32_fields(c: torch.Tensor) -> torch.Tensor:
    """Reverse the sixteen 2-bit fields of each int32 lane (SWAR); at most
    three tensors of c's size live at once."""
    for mask, s in ((0x33333333, 2), (0x0F0F0F0F, 4), (0x00FF00FF, 8)):
        a = c & mask
        a <<= s
        c = c >> s
        c &= mask
        c |= a
    a = c << 16
    c = _shr(c, 16)
    c |= a
    return c


def revcomp_code(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of 2-bit k-mer codes (elementwise, SWAR): -> i32."""
    comp = (0xAAAAAAAA >> (32 - 2 * k)) if k < 16 else _AA
    r = _rev32_fields(_as_i32(codes) ^ comp)
    return _shr(r, 32 - 2 * k) if k < 16 else r


def canonical_codes(codes: torch.Tensor, k: int) -> torch.Tensor:
    """min(code, revcomp(code)), the canonical k-mer form: -> i32."""
    return torch.minimum(_as_i32(codes), revcomp_code(codes, k))


def _revcomp_pair_i32(lo: torch.Tensor, hi: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    rlo = _rev32_fields(_as_i32(hi) ^ _AA)  # low word of the reversed 64-bit value
    rhi = _rev32_fields(_as_i32(lo) ^ _AA)
    s = 64 - 2 * k  # in [2, 32]
    if s == 32:
        return rhi, torch.zeros_like(rhi)
    out_lo = _shr(rlo, s)
    out_lo |= rhi << (32 - s)
    return out_lo, _shr(rhi, s)


def revcomp_code_pair(lo: torch.Tensor, hi: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Reverse complement of u32-pair k-mer codes (16 <= k <= 31): -> (lo,
    hi) u32."""
    if not 16 <= k <= 31:
        raise ValueError("revcomp_code_pair covers k in [16, 31]")
    rlo, rhi = _revcomp_pair_i32(lo, hi, k)
    return rlo.view(torch.uint32), rhi.view(torch.uint32)


def _ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned a < b of the u32 bits of int32 tensors (torch has no unsigned
    compare): flipping the sign bit maps unsigned order onto signed order."""
    return (a ^ _INT32_MIN) < (b ^ _INT32_MIN)


def canonical_codes_pair(lo: torch.Tensor, hi: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Lexicographic min of a pair code and its reverse complement: -> (lo,
    hi) u32."""
    if not 16 <= k <= 31:
        raise ValueError("revcomp_code_pair covers k in [16, 31]")
    rlo, rhi = _revcomp_pair_i32(lo, hi, k)
    lo, hi = _as_i32(lo), _as_i32(hi)
    take = _ult(rhi, hi) | ((rhi == hi) & _ult(rlo, lo))
    return torch.where(take, rlo, lo).view(torch.uint32), torch.where(take, rhi, hi).view(torch.uint32)


# --- planar tier -------------------------------------------------------------------

def _check_panels(words: torch.Tensor, *succ: torch.Tensor) -> None:
    if any(t.shape != words.shape for t in succ) or words.ndim != 2 or words.shape[1] % 128:
        raise TypeError(f"expected matching u32[R, 128m] panels, got {tuple(words.shape)}")


def kmer_codes_planar(words: torch.Tensor, nxt: torch.Tensor, k: int) -> torch.Tensor:
    """Funnel-shift k-mer extraction: u32[R, W] panels -> i32[R, 16 W].

    ``nxt[r, w]`` is the word after ``words[r, w]`` in stream order.  Output
    is PLANAR: the code starting at nt ``16 w + s`` of row r lands at column
    ``W s + w`` (use :func:`kmer_codes` when order matters).  Kernel #10.
    """
    _check_panels(words, nxt)
    return kernels.kmer_codes_planar(words, nxt, k)


def kmer_codes_planar_pair(
    words: torch.Tensor, nxt: torch.Tensor, nxt2: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Funnel-shift extraction for 16 <= k <= 31: u32[R, W] panels -> (lo
    u32[R, 16 W], hi u32[R, 16 W]), planar like :func:`kmer_codes_planar`.
    Kernel #11."""
    if not 16 <= k <= 31:
        raise ValueError("kmer_codes_planar_pair covers k in [16, 31]")
    _check_panels(words, nxt, nxt2)
    return kernels.kmer_codes_planar_pair(words, nxt, nxt2, k)


def _panels(words: torch.Tensor, ahead: int) -> list[torch.Tensor]:
    """A stream (any shape, u32) as rows of PLANAR_W words, zero-padded, and
    its ``ahead`` successor streams (each word's next, and the one after),
    all u32[rows, PLANAR_W] on the words' device, 16-byte aligned."""
    flat = words.reshape(-1).view(torch.int32)
    rows = spec.cdiv(flat.numel(), PLANAR_W)
    n = rows * PLANAR_W
    ext = torch.zeros(n + ahead, dtype=torch.int32, device=words.device)
    ext[: flat.numel()] = flat
    out = [ext[:n]] + [ext[j : n + j].clone() for j in range(1, ahead + 1)]
    return [t.view(rows, PLANAR_W).view(torch.uint32) for t in out]


def _row_panels(words: torch.Tensor) -> list[torch.Tensor]:
    """A batch u32[B, Wr] as rows of PLANAR_W words and its successor words,
    u32[rows, PLANAR_W] each: the successor of a row's last word is 0, so no
    k-mer spans two reads (each row reads as its own stream)."""
    B, Wr = words.shape
    rows = spec.cdiv(B * Wr, PLANAR_W)
    flat = torch.zeros(rows * PLANAR_W, dtype=torch.int32, device=words.device)
    nxt = torch.zeros_like(flat)
    w32 = words.view(torch.int32)
    flat[: B * Wr].view(B, Wr).copy_(w32)
    nxt[: B * Wr].view(B, Wr)[:, :-1] = w32[:, 1:]
    return [t.view(rows, PLANAR_W).view(torch.uint32) for t in (flat, nxt)]


def _mask_tail(codes: torch.Tensor, n_valid: int, fill: int) -> None:
    """Set the planar codes i32[rows, 16 W] of positions >= n_valid to
    ``fill``, in place.  Position ``16 (r W + w) + s`` lies at [r, W s + w],
    so those are shifts >= s of word w in row r (n_valid = 16 (r W + w) +
    s), every later word of that row, and every later row."""
    rows, W = codes.shape[0], codes.shape[1] // _NT
    q, s = divmod(n_valid, _NT)
    r, w = divmod(q, W)
    if r >= rows:
        return
    c3 = codes.view(rows, _NT, W)
    c3[r, s:, w] = fill
    c3[r, :, w + 1 :] = fill
    c3[r + 1 :] = fill


def _kmer_histogram_planar(words: torch.Tensor, length: int, k: int, canonical: bool) -> torch.Tensor:
    """k <= 8: planar codes (#10), positions past the last k-mer masked to
    code 0, the histogram (#13), and bin 0 corrected."""
    if not 1 <= k <= 8:
        raise ValueError("MXU histogram covers k in [1, 8]")
    n_valid = length - k + 1
    if n_valid <= 0:
        raise ValueError(f"length {length} too short for k={k}")
    if length > words.numel() * _NT:
        raise ValueError("length exceeds stream capacity")
    codes = kernels.kmer_codes_planar(*_panels(words, 1), k)
    if canonical:
        codes = canonical_codes(codes, k)
    _mask_tail(codes, n_valid, 0)
    counts = kernels.hist_codes(codes).view(-1)[: 4**k]
    counts[0] -= codes.numel() - n_valid
    return counts


def _kmer_histogram_scatter(words: torch.Tensor, length: int, k: int, *, canonical: bool = False) -> torch.Tensor:
    codes = kmer_codes(words, length, k)
    if canonical:
        codes = canonical_codes(codes, k)
    return kernels.count_codes_plain(codes, 4**k)


def kmer_histogram(words: torch.Tensor, length: int, k: int, *, canonical: bool = False) -> torch.Tensor:
    """Count every k-mer of a packed stream: -> i32[4**k].

    ``canonical=True`` folds each k-mer with its reverse complement first.
    k <= 8 runs the planar kernels (#10, then the histogram #13); k in
    [9, 12] the gather codes and a scatter-add into the dense bins.  Past
    that a dense histogram is impossible (17 TB at k = 21): use
    :func:`kmer_counts`.
    """
    if k <= 8:
        return _kmer_histogram_planar(words, length, k, canonical)
    if k > 12:
        raise ValueError(
            f"dense 4**{k} histogram would need {4 * 4**k / 2**30:.0f} GiB; "
            "use kmer_counts (sorted-segment counts) for k in [13, 31]"
        )
    return _kmer_histogram_scatter(words, length, k, canonical=canonical)


def kmer_histogram_batch(words: torch.Tensor, lengths, k: int, *, canonical: bool = False) -> torch.Tensor:
    """Summed per-read k-mer spectrum of a padded batch: u32[B, W] + lengths
    (scalar or per read) -> i32[4**k].

    Each row is a read: its successor words are zeroed at the row end, so
    no k-mer spans two reads, and ``lengths`` masks the padding tail and
    rows shorter than k.  One planar pass (#10) and one histogram (#13) for
    k <= 8; k in [9, 12] scatter-adds into the dense bins.  The mask is a
    per-word count of valid shifts (int32) and one bool per code.
    """
    if not 1 <= k <= 12:
        raise ValueError(
            "kmer_histogram_batch covers k in [1, 12] (dense bins); use "
            "kmer_counts per read for larger k"
        )
    if words.ndim != 2:
        raise TypeError(f"expected u32[B, W] batch, got {tuple(words.shape)}")
    B, Wr = words.shape
    dev = words.device
    lengths = torch.as_tensor(lengths, dtype=torch.int64, device=dev).reshape(-1).expand(B)
    lengths = lengths.clamp(max=Wr * _NT)
    rows = spec.cdiv(B * Wr, PLANAR_W)
    codes = kernels.kmer_codes_planar(*_row_panels(words), k)
    if canonical:
        codes = canonical_codes(codes, k)
    # word q = b Wr + j of the batch holds positions 16 j + s of read b; its
    # valid shifts are s < clamp(lim_b - 16 j, 0, 16), lim_b = length - k + 1
    lim = (lengths - (k - 1)).to(torch.int32)
    valid = torch.zeros(rows * PLANAR_W, dtype=torch.int32, device=dev)
    j16 = _NT * torch.arange(Wr, dtype=torch.int32, device=dev)
    valid[: B * Wr].view(B, Wr).copy_((lim[:, None] - j16).clamp_(0, _NT))
    shifts = torch.arange(_NT, dtype=torch.int32, device=dev).view(1, _NT, 1)
    codes.view(rows, _NT, PLANAR_W).masked_fill_(shifts >= valid.view(rows, 1, PLANAR_W), 0)
    del valid
    if k <= 8:
        counts = kernels.hist_codes(codes).view(-1)[: 4**k]
    else:
        counts = kernels.count_codes_plain(codes, 4**k)
    # masked positions all landed in bin 0; remove them
    n_valid = (lengths - (k - 1)).clamp(min=0).sum()
    counts[0] += (n_valid - codes.numel()).to(torch.int32)
    return counts


def _run_counts(is_new: torch.Tensor, sent: torch.Tensor) -> torch.Tensor:
    """i32[n]: at each run start (``is_new`` bool[n - 1] marks the starts
    after entry 0) the run's length, 0 elsewhere and on the sentinel run:
    what the reference computes with a reverse cumulative min."""
    n = sent.numel()
    starts = torch.cat([torch.zeros(1, dtype=torch.int64, device=sent.device),
                        torch.nonzero(is_new).flatten() + 1])
    counts = torch.zeros(n, dtype=torch.int32, device=sent.device)
    counts[starts] = torch.diff(starts, append=starts.new_full((1,), n)).to(torch.int32)
    return counts.masked_fill_(sent, 0)


def kmer_counts(
    words: torch.Tensor, length: int, k: int, *, canonical: bool = False
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sorted-segment k-mer counting for any k <= 31: -> (lo u32[n], hi
    u32[n], counts i32[n]), n = the padded position count (rows * 8192).

    Planar codes (#10, or #11 for k >= 16) are sorted; entry i is a distinct
    k-mer iff ``counts[i] > 0`` (run starts), and positions past the last
    k-mer sort last as the sentinel ``0xFFFFFFFF`` (both planes for k >= 16;
    ``hi`` is 0 for k <= 15) with count 0.  ``counts.sum() == length - k +
    1``.  ``canonical=True`` folds each k-mer with its reverse complement
    first.
    """
    if not 1 <= k <= 31:
        raise ValueError("k must be in [1, 31]")
    n_valid = length - k + 1
    if n_valid <= 0:
        raise ValueError(f"length {length} too short for k={k}")
    if length > words.numel() * _NT:
        raise ValueError("length exceeds stream capacity")
    if k <= 15:
        codes = kernels.kmer_codes_planar(*_panels(words, 1), k)
        if canonical:
            codes = canonical_codes(codes, k)
        _mask_tail(codes, n_valid, _INT32_MAX)  # real codes < 2**30: the sentinel sorts last
        vals = torch.sort(codes.view(-1)).values
        del codes
        sent = vals == _INT32_MAX
        is_new = vals[1:] != vals[:-1]
        lo_s = vals.masked_fill_(sent, -1).view(torch.uint32)
        hi_s = torch.zeros_like(vals).view(torch.uint32)
    else:
        lo, hi = kernels.kmer_codes_planar_pair(*_panels(words, 2), k)
        if canonical:
            lo, hi = canonical_codes_pair(lo, hi, k)
        for plane in (lo, hi):
            _mask_tail(plane.view(torch.int32), n_valid, -1)
        hi_s, lo_s = sort.sort_pairs(hi, lo)
        del lo, hi
        h, l = hi_s.view(torch.int32), lo_s.view(torch.int32)
        sent = h == -1  # a real hi has at most 30 bits
        is_new = (l[1:] != l[:-1]) | (h[1:] != h[:-1])
    return lo_s, hi_s, _run_counts(is_new, sent)


# --- hashes ------------------------------------------------------------------------
# Murmur3 fmix32, the invertible avalanche the reference applies to the
# canonical code (minimap2's sketch idea), so that a read and its reverse
# complement select the same hashes.

_SENTINEL = -1  # 0xFFFFFFFF as an int32: invalid positions of the planar hashes
_MIX_STEP = 1 << 24  # elements per int64 chunk of _mix32


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2**32 of int64 lanes in [0, 2**32): two 16-bit halves of c,
    so that no product leaves int64."""
    return (h * (c & 0xFFFF) + (((h * (c >> 16)) & 0xFFFF) << 16)) & eager.U32


def _mix64(h: torch.Tensor) -> torch.Tensor:
    """fmix32 of int64 lanes holding u32 values."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """Murmur3 fmix32 of the u32 bits of an int32 (or uint32) tensor -> int32,
    on int64 chunks of ``_MIX_STEP`` lanes (no full-size int64 temporary)."""
    x = _as_i32(h).contiguous()
    flat = x.view(-1)
    out = torch.empty_like(flat)
    for i in range(0, flat.numel(), _MIX_STEP):
        out[i : i + _MIX_STEP] = _mix64(eager.u32_to_i64(flat[i : i + _MIX_STEP].view(torch.uint32))).to(torch.int32)
    return out.view(x.shape)


def kmer_hashes(words: torch.Tensor, length: int, k: int, *, canonical: bool = True) -> torch.Tensor:
    """Position-ordered avalanche hashes of every k-mer: -> u32[length-k+1].

    k <= 15 hashes the code; 16 <= k <= 31 mixes the u32 pair (``mix(lo ^
    mix(hi))``).  ``canonical=True`` folds each k-mer with its reverse
    complement first.  Gather tier (eager torch).
    """
    if k <= 15:
        codes = kmer_codes(words, length, k)
        if canonical:
            codes = canonical_codes(codes, k)
        return _mix32(codes).view(torch.uint32)
    lo, hi = kmer_codes_pair(words, length, k)
    if canonical:
        lo, hi = canonical_codes_pair(lo, hi, k)
    return _mix32(_as_i32(lo) ^ _mix32(hi)).view(torch.uint32)


def kmer_hashes_planar(words: torch.Tensor, length: int, k: int, *, canonical: bool = True) -> torch.Tensor:
    """Planar-order canonical k-mer hashes of a packed stream: -> u32[16 *
    ceil(W / 512) * 512], any k <= 31.

    The multiset of :func:`kmer_hashes` in the planar layout of rows of 512
    words (column ``512 s + w`` of row r holds position ``16 (512 r + w) +
    s``), with positions past ``length - k`` and the padding of the last row
    at ``0xFFFFFFFF`` (the sketch SENTINEL).  As in the reference, the one
    k-mer code per orientation whose hash is 0xFFFFFFFF is indistinguishable
    from padding here; every sketch drops it.  k <= 15 runs kernel #10 and
    the eager fold and mix; 16 <= k <= 31 the fused kernel #12.
    """
    if not 1 <= k <= 31:
        raise ValueError("k must be in [1, 31]")
    n_valid = length - k + 1
    if n_valid <= 0:
        raise ValueError(f"length {length} too short for k={k}")
    if length > words.numel() * _NT:
        raise ValueError("length exceeds stream capacity")
    return batch_hashes_planar(words.reshape(1, -1), k, canonical, n_valid).view(torch.uint32).view(-1)


def _to_planar(keep: torch.Tensor, n_words: int) -> torch.Tensor:
    """bool[16 n_words] in position order (position 16 i + s of word i) ->
    bool[rows, 16 PLANAR_W] in the planar order of rows of PLANAR_W words,
    False in the padding of the last row."""
    rows = spec.cdiv(n_words, PLANAR_W)
    full = torch.zeros(rows * PLANAR_W * _NT, dtype=torch.bool, device=keep.device)
    full[: keep.numel()] = keep.reshape(-1)
    return full.view(rows, PLANAR_W, _NT).transpose(1, 2).reshape(rows, _NT * PLANAR_W)


def batch_hashes_planar(words: torch.Tensor, k: int, canonical: bool, n_valid: int | None = None) -> torch.Tensor:
    """Planar hashes i32[rows, 16 PLANAR_W] (u32 bits) of every position of a
    batch u32[B, Wr] read as B streams: the successor words of a row are its
    own, zero past its end.  Positions >= ``n_valid`` (in the flat order of
    the batch) are 0xFFFFFFFF; None masks none.  Kernel #12 for 16 <= k <=
    31, #10 and the eager fold and mix for k <= 15."""
    B, Wr = words.shape
    if k > 31:
        raise ValueError("kmer_codes_pair covers k in [16, 31]; use kmer_codes below")
    if k >= 16:
        n = B * Wr * _NT if n_valid is None else n_valid
        h = kernels.kmer_hashes_planar_pair(words.reshape(-1), k, n, canonical=canonical, seg=Wr)
        return h.view(torch.int32)
    if not 1 <= k <= 15:
        raise ValueError("k must be in [1, 15]")
    codes = kernels.kmer_codes_planar(*_row_panels(words), k)
    if canonical:
        codes = canonical_codes(codes, k)
    h = _mix32(codes)
    del codes
    if n_valid is not None:
        _mask_tail(h, n_valid, _SENTINEL)
    return h


# --- minimizers --------------------------------------------------------------------
# Of each window of w consecutive k-mers keep those with the smallest hash
# (minimap2's sketch).  Hashes are compared as int32 keys with the sign bit
# flipped, which orders them as u32.

#: the kernel route takes w - 1 <= 16 * MZ_OV - k
MZ_OV = kernels.MZ_OV

#: words below which the reference keeps the windowed passes (one kernel row)
_MZ_THRESHOLD = 1024


def _key(h: torch.Tensor) -> torch.Tensor:
    """u32 hashes -> int32 keys in the same order (sign bit flipped)."""
    return _as_i32(h) ^ _INT32_MIN


def _shifted(a: torch.Tensor, s: int, left: bool, pad: int) -> torch.Tensor:
    """Shifted copy of a 1-D tensor: index ``i`` reads ``a[i - s]``
    (``left``) or ``a[i + s]``, with ``pad`` outside."""
    if s >= a.shape[0]:
        return torch.full_like(a, pad)
    p = a.new_full((s,), pad)
    return torch.cat([p, a[:-s]]) if left else torch.cat([a[s:], p])


def _windowed(a: torch.Tensor, r: int, op, pad: int, left: bool) -> torch.Tensor:
    """``op`` (torch.minimum / maximum) over the window of ``r + 1`` elements
    ending (``left``) or starting at each index: a log-depth doubling tree,
    the clipped edges padded with the identity ``pad``."""
    if r == 0:
        return a
    t, m = a, 1
    while 2 * m - 1 <= r:
        t = op(t, _shifted(t, m, left, pad))
        m *= 2
    off = r - (m - 1)
    if off:  # overlap-combine covers the non-power-of-two remainder
        t = op(t, _shifted(t, off, left, pad))
    return t


def _windowed_mask(h: torch.Tensor, w: int) -> torch.Tensor:
    """bool[n]: position p holds the least hash of some window of w hashes
    among the windows starting in [0, n - w] (the reference's two passes:
    the forward windowed min, window starts past n - w zeroed, then the
    backward windowed max)."""
    key, n, r = _key(h), h.numel(), w - 1
    wm = _windowed(key, r, torch.minimum, _INT32_MAX, left=False)
    wm.masked_fill_(torch.arange(n, device=h.device) > n - w, _INT32_MIN)  # the key of u32 0
    best = _windowed(wm, r, torch.maximum, _INT32_MIN, left=True)
    return key == best


def _route_minimizer_kernel(n_words: int, n: int, k: int, w: int) -> bool:
    return n_words >= _MZ_THRESHOLD and 1 <= k <= 15 and 1 <= w - 1 <= 16 * MZ_OV - k and n > w


#: the reference's name for the kernel route of :func:`minimizer_bits`
_minimizer_bits_impl = kernels.minimizer_bits_stream


def _unpack_bits(bits: torch.Tensor, n: int) -> torch.Tensor:
    """bool[n] of packed bits u32[ceil(n/16)] (bit p % 16 of word p // 16)."""
    shifts = torch.arange(_NT, dtype=torch.int32, device=bits.device)
    return ((bits.view(torch.int32)[:, None] >> shifts) & 1).view(-1)[:n].bool()


def minimizers(
    words: torch.Tensor, length: int, k: int, w: int, *, canonical: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """(w, k)-minimizer mask over a packed stream: -> (mask bool[n], hash
    u32[n]), n = length - k + 1.

    Position p is a minimizer iff its k-mer attains the least hash of at
    least one window of w consecutive k-mers containing it; ties select
    every tied position.  A stream with n <= w is one window (``h ==
    min(h)``).  Kernel #14 computes the mask where the reference routes to
    its kernel (:func:`_route_minimizer_kernel`); the hashes come from
    :func:`kmer_hashes`.
    """
    if w < 1:
        raise ValueError("window w must be >= 1")
    h = kmer_hashes(words, length, k, canonical=canonical)
    n = h.numel()
    if n <= w:
        key = _key(h)
        return key == key.min(), h
    if _route_minimizer_kernel(words.numel(), n, k, w):
        return _unpack_bits(kernels.minimizer_bits_stream(words.reshape(-1), n, k, w, canonical=canonical), n), h
    return _windowed_mask(h, w), h


def minimizer_bits(
    words: torch.Tensor, length: int, k: int, w: int, *, canonical: bool = True
) -> torch.Tensor:
    """Packed (w, k)-minimizer mask: -> u32[ceil(n/16)], n = length - k + 1;
    bit ``p % 16`` of word ``p // 16`` flags position p, as
    :func:`minimizers` selects it.  Kernel #14 where the reference routes to
    its kernel, else the packed mask of :func:`minimizers`."""
    if w < 1:
        raise ValueError("window w must be >= 1")
    n = length - k + 1
    if n <= 0:
        raise ValueError(f"length {length} too short for k={k}")
    flat = words.reshape(-1)
    if _route_minimizer_kernel(flat.numel(), n, k, w):
        return kernels.minimizer_bits_stream(flat, n, k, w, canonical=canonical)
    mask, _ = minimizers(flat, length, k, w, canonical=canonical)
    return pack_bits(mask)


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """bool[n] -> u32[ceil(n/16)]: bit p % 16 of word p // 16 is mask[p]."""
    n = mask.numel()
    full = torch.zeros(spec.cdiv(n, _NT) * _NT, dtype=torch.int32, device=mask.device)
    full[:n] = mask.reshape(-1)
    weights = torch.ones(_NT, dtype=torch.int32, device=mask.device) << torch.arange(
        _NT, dtype=torch.int32, device=mask.device)
    return (full.view(-1, _NT) * weights).sum(1, dtype=torch.int32).view(torch.uint32)
