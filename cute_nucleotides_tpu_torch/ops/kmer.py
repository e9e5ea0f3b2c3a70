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
]

#: word lanes per panel row (the reference's ``_PLANAR_W``)
PLANAR_W = 512
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
    flat = torch.zeros(rows * PLANAR_W, dtype=torch.int32, device=dev)
    nxt = torch.zeros_like(flat)
    w32 = words.view(torch.int32)
    flat[: B * Wr].view(B, Wr).copy_(w32)
    nxt[: B * Wr].view(B, Wr)[:, :-1] = w32[:, 1:]
    codes = kernels.kmer_codes_planar(flat.view(rows, PLANAR_W).view(torch.uint32),
                                      nxt.view(rows, PLANAR_W).view(torch.uint32), k)
    del flat, nxt
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
