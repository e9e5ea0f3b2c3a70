"""MinHash sketching on the packed 2-bit domain (Mash / sourmash style).

Counterpart of ``cute_nucleotides_tpu/ops/sketch.py``, with its names,
arguments, errors and results bit for bit.  Every canonical k-mer is hashed
(fmix32, :mod:`.kmer`) and a small order-statistic summary is kept; Jaccard,
containment and the Mash distance between datasets come from the summaries
alone.  A sketch is a sorted ``u32[s]`` whose empty slots hold
:data:`SENTINEL` (``0xFFFFFFFF``):

* **Bottom-s MinHash** (:func:`bottom_k_sketch`): the ``s`` smallest
  distinct hashes (Mash).
* **FracMinHash** (:func:`frac_sketch`): every distinct hash below
  ``2**32 // scale`` (sourmash), in a buffer of ``cap`` slots, with the
  exact count of them.

Sketches merge associatively (:func:`merge`, the bottom-s of the union).
The whole-stream sketches hash through :func:`.kmer.kmer_hashes_planar`
(kernel #12 for 16 <= k <= 31); the batch forms hash each read of a padded
batch through the same kernels, masking positions past each read's end and
k-mers that touch a flagged byte (``N``).  The reference hashes its batches
with the position-ordered gather instead; the two differ only on a k-mer
whose hash is ``0xFFFFFFFF``, which both drop as they drop padding (the
maximal hash: no bottom-s estimator selects it), so the sketches are the
same.

torch has no unsigned compare or sort on u32, so hashes are ordered as
int32 keys with the sign bit flipped (SENTINEL becomes the int32 maximum
and sorts last).  The bottom-s selection keeps the hashes below a cutoff
that an expected ``8 s`` of them pass, sorts and dedupes those, and falls
back to the whole input when fewer than ``s`` distinct values passed: the
result is defined, so this equals the reference's on every input.
"""

from __future__ import annotations

import math

import torch

from . import kmer, spec

__all__ = [
    "SENTINEL",
    "bottom_k_sketch",
    "bottom_k_sketch_batch",
    "frac_sketch",
    "frac_sketch_batch",
    "merge",
    "merge_many",
    "jaccard",
    "jaccard_matrix",
    "containment",
    "mash_distance",
]

SENTINEL = 0xFFFFFFFF
_SENTINEL_KEY = (1 << 31) - 1  # the key of SENTINEL
_FLIP = -(1 << 31)

#: cutoff of the bottom-s prefilter: an expected ALPHA * s hashes pass it
_ALPHA = 8


def _keys(h: torch.Tensor) -> torch.Tensor:
    """u32 hashes (any shape) -> flat int32 keys in the same order."""
    return h.reshape(-1).view(torch.int32) ^ _FLIP


def _from_keys(keys: torch.Tensor) -> torch.Tensor:
    return (keys ^ _FLIP).view(torch.uint32)


def _key_of(v: int) -> int:
    """The int32 key of a u32 value."""
    return v - (1 << 31)


def _first_s(uniq: torch.Tensor, s: int) -> torch.Tensor:
    """The first s of sorted distinct keys, padded with SENTINEL's key."""
    out = torch.full((s,), _SENTINEL_KEY, dtype=torch.int32, device=uniq.device)
    m = min(s, uniq.numel())
    out[:m] = uniq[:m]
    return out


def _bottom_s_distinct(h: torch.Tensor, s: int) -> torch.Tensor:
    """The s smallest distinct values of h (u32, any shape), sorted and
    padded with SENTINEL: -> u32[s]."""
    keys = _keys(h)
    n = keys.numel()
    c = min(2**32 - 1, max(1, math.ceil(_ALPHA * s * 2**32 / max(n, 1))))
    if c < 2**32 - 1:
        # every value below c passes, so the s smallest distinct values are
        # among the survivors whenever s of those are distinct
        uniq = torch.unique(keys[keys < _key_of(c)])
        if uniq.numel() >= s:
            return _from_keys(_first_s(uniq, s))
    return _from_keys(_first_s(torch.unique(keys), s))


def bottom_k_sketch(words: torch.Tensor, length: int, k: int, s: int, *, canonical: bool = True) -> torch.Tensor:
    """Bottom-``s`` MinHash sketch of one packed stream: -> sorted u32[s].

    The ``s`` smallest distinct canonical k-mer hashes (Mash's sketch);
    fewer than ``s`` distinct k-mers (including ``length < k``) leaves
    SENTINEL padding.  k <= 31.  The hashes are planar
    (:func:`.kmer.kmer_hashes_planar`): a sketch is order-free.
    """
    if length < k:
        return _from_keys(torch.full((s,), _SENTINEL_KEY, dtype=torch.int32, device=words.device))
    h = kmer.kmer_hashes_planar(words, length, k, canonical=canonical)
    return _bottom_s_distinct(h, s)


def _batch_hashes(words: torch.Tensor, lengths, k: int, canonical: bool, invalid=None) -> torch.Tensor:
    """Canonical k-mer hashes of every read of a padded batch u32[B, W],
    flattened (planar order), with positions past each read's end and
    k-mers touching a byte flagged in ``invalid`` (bool[B, L], True = not a
    real base) at SENTINEL.  Windows never span reads: each row hashes as
    its own stream.  A batch whose capacity is below k gives one SENTINEL.
    """
    if words.ndim != 2:
        raise TypeError(f"expected u32[B, W] batch, got {tuple(words.shape)}")
    B, Wr = words.shape
    L = Wr * spec.NT_PER_U32_2BIT
    dev = words.device
    if L < k:
        return _from_keys(torch.full((1,), _SENTINEL_KEY, dtype=torch.int32, device=dev))
    lengths = torch.as_tensor(lengths, dtype=torch.int64, device=dev).reshape(-1).expand(B).clamp(max=L)
    if invalid is not None:
        inv = torch.as_tensor(invalid, device=dev)
        if inv.ndim != 2 or inv.shape[0] != B or inv.shape[1] > L:
            raise ValueError(f"invalid mask shape {tuple(inv.shape)} incompatible with byte capacity {(B, L)}")
    h = kmer.batch_hashes_planar(words, k, canonical)
    # which positions to keep, in position order (read b, nt p), then planar
    keep = torch.arange(L, device=dev)[None, :] < (lengths - (k - 1))[:, None]
    if invalid is not None and inv.shape[1]:
        # k-mer p touches a flagged byte iff the flags in [p, p + k) sum > 0;
        # cs[:, j] counts the flags before byte j (none past the mask's width)
        cs = torch.cumsum(inv, dim=1, dtype=torch.int32)
        cs = torch.cat([cs.new_zeros((B, 1)), cs, cs[:, -1:].expand(B, L - inv.shape[1])], dim=1)
        keep[:, : L - k + 1] &= cs[:, k:] == cs[:, : L - k + 1]
        del cs
    h.masked_fill_(~kmer._to_planar(keep, B * Wr), -1)
    return h.view(torch.uint32).view(-1)


def bottom_k_sketch_batch(
    words: torch.Tensor, lengths, k: int, s: int, *, canonical: bool = True, invalid=None
) -> torch.Tensor:
    """One dataset-level bottom-``s`` sketch of a padded read batch:
    u32[B, W] + lengths -> sorted u32[s], the sketch of the union of every
    read's k-mers (padding tails and rows shorter than k masked; windows
    never span reads).  ``invalid`` (bool[B, L]) drops k-mers touching
    flagged bytes (N etc.); see :func:`_batch_hashes`."""
    return _bottom_s_distinct(_batch_hashes(words, lengths, k, canonical, invalid), s)


def frac_sketch(
    words: torch.Tensor, length: int, k: int, *, scale: int, cap: int, canonical: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """FracMinHash sketch: every distinct hash below ``2**32 // scale`` ->
    (sorted u32[cap], n_kept i32).

    sourmash's scheme: an expected ``1/scale`` of the distinct k-mers is
    kept, so sketches of two datasets sample the same hash region and
    containment is unbiased across dataset sizes.  ``n_kept`` is the exact
    number of distinct kept hashes; past ``cap`` the buffer holds the
    smallest ``cap`` of them.
    """
    if length < k:
        h = _from_keys(torch.full((1,), _SENTINEL_KEY, dtype=torch.int32, device=words.device))
    else:
        h = kmer.kmer_hashes_planar(words, length, k, canonical=canonical)
    return _frac_from_hashes(h, scale, cap)


def frac_sketch_batch(
    words: torch.Tensor, lengths, k: int, *, scale: int, cap: int, canonical: bool = True, invalid=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """FracMinHash sketch of the union of a padded read batch's k-mers:
    u32[B, W] + lengths -> (sorted u32[cap], n_kept i32), with the masking
    rules of :func:`bottom_k_sketch_batch`.  Frac sketches of one ``scale``
    union-merge exactly with :func:`merge`."""
    return _frac_from_hashes(_batch_hashes(words, lengths, k, canonical, invalid), scale, cap)


def _frac_from_hashes(h: torch.Tensor, scale: int, cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    if scale < 1:
        raise ValueError("scale must be >= 1")
    thresh = min(2**32 // scale, 2**32 - 1)
    keys = _keys(h)
    uniq = torch.unique(keys[keys < _key_of(thresh)])  # SENTINEL never passes
    n_kept = torch.tensor(uniq.numel(), dtype=torch.int32, device=h.device)
    return _from_keys(_first_s(uniq, max(cap, 1))[:cap]), n_kept


def merge(sa: torch.Tensor, sb: torch.Tensor) -> torch.Tensor:
    """Union-merge two sketches: -> the bottom-|sa| distinct hashes of ``sa ∪
    sb``.  Associative and commutative."""
    if sa.shape != sb.shape:
        raise ValueError(f"sketch sizes differ: {tuple(sa.shape)} vs {tuple(sb.shape)}")
    return _bottom_s_distinct(torch.cat([sa.view(torch.int32), sb.view(torch.int32)]).view(torch.uint32),
                              sa.shape[0])


def merge_many(stacked: torch.Tensor) -> torch.Tensor:
    """Union-merge D stacked same-size sketches: u32[D, s] -> sorted u32[s],
    the bottom-``s`` distinct hashes of the union."""
    if stacked.ndim < 2:
        raise ValueError(f"expected stacked sketches [D, s], got {tuple(stacked.shape)}")
    return _bottom_s_distinct(stacked, stacked.shape[-1])


def _isin_sorted(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Membership of each u32 of ``x`` in the sorted u32 ``ref``."""
    kx, kr = _keys(x), _keys(ref)
    idx = torch.searchsorted(kr, kx).clamp_(max=kr.numel() - 1)
    return kr[idx] == kx


def _ratio(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """count / max(count, 1) in float32, as the reference's int32 division."""
    return num.sum(dtype=torch.int32).to(torch.float32) / den.sum(dtype=torch.int32).clamp(min=1).to(torch.float32)


def jaccard(sa: torch.Tensor, sb: torch.Tensor) -> torch.Tensor:
    """Jaccard estimate from two same-size sketches: -> f32.  Mash's
    estimator: of the bottom-s sketch of the union, the fraction present in
    both inputs."""
    u = merge(sa, sb)
    valid = u.view(torch.int32) != -1
    inter = _isin_sorted(u, sa) & _isin_sorted(u, sb) & valid
    return _ratio(inter, valid)


def jaccard_matrix(stacked: torch.Tensor) -> torch.Tensor:
    """All-pairs Jaccard estimates of D same-size sketches: u32[D, s] ->
    f32[D, D]; symmetric, 1 on the diagonal of a non-empty sketch, 0 for an
    all-SENTINEL one."""
    if stacked.ndim != 2:
        raise ValueError(f"expected stacked sketches [D, s], got {tuple(stacked.shape)}")
    out = torch.zeros(stacked.shape[:1] * 2, dtype=torch.float32, device=stacked.device)
    for i, sa in enumerate(stacked):
        for j, sb in enumerate(stacked):
            out[i, j] = jaccard(sa, sb)
    return out


def containment(sa: torch.Tensor, sb: torch.Tensor) -> torch.Tensor:
    """Containment estimate C(A in B): -> f32, the fraction of ``sa``'s
    hashes present in ``sb``."""
    va = sa.view(torch.int32) != -1
    inter = _isin_sorted(sa, sb) & va
    return _ratio(inter, va)


def mash_distance(j: float, k: int) -> float:
    """Mash distance (about the per-base mutation rate) from a Jaccard
    estimate: ``-ln(2j / (1 + j)) / k``; 0 -> 1.0 (saturated)."""
    j = float(j)
    if j <= 0.0:
        return 1.0
    return min(-math.log(2.0 * j / (1.0 + j)) / k, 1.0)
