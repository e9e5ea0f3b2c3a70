"""Exact pattern search on packed streams, both codecs, without decoding.

Counterpart of ``cute_nucleotides_tpu/ops/search.py``, with its names,
errors and routing:

* query compilers: :func:`compile_query` (2-bit; ``N`` is a wildcard),
  :func:`compile_query_b5` (base-5; ``N`` is a literal, ``?`` the wildcard)
  and :func:`revcomp_query`; plain numpy, as in the reference;
* the mask tier (plain torch on the words' device): :func:`match_mask`,
  :func:`match_mask_b5`, the batch forms and :func:`match_counts_batch`;
* the kernel tier: :func:`match_bits` and :func:`match_bits_b5` call the
  search kernels of :mod:`.kernels`, and :func:`match_count`,
  :func:`match_positions` and their ``_b5`` twins reduce the bits.  Every
  2-bit ``match_bits`` call goes through the kernel tier; a base-5 count or
  positions call does when the flat stream has at least 1024 u32 and the
  query at most 1024 nt, and takes the mask tier otherwise.

The kernel tier returns flat bits: word ``w`` of the result holds the
matches that start in stream word ``w`` (bit ``s`` is nt ``16 w + s`` for
2-bit, ``27 w + s`` for base-5), which is the reference's row-major
``bits.reshape(-1)[:W]``.  Matching is over the normalized sequence
(upper-case, ``U`` as ``T``).  Every formula computes on int64 lanes: the
card's torch has no ``>>`` or ``&`` on uint32.
"""

from __future__ import annotations

import numpy as np
import torch

from . import eager, kernels, spec

__all__ = [
    "compile_query",
    "revcomp_query",
    "match_mask",
    "match_bits",
    "match_count",
    "match_positions",
    "match_mask_batch",
    "match_counts_batch",
    "compile_query_b5",
    "match_mask_b5",
    "match_bits_b5",
    "match_count_b5",
    "match_positions_b5",
    "match_mask_b5_batch",
]

#: query bytes allowed (N/n are wildcards; everything else must be ACGTU)
_QUERY_OK = frozenset(b"ACGTUacgtuNn")
_QUERY_B5_OK = frozenset(b"ACGTUNacgtun?")

#: route flat base-5 streams at or above this many u32 words to the kernel
_B5_SEARCH_THRESHOLD = 1024

#: longest base-5 query (nt) the kernel tier takes; the mask tier takes any
_B5_SEARCH_MAX_QUERY = 1024


# --- query compilers (numpy) ----------------------------------------------------

def compile_query(query: bytes) -> tuple[np.ndarray, np.ndarray, int]:
    """Pack an ASCII query into ``(q u32[Wq], care u32[Wq], m)``: ``q``
    holds the 2-bit codes LSB-first, ``care`` 0b11 per concrete field and
    0b00 per ``N`` wildcard.  Raises on bytes outside {A,C,G,T,U,N}."""
    if isinstance(query, str):
        query = query.encode()
    m = len(query)
    if m == 0:
        raise ValueError("empty query")
    bad = set(query) - _QUERY_OK
    if bad:
        raise ValueError(f"query contains non-ACGTUN bytes: {sorted(chr(b) for b in bad)}")
    wq = -(-m // spec.NT_PER_U32_2BIT)
    q = np.zeros(wq, np.uint32)
    care = np.zeros(wq, np.uint32)
    for i, b in enumerate(query):
        w, f = divmod(i, spec.NT_PER_U32_2BIT)
        if b not in b"Nn":
            q[w] |= ((b >> 1) & 3) << (2 * f)
            care[w] |= 3 << (2 * f)
    return q, care, m


def revcomp_query(query: bytes) -> bytes:
    """Reverse complement of an ASCII query (``N`` stays ``N``)."""
    if isinstance(query, str):
        query = query.encode()
    return query.upper().replace(b"U", b"T")[::-1].translate(bytes.maketrans(b"ACGTN", b"TGCAN"))


def compile_query_b5(query: bytes) -> tuple[tuple[np.ndarray, np.ndarray], ...]:
    """Pack an ASCII base-5 query into three phase tables ``(q8 u32[T],
    care8 u32[T])`` (phase = start position mod 3): ``q8[j]`` holds the
    query digits over stream triplet ``j`` in base-8 slots, ``care8`` 0b111
    per concrete slot and 0 for ``?`` and for slots outside the query.
    Raises on bytes outside {A,C,G,T,U,N,?}."""
    if isinstance(query, str):
        query = query.encode()
    m = len(query)
    if m == 0:
        raise ValueError("empty query")
    bad = set(query) - _QUERY_B5_OK
    if bad:
        raise ValueError(f"query contains non-ACGTUN? bytes: {sorted(chr(b) for b in bad)}")
    digits = [None if b == ord("?") else int(spec.DIGIT_LUT8[b & 7]) for b in query]
    out = []
    for phase in range(3):
        T = -(-(phase + m) // 3)
        q8 = np.zeros(T, np.uint32)
        care8 = np.zeros(T, np.uint32)
        for i, d in enumerate(digits):
            if d is None:
                continue
            j, slot = divmod(phase + i, 3)
            q8[j] |= d << (3 * slot)
            care8[j] |= 7 << (3 * slot)
        out.append((q8, care8))
    return tuple(out)


def _qc_host(query: bytes) -> tuple:
    """:func:`compile_query_b5` as tuples of ints."""
    return tuple((tuple(int(v) for v in q8), tuple(int(v) for v in c8))
                 for q8, c8 in compile_query_b5(query))


# --- mask tier: 2-bit -------------------------------------------------------------

def _check_words(words: torch.Tensor) -> None:
    if words.dtype != torch.uint32:
        raise TypeError(f"expected uint32 words, got {words.dtype}")


def _match_mask_impl(words: torch.Tensor, q: np.ndarray, care: np.ndarray, n: int) -> torch.Tensor:
    """u32[..., W] -> bool[..., n]: the two-tap funnel window at every start,
    gathered per query word (words past W read as 0)."""
    x = eager.u32_to_i64(words)
    x = torch.cat([x, x.new_zeros(*x.shape[:-1], q.size + 1)], -1)
    i = torch.arange(n, device=words.device, dtype=torch.int64)
    wl = i // spec.NT_PER_U32_2BIT
    s = 2 * (i % spec.NT_PER_U32_2BIT)
    diff = torch.zeros((*x.shape[:-1], n), dtype=torch.int64, device=words.device)
    for k in range(q.size):
        if care[k]:
            win = ((x[..., wl + k] >> s) | (x[..., wl + k + 1] << (32 - s))) & eager.U32
            diff |= (win ^ int(q[k])) & int(care[k])
    return diff == 0


def match_mask(words: torch.Tensor, length: int, query: bytes) -> torch.Tensor:
    """Occurrence mask of ``query`` in a packed u32[W] stream: bool[length -
    m + 1], entry ``i`` true iff the query matches at nt ``i``."""
    if words.ndim != 1:
        raise TypeError("match_mask takes a flat u32 word stream")
    _check_words(words)
    q, care, m = compile_query(query)
    if length - m + 1 <= 0:
        raise ValueError(f"stream length {length} shorter than query ({m})")
    if length > words.shape[0] * spec.NT_PER_U32_2BIT:
        raise ValueError("length exceeds stream capacity")
    return _match_mask_impl(words, q, care, length - m + 1)


# --- kernel tier: 2-bit -----------------------------------------------------------

def _popcount(v: torch.Tensor) -> torch.Tensor:
    """Set bits of each u32 value held on int64 lanes."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24) & 0xFF


def _count_bits(bits: torch.Tensor) -> torch.Tensor:
    return _popcount(eager.u32_to_i64(bits)).sum().to(torch.int32)


def _bit_positions(bits: torch.Tensor, per_word: int) -> np.ndarray:
    """Positions ``per_word * w + s`` of the set bits, sorted (host int64)."""
    lanes = bits.view(torch.int32)
    idx = torch.nonzero(lanes).flatten()
    s = torch.arange(per_word, device=bits.device, dtype=torch.int64)
    v = lanes[idx].to(torch.int64) & eager.U32
    hit = ((v[:, None] >> s) & 1) != 0
    return (idx[:, None] * per_word + s)[hit].cpu().numpy().astype(np.int64)


def match_bits(words: torch.Tensor, length: int, query: bytes) -> torch.Tensor:
    """Packed occurrence bits of ``query``: u32[W], bit ``s`` of word ``w``
    flags a match at nt ``16 w + s`` (the search kernel)."""
    if words.ndim != 1:
        raise TypeError("match_bits takes a flat u32 word stream")
    q, care, m = compile_query(query)
    if length - m + 1 <= 0:
        raise ValueError(f"stream length {length} shorter than query ({m})")
    if length > words.shape[0] * spec.NT_PER_U32_2BIT:
        raise ValueError("length exceeds stream capacity")
    return kernels.match_bits_stream(words, q, care, length - m + 1)


def match_count(words: torch.Tensor, length: int, query: bytes) -> torch.Tensor:
    """Number of occurrences of ``query`` (int32 scalar, on the words' device)."""
    return _count_bits(match_bits(words, length, query))


def match_positions(words: torch.Tensor, length: int, query: bytes) -> np.ndarray:
    """Sorted occurrence positions (host int64) -- the ``grep`` output form."""
    return _bit_positions(match_bits(words, length, query), spec.NT_PER_U32_2BIT)


# --- batches ------------------------------------------------------------------------

def _ragged_mask(mask: torch.Tensor, lengths: torch.Tensor, m: int) -> torch.Tensor:
    i = torch.arange(mask.shape[1], device=mask.device, dtype=torch.int64)
    return mask & (i < (lengths - (m - 1))[:, None])


def _norm_lengths(lengths, B: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(lengths, dtype=torch.int64, device=device).reshape(-1).broadcast_to((B,))


def match_mask_batch(words: torch.Tensor, lengths, query: bytes) -> torch.Tensor:
    """Occurrence mask of ``query`` in each row of a packed 2-bit batch:
    u32[B, W] + lengths -> bool[B, 16 W - m + 1] (false past ``lengths[b] -
    m``)."""
    if words.ndim != 2:
        raise TypeError("match_mask_batch takes a packed u32[B, W] batch")
    _check_words(words)
    q, care, m = compile_query(query)
    cap = words.shape[1] * spec.NT_PER_U32_2BIT
    if cap - m + 1 <= 0:
        raise ValueError(f"row capacity shorter than query ({m})")
    mask = _match_mask_impl(words, q, care, cap - m + 1)
    return _ragged_mask(mask, _norm_lengths(lengths, words.shape[0], words.device), m)


def match_mask_b5_batch(words: torch.Tensor, lengths, query: bytes) -> torch.Tensor:
    """Batched :func:`match_mask_b5`: interleaved u32[B, 2 Wb] + lengths ->
    bool[B, 27 Wb - m + 1] (``N`` literal, ``?`` wildcard)."""
    if words.ndim != 2 or words.shape[1] % 2:
        raise TypeError("match_mask_b5_batch takes an interleaved u32[B, 2W] batch")
    _check_words(words)
    m = len(query)
    cap = (words.shape[1] // 2) * spec.NT_PER_WORD_B5
    if cap - m + 1 <= 0:
        raise ValueError(f"row capacity shorter than query ({m})")
    mask = _match_mask_b5_impl(words, _qc_host(query), cap - m + 1)
    return _ragged_mask(mask, _norm_lengths(lengths, words.shape[0], words.device), m)


def match_counts_batch(words: torch.Tensor, lengths, query: bytes, *, codec: str = "2bit") -> torch.Tensor:
    """Per-read occurrence counts: int32[B], on the words' device."""
    fn = match_mask_batch if codec == "2bit" else match_mask_b5_batch
    return fn(words, lengths, query).sum(1).to(torch.int32)


# --- mask tier: base-5 ------------------------------------------------------------------

def _b5_triplets_b8(words: torch.Tensor) -> torch.Tensor:
    """Interleaved base-5 u32[..., 2W] -> base-8 digit slots int64[..., 9W]
    (``a | b << 3 | c << 6`` per triplet, stream order)."""
    lead, W = words.shape[:-1], words.shape[-1] // 2
    pair = eager.u32_to_i64(words).reshape(*lead, W, 2)
    t = eager.b5_word_triplets(pair[..., 0], pair[..., 1])
    return eager.b5_b8_slots(t).reshape(*lead, spec.TRIPLETS_PER_WORD * W)


def _match_mask_b5_impl(words: torch.Tensor, qc: tuple, n: int) -> torch.Tensor:
    """u32[..., 2W] -> bool[..., n]: three phase folds over the triplet
    stream, interleaved (stream triplets past the words read as 0)."""
    t8 = _b5_triplets_b8(words)
    U = -(-n // 3)  # starts per phase
    pad = U + max(len(q8) for q8, _ in qc) - t8.shape[-1]
    if pad > 0:
        t8 = torch.cat([t8, t8.new_zeros(*t8.shape[:-1], pad)], -1)
    phase_masks = []
    for q8, care8 in qc:
        diff = torch.zeros((*t8.shape[:-1], U), dtype=torch.int64, device=words.device)
        for j, (qv, cv) in enumerate(zip(q8, care8)):
            if cv:
                diff |= (t8[..., j : j + U] ^ qv) & cv
        phase_masks.append(diff == 0)
    return torch.stack(phase_masks, -1).reshape(*t8.shape[:-1], 3 * U)[..., :n]


def match_mask_b5(words: torch.Tensor, length: int, query: bytes) -> torch.Tensor:
    """Occurrence mask of ``query`` in a base-5 interleaved u32[2W] stream:
    bool[length - m + 1].  ``N`` is a literal, ``?`` the wildcard."""
    if words.ndim != 1 or words.shape[0] % 2:
        raise TypeError("match_mask_b5 takes a flat interleaved u32[2W] stream")
    _check_words(words)
    m = len(query)
    if length - m + 1 <= 0:
        raise ValueError(f"stream length {length} shorter than query ({m})")
    if length > (words.shape[0] // 2) * spec.NT_PER_WORD_B5:
        raise ValueError("length exceeds stream capacity")
    return _match_mask_b5_impl(words, _qc_host(query), length - m + 1)


# --- kernel tier: base-5 ----------------------------------------------------------------

def match_bits_b5(words: torch.Tensor, length: int, query: bytes) -> torch.Tensor:
    """Packed occurrence bits of ``query`` in a base-5 interleaved stream:
    u32[W] for W u64 words, bit ``b`` of word ``w`` flags a match at nt
    ``27 w + b`` (the search kernel).  ``N`` literal, ``?`` wildcard."""
    if words.ndim != 1 or words.shape[0] % 2:
        raise TypeError("match_bits_b5 takes a flat interleaved u32[2W] stream")
    m = len(query)
    if m > _B5_SEARCH_MAX_QUERY:
        raise ValueError(f"kernel scan caps queries at {_B5_SEARCH_MAX_QUERY} nt (got {m}); use match_mask_b5")
    qc = compile_query_b5(query)
    if length - m + 1 <= 0:
        raise ValueError(f"stream length {length} shorter than query ({m})")
    if length > (words.shape[0] // 2) * spec.NT_PER_WORD_B5:
        raise ValueError("length exceeds stream capacity")
    return kernels.match_b5_bits_stream(words, qc, length - m + 1)


def _use_b5_kernel(words: torch.Tensor, query) -> bool:
    return words.shape[0] >= _B5_SEARCH_THRESHOLD and len(query) <= _B5_SEARCH_MAX_QUERY


def match_count_b5(words: torch.Tensor, length: int, query: bytes) -> torch.Tensor:
    """Number of occurrences of ``query`` in a base-5 stream (int32 scalar,
    on the words' device): long flat streams take the kernel, short ones the
    mask tier (identical results)."""
    if words.ndim == 1 and _use_b5_kernel(words, query):
        return _count_bits(match_bits_b5(words, length, query))
    return match_mask_b5(words, length, query).sum().to(torch.int32)


def match_positions_b5(words: torch.Tensor, length: int, query: bytes) -> np.ndarray:
    """Sorted occurrence positions in a base-5 stream (host int64)."""
    if words.ndim == 1 and _use_b5_kernel(words, query):
        return _bit_positions(match_bits_b5(words, length, query), spec.NT_PER_WORD_B5)
    mask = match_mask_b5(words, length, query)
    return torch.nonzero(mask).flatten().cpu().numpy().astype(np.int64)
