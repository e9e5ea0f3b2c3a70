"""Batched edit distance on packed streams (Myers bit-parallel), both codecs.

Counterpart of ``cute_nucleotides_tpu/ops/align.py``, with its names,
errors and results:

* Peq constructors: :func:`peq_from_packed` (2-bit words, torch),
  :func:`peq_from_bytes` (``N`` a wildcard) and :func:`peq_from_bytes_b5`
  (``N`` a literal, ``?`` the wildcard), plain numpy as in the reference;
* the scans: global (:func:`edit_distance_packed`), semiglobal
  (:func:`best_match_packed`, :func:`best_match_peq`), prefix
  (:func:`prefix_distance_packed`), every end within a threshold
  (:func:`match_ends_packed`, :func:`match_ends_peq`), and their base-5
  mirrors; each runs kernel #19 (:func:`.kernels.myers_scan`) on a CUDA
  tensor and its plain version on a CPU tensor;
* one long stream (:func:`best_match_stream`, ``_b5``): rows overlapping by
  a ``2m - 2`` nt halo (:func:`stream_rows_plan`), which #19's stream form
  (:func:`.kernels.myers_stream_best`) reads straight from the flat stream
  and reduces on the card to one key, read back once;
* host oracles and tracebacks (numpy): the tests' ground truth, and
  ``approx --cigar``'s window DP.

Lengths (``qlens``, ``tlens``, ``max_errors``) may be tensors, arrays or
sequences; they go to the text words' device as int32.  Results are int32
(and bool) tensors on that device.  Queries and texts compare as
normalized codes (upper case, ``U`` as ``T``); a base-5 text's corrupt
triplet (125..127) reads its high digit 5 as ``A``, and a base-5 query's
digit 5 matches nothing, as in the reference.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..utils import tracing
from . import eager, kernels, spec

__all__ = [
    "peq_from_packed",
    "peq_from_bytes",
    "peq_from_bytes_b5",
    "edit_distance_packed",
    "edit_distance_packed_b5",
    "best_match_packed",
    "best_match_packed_b5",
    "prefix_distance_packed",
    "match_ends_packed",
    "match_ends_peq",
    "best_match_peq",
    "best_match_peq_b5",
    "best_match_stream",
    "best_match_stream_b5",
    "edit_distance_reference",
    "edit_distance_reference_b5",
    "best_match_reference",
    "prefix_distance_reference",
    "best_match_reference_b5",
    "semiglobal_traceback",
    "semiglobal_traceback_b5",
]

#: query rows per bit-vector block
ROWS_PER_BLOCK = kernels.MYERS_BLOCK

#: the reference's name for the stream's row panels
_overlap_rows = kernels.overlap_rows


def _lens(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.int32)


def _block_mask(qlens: torch.Tensor, nb: int) -> torch.Tensor:
    """int64 mask [B, NB] of the rows below each query's length: block b
    keeps min(max(qlen - 32 b, 0), 32) low bits."""
    bits = (qlens.to(torch.int64)[:, None]
            - ROWS_PER_BLOCK * torch.arange(nb, device=qlens.device)).clamp(0, ROWS_PER_BLOCK)
    return (1 << bits) - 1


def _compress_even_bits(x: torch.Tensor) -> torch.Tensor:
    """Gather the 16 even-position bits of each u32 (int64 lanes, bits
    already masked to 0x55555555) into its low 16 bits."""
    x = (x | (x >> 1)) & 0x33333333
    x = (x | (x >> 2)) & 0x0F0F0F0F
    x = (x | (x >> 4)) & 0x00FF00FF
    return (x | (x >> 8)) & 0x0000FFFF


def peq_from_packed(qwords: torch.Tensor, qlens) -> torch.Tensor:
    """Per-code query bitmasks from packed words: u32[B, Wq] -> u32[B, 4, NB].

    Bit ``i % 32`` of ``Peq[b, c, i // 32]`` is set iff query ``b``'s
    nucleotide ``i`` has 2-bit code ``c``; rows at and past ``qlens[b]`` are
    zero in every plane (the 'A' padding must not match).  ``NB = ceil(Wq /
    2)`` blocks of 32 rows."""
    q = eager.u32_to_i64(qwords)
    qlens = _lens(qlens, q.device)
    if q.shape[1] % 2:  # pad to a whole 32-row block; masked out below
        q = torch.cat([q, q.new_zeros(q.shape[0], 1)], 1)
    planes = []
    for c in range(4):
        same = ~(q ^ (c * 0x55555555)) & eager.U32
        m16 = _compress_even_bits(same & (same >> 1) & 0x55555555)
        planes.append(m16[:, 0::2] | (m16[:, 1::2] << 16))
    peq = torch.stack(planes, 1)
    return eager.i64_to_u32(peq & _block_mask(qlens, peq.shape[2])[:, None, :])


#: query bytes allowed by :func:`peq_from_bytes` (N/n match any base)
_QUERY_OK = frozenset(b"ACGTUacgtuNn")
#: byte -> 2-bit code and byte -> base-5 digit, indexed as plain ints
_CODE_2BIT, _DIGIT_B5 = bytes(spec.BYTE_LUT_2BIT), bytes(spec.BYTE_LUT_B5)


def _peq_planes(query: bytes, code: bytes, planes: int, wild: bytes) -> np.ndarray:
    """u32[planes, NB]: bit ``i % 32`` of word ``i // 32`` of plane ``c`` is
    set where query byte ``i`` has code ``c`` (``code[byte]``) or is one of
    ``wild``; the rows are gathered in Python ints, a few microseconds for a
    23-nt query."""
    rows, every = [0] * planes, 0
    for i, b in enumerate(query):
        if b in wild:
            every |= 1 << i
        else:
            rows[code[b]] |= 1 << i
    nb = -(-len(query) // ROWS_PER_BLOCK)
    return np.array([[((r | every) >> (32 * k)) & 0xFFFFFFFF for k in range(nb)] for r in rows], np.uint32)


def peq_from_bytes(query: bytes) -> tuple[np.ndarray, int]:
    """ASCII query -> (``Peq`` u32[4, NB], m); ``N``/``n`` matches any base
    (its row's bit in all four planes).  Raises on an empty query and on
    bytes outside {A,C,G,T,U,N} (either case)."""
    if isinstance(query, str):
        query = query.encode()
    m = len(query)
    if m == 0:
        raise ValueError("empty query")
    bad = set(query) - _QUERY_OK
    if bad:
        raise ValueError(f"query contains non-ACGTUN bytes: {sorted(chr(b) for b in bad)}")
    return _peq_planes(query, _CODE_2BIT, 4, b"Nn"), m


#: query bytes allowed by :func:`peq_from_bytes_b5` (N literal, ? = any)
_QUERY_OK_B5 = frozenset(b"ACGTUNacgtun?")


def peq_from_bytes_b5(query: bytes) -> tuple[np.ndarray, int]:
    """ASCII query -> (``Peq`` u32[5, NB], m) over base-5 digits: ``N`` is a
    literal and ``?`` the wildcard, as in the base-5 search."""
    if isinstance(query, str):
        query = query.encode()
    m = len(query)
    if m == 0:
        raise ValueError("empty query")
    bad = set(query) - _QUERY_OK_B5
    if bad:
        raise ValueError(f"query contains non-ACGTUN? bytes: {sorted(chr(b) for b in bad)}")
    return _peq_planes(query, _DIGIT_B5, 5, b"?"), m


def _scan(peq, qlens, twords, tlens, mode: str, b5: bool = False, max_errors=None):
    """Kernel #19 (or its plain version) over a batch of text rows
    u32[B, Wt]; lengths as int32 on the words' device."""
    if twords.dtype != torch.uint32 or twords.ndim != 2:
        raise TypeError(f"expected text words u32[B, Wt], got {twords.dtype}{tuple(twords.shape)}")
    dev, wt = twords.device, twords.shape[1]
    if b5 and wt % 2:
        raise ValueError("base-5 packed stream must have even u32 count")
    max_errors = None if max_errors is None else _lens(max_errors, dev)
    return kernels.myers_scan(peq.to(dev), _lens(qlens, dev), twords.contiguous().view(-1), _lens(tlens, dev),
                              wt, wt, mode=mode, b5=b5, max_errors=max_errors)


def _best(best, end, qlens):
    """(dist, end) with the empty query's (0, 0)."""
    empty = _lens(qlens, best.device) == 0
    return torch.where(empty, 0, best), torch.where(empty, 0, end)


def best_match_peq_b5(peq: torch.Tensor, qlens, twords: torch.Tensor, tlens) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`best_match_packed_b5` from precomputed 5-plane ``Peq``
    (``u32[B, 5, NB]``, e.g. :func:`peq_from_bytes_b5` broadcast)."""
    return _best(*_scan(peq, qlens, twords, tlens, "semiglobal", b5=True), qlens)


def best_match_peq(peq: torch.Tensor, qlens, twords: torch.Tensor, tlens) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`best_match_packed` from precomputed ``Peq`` planes ``u32[B, 4,
    NB]``, e.g. one :func:`peq_from_bytes` result broadcast across the batch
    (``expand``, read without a copy), which also allows N wildcards."""
    return _best(*_scan(peq, qlens, twords, tlens, "semiglobal"), qlens)


def edit_distance_packed(qwords: torch.Tensor, qlens, twords: torch.Tensor, tlens) -> torch.Tensor:
    """Batched global Levenshtein distance, packed in: ``-> i32[B]``.

    ``qwords u32[B, Wq]`` / ``twords u32[B, Wt]`` are 2-bit packed streams
    ('A'-padded past ``qlens`` / ``tlens``); rows are independent pairs,
    queries up to ``16 * Wq`` nt, texts up to ``16 * Wt`` nt."""
    score = _scan(peq_from_packed(qwords, qlens), qlens, twords, tlens, "global")
    # m == 0: every text char is an insertion; n == 0 is already score == m
    return torch.where(_lens(qlens, score.device) == 0, _lens(tlens, score.device), score)


def best_match_packed(qwords: torch.Tensor, qlens, twords: torch.Tensor, tlens) -> tuple[torch.Tensor, torch.Tensor]:
    """Best approximate occurrence of each query in its text (semiglobal):
    ``(dist i32[B], end i32[B])``, the least edit distance of the whole
    query against any substring and the first end achieving it (``end`` 0
    when the empty substring is best, ``dist == qlen``)."""
    return _best(*_scan(peq_from_packed(qwords, qlens), qlens, twords, tlens, "semiglobal"), qlens)


def prefix_distance_packed(qwords: torch.Tensor, qlens, twords: torch.Tensor,
                           tlens) -> tuple[torch.Tensor, torch.Tensor]:
    """Whole query vs the best text PREFIX (edlib's SHW): ``(dist i32[B],
    end i32[B])``, the running minimum of the global scan; ``end == 0`` is
    the empty prefix."""
    return _best(*_scan(peq_from_packed(qwords, qlens), qlens, twords, tlens, "prefix"), qlens)


def match_ends_packed(qwords: torch.Tensor, qlens, twords: torch.Tensor, tlens, max_errors) -> torch.Tensor:
    """EVERY end position within ``max_errors`` edits: bool[B, 16 * Wt];
    ``out[b, j]`` is True iff some substring of text ``b`` ending at ``j +
    1`` matches query ``b`` within ``max_errors[b]`` edits.  Positions at
    and past ``tlens[b]`` are False, also at ``max_errors == INT32_MAX``."""
    return _scan(peq_from_packed(qwords, qlens), qlens, twords, tlens, "ends", max_errors=max_errors)


def match_ends_peq(peq: torch.Tensor, qlens, twords: torch.Tensor, tlens, max_errors) -> torch.Tensor:
    """:func:`match_ends_packed` from precomputed ``Peq`` planes (``u32[B,
    4, NB]`` -- the query-vs-records form, N wildcards allowed)."""
    return _scan(peq, qlens, twords, tlens, "ends", max_errors=max_errors)


def _unpack_digits_b5_t(twords: torch.Tensor) -> torch.Tensor:
    """Packed base-5 text u32[B, 2*W] -> time-major digits u8[27*W, B]
    (exact multiply-shift splits of each triplet; a corrupt triplet's high
    digit is 5)."""
    if twords.shape[1] % 2:
        raise ValueError("base-5 packed stream must have even u32 count")
    return kernels.text_codes(twords, b5=True).to(torch.uint8).T


def _peq_from_codes(codes: torch.Tensor, qlens, alphabet: int) -> torch.Tensor:
    """Integer codes u8/i32[B, L] -> ``Peq`` u32[B, alphabet, NB]; a code
    outside the alphabet (a base-5 digit 5) matches no plane."""
    B, L = codes.shape
    nb = max(1, -(-L // ROWS_PER_BLOCK))
    c = torch.full((B, ROWS_PER_BLOCK * nb), alphabet, dtype=torch.int64, device=codes.device)
    c[:, :L] = codes.to(torch.int64)
    grid = c.view(B, 1, nb, ROWS_PER_BLOCK)
    syms = torch.arange(alphabet, device=codes.device).view(1, alphabet, 1, 1)
    weights = 1 << torch.arange(ROWS_PER_BLOCK, device=codes.device)
    peq = ((grid == syms).to(torch.int64) * weights).sum(-1)
    return eager.i64_to_u32(peq & _block_mask(_lens(qlens, codes.device), nb)[:, None, :])


def _peq_b5(qwords: torch.Tensor, qlens) -> torch.Tensor:
    # the kernel reads a row's words in place: a row of strided words is copied
    q = qwords if qwords.stride(-1) == 1 else qwords.contiguous()
    return kernels.peq_b5(q, _lens(qlens, qwords.device))


def edit_distance_packed_b5(qwords: torch.Tensor, qlens, twords: torch.Tensor, tlens) -> torch.Tensor:
    """Batched global Levenshtein on base-5 packed streams: ``-> i32[B]``,
    over the five-digit alphabet (``N`` a literal digit)."""
    score = _scan(_peq_b5(qwords, qlens), qlens, twords, tlens, "global", b5=True)
    return torch.where(_lens(qlens, score.device) == 0, _lens(tlens, score.device), score)


def best_match_packed_b5(qwords: torch.Tensor, qlens, twords: torch.Tensor,
                         tlens) -> tuple[torch.Tensor, torch.Tensor]:
    """Base-5 mirror of :func:`best_match_packed`: ``(dist i32[B], end
    i32[B])``."""
    return _best(*_scan(_peq_b5(qwords, qlens), qlens, twords, tlens, "semiglobal", b5=True), qlens)


# --- one long stream ---------------------------------------------------------

def halo_words(m: int) -> int:
    """u32 words covering the ``2m - 2`` nt any occurrence better than the
    trivial distance ``m`` can need past its row (``d >= |span - m|``)."""
    return max(1, -(-(2 * m - 2) // spec.NT_PER_U32_2BIT))


def stream_rows_plan(W: int, m: int) -> tuple[int, int, int]:
    """Row split of a one-stream scan: ``(R, wrb, H)``, R rows of ``wrb``
    base words plus ``H`` halo words, R sized so the halo is about a
    quarter of the stream, at most 32768 rows (the reference's plan)."""
    H = halo_words(m)
    R = max(1, min(32768, (2 * W) // max(m - 1, 1), W))
    wrb = -(-W // R)
    return -(-W // wrb), wrb, H


def stream_rows_plan_b5(Wp: int, m: int) -> tuple[int, int, int]:
    """Base-5 row split over u32 PAIRS (27 nt each): ``(R, prb, Hp)``."""
    Hp = max(1, -(-(2 * m - 2) // spec.NT_PER_WORD_B5))
    R = max(1, min(32768, (3 * Wp) // max(m - 1, 1), Wp))
    prb = -(-Wp // R)
    return -(-Wp // prb), prb, Hp


def _stream_key(peq, ext: torch.Tensor, length, m: int, R: int, stride: int, halo: int, b5: bool,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """The rows' semiglobal scan over the flat stream ``ext`` (row r: ``stride +
    halo`` u32 from u32 ``r * stride``), reduced on the words' device to one
    int64 0-d key, ``(dist << 32) | end`` (:func:`.kernels.myers_stream_best`,
    into ``out`` where given): the least distance and the first end reaching
    it, 0 when nothing beats ``m``."""
    with tracing.span("align.stream.launch"):
        return kernels.myers_stream_best(peq, m, ext, int(length), R, stride, stride + halo, b5=b5, out=out)


def _key_pair(key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dist, end)`` of a stream key as int32 0-d tensors on its device,
    with no read-back."""
    return (key >> 32).to(torch.int32), (key & 0xFFFFFFFF).to(torch.int32)


def _best_match_stream_impl(peq, ext: torch.Tensor, length, m: int, plan: tuple[int, int, int]):
    """The 2-bit stream scan behind :func:`best_match_stream` (the bench's
    ``approx_stream_m21`` row): ``(dist, end)`` as 0-d tensors."""
    R, wrb, H = plan
    return _key_pair(_stream_key(peq, ext, length, m, R, wrb, H, b5=False))


def _best_match_stream_impl_b5(peq, ext: torch.Tensor, length, m: int, plan: tuple[int, int, int]):
    """The base-5 stream scan: pair boundaries are u32-even, so row r is
    ``2 (prb + Hp)`` u32 from u32 ``2 prb r``."""
    R, prb, Hp = plan
    return _key_pair(_stream_key(peq, ext, length, m, R, 2 * prb, 2 * Hp, b5=True))


#: each thread's key slot a device, for the calls that read their key back before they return
_KEY_SLOTS = threading.local()


def _key_slot(dev: torch.device) -> torch.Tensor:
    """This thread's int64 0-d key slot on ``dev``, made on first use."""
    slots = _KEY_SLOTS.__dict__.setdefault("by_device", {})
    key = slots.get(dev)
    if key is None:
        key = slots[dev] = torch.empty((), dtype=torch.int64, device=dev)
    return key


def _read_key(key: torch.Tensor) -> tuple[int, int]:
    """``(dist, end)`` of a stream key, read back once."""
    with tracing.span("align.stream.readback"):
        k = key.item()
    return k >> 32, k & 0xFFFFFFFF


def _stream_words(words) -> torch.Tensor:
    if isinstance(words, torch.Tensor):
        return words
    from ..models import resolve_device

    return torch.from_numpy(np.array(words, dtype=np.uint32)).to(resolve_device("auto"))


def best_match_stream(words, length: int, query: bytes) -> tuple[int, int]:
    """Best approximate occurrence of ``query`` in ONE long 2-bit stream
    ``words u32[W]`` of ``length`` nt (a tensor stays on its device; an
    array goes to the card when there is one): ``(dist, end)``, the least
    edit distance of the whole query against any substring and the first
    end achieving it (``(m, 0)`` when nothing beats the empty alignment).
    ``N``/``n`` in the query matches any base."""
    with tracing.span("align.stream"):
        with tracing.span("align.stream.peq"):
            peq, m = peq_from_bytes(query)
        with tracing.span("align.stream.plan"):
            words = _stream_words(words)
            if words.ndim != 1:
                raise ValueError("best_match_stream takes a 1-D u32 word stream")
            if length > spec.NT_PER_U32_2BIT * words.shape[0]:
                raise ValueError("length exceeds stream capacity")
            if length >= 2**31:
                raise ValueError(
                    "single-device scan positions are int32; shard streams >= 2^31 nt with "
                    "parallel.longseq.best_match_long"
                )
            if length == 0 or words.shape[0] == 0:
                return m, 0  # empty text: only the trivial alignment exists
            R, wrb, H = stream_rows_plan(words.shape[0], m)
        return _read_key(_stream_key(peq, words, length, m, R, wrb, H, False, _key_slot(words.device)))


def best_match_stream_b5(words, length: int, query: bytes) -> tuple[int, int]:
    """Base-5 mirror of :func:`best_match_stream` (``N`` literal, ``?``
    wildcard); ``words u32[2*Wp]`` is the serialized base-5 stream."""
    with tracing.span("align.stream"):
        with tracing.span("align.stream.peq"):
            peq, m = peq_from_bytes_b5(query)
        with tracing.span("align.stream.plan"):
            words = _stream_words(words)
            if words.ndim != 1 or words.shape[0] % 2:
                raise ValueError("best_match_stream_b5 takes a flat u32 stream of whole pairs")
            if length > spec.NT_PER_WORD_B5 * (words.shape[0] // 2):
                raise ValueError("length exceeds stream capacity")
            if length >= 2**31:
                raise ValueError("single-device scan positions are int32")
            if length == 0 or words.shape[0] == 0:
                return m, 0  # empty text: only the trivial alignment exists
            R, prb, Hp = stream_rows_plan_b5(words.shape[0] // 2, m)
        return _read_key(_stream_key(peq, words, length, m, R, 2 * prb, 2 * Hp, True, _key_slot(words.device)))


# --- host oracles and tracebacks (numpy) --------------------------------------

def _fold_codes(seq: bytes) -> np.ndarray:
    return (np.frombuffer(bytes(seq), np.uint8) >> 1) & 3


def _wild_rows(seq: bytes) -> np.ndarray:
    """Per-position wildcard flags: ``N``/``n`` matches any base for free
    (the device Peq's wildcard; all oracles agree)."""
    return (np.frombuffer(bytes(seq), np.uint8) & 0xDF) == ord("N")


def _dp_last_row(ca, cb, wild) -> np.ndarray:
    """Global-recurrence DP over integer codes: the last row ``D[m][:]``
    (``D[0][j] = j``); ``wild[i]`` makes query row ``i`` match any code."""
    prev = np.arange(len(cb) + 1, dtype=np.int64)
    for i, x in enumerate(ca):
        cur = np.empty_like(prev)
        cur[0] = prev[0] + 1
        cur[1:] = np.minimum(prev[:-1] + ((cb != x) & ~wild[i]), prev[1:] + 1)
        for j in range(1, len(cur)):  # left-to-right insertion chain
            cur[j] = min(cur[j], cur[j - 1] + 1)
        prev = cur
    return prev


def _dp_best_match(cq, ct, wild) -> tuple[int, int]:
    """Semiglobal DP over integer codes: ``(min dist, first best end)``
    (``D[0][j] = 0``)."""
    m = len(cq)
    prev = np.arange(m + 1, dtype=np.int64)  # D[i][0] = i
    best, best_end = m, 0
    for j, x in enumerate(ct):
        cur = np.empty_like(prev)
        cur[0] = 0  # D[0][j] = 0: text prefix free
        for i in range(1, m + 1):
            cur[i] = min(prev[i - 1] + int(cq[i - 1] != x and not wild[i - 1]), prev[i] + 1, cur[i - 1] + 1)
        prev = cur
        if cur[m] < best:
            best, best_end = int(cur[m]), j + 1
    return best, best_end


def edit_distance_reference(a: bytes, b: bytes) -> int:
    """NumPy DP oracle: global Levenshtein over normalized codes (``N``/``n``
    in ``a``, the query, matches any base)."""
    return int(_dp_last_row(_fold_codes(a), _fold_codes(b), _wild_rows(a))[-1])


def prefix_distance_reference(q: bytes, t: bytes) -> tuple[int, int]:
    """DP oracle for :func:`prefix_distance_packed`: the global last row's
    ``(min, first argmin)``."""
    row = _dp_last_row(_fold_codes(q), _fold_codes(t), _wild_rows(q))
    return int(row.min()), int(row.argmin())


def _traceback_codes(query: bytes, window: bytes, b5: bool) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(query codes, window codes, query wildcard rows): 2-bit folds with
    ``N``/``n`` as the wildcard, or base-5 digits with ``?``."""
    if isinstance(query, str):
        query = query.encode()
    if b5:
        return _b5_digits_of(query), _b5_digits_of(window), np.frombuffer(bytes(query), np.uint8) == ord("?")
    return _fold_codes(query), _fold_codes(window), _wild_rows(query)


def semiglobal_traceback(query: bytes, window: bytes) -> tuple[int, int, int, str]:
    """Full semiglobal DP and traceback on a small window: ``(dist, start,
    end, cigar)``, window offsets of the matched substring and its SAM
    CIGAR with the query as the read (``M`` aligned, ``I`` query insertion,
    ``D`` text base skipped).  ``N``/``n`` in the query matches any base,
    as in the device scan, so the CIGAR agrees with the reported distance."""
    return _traceback_core(*_traceback_codes(query, window, False))


def semiglobal_traceback_b5(query: bytes, window: bytes) -> tuple[int, int, int, str]:
    """Base-5 mirror of :func:`semiglobal_traceback`: digit alphabet, ``N``
    literal, ``?`` wildcard."""
    return _traceback_core(*_traceback_codes(query, window, True))


def semiglobal_tracebacks(pairs, b5: bool = False) -> list[tuple[int, int, int, str]]:
    """:func:`semiglobal_traceback` (or ``_b5``) of many ``(query,
    window)`` pairs, the same results in the same order: pairs of one
    (query, window) length share one DP over a (G, m + 1, n + 1) array, so
    ``approx --cigar`` pays a few numpy calls a row of the DP per batch,
    not per record."""
    codes = [_traceback_codes(q, w, b5) for q, w in pairs]
    groups: dict[tuple[int, int], list[int]] = {}
    for k, (cq, ct, _) in enumerate(codes):
        groups.setdefault((len(cq), len(ct)), []).append(k)
    out = [None] * len(codes)
    for idx in groups.values():
        cq, ct, wild = (np.stack([codes[k][a] for k in idx]) for a in range(3))
        for k, D, q, t, w in zip(idx, _traceback_dp(cq, ct, wild), cq, ct, wild):
            out[k] = _traceback_walk(D, q, t, w)
    return out


def _traceback_dp(cq: np.ndarray, ct: np.ndarray, wild: np.ndarray) -> np.ndarray:
    """The semiglobal DP matrices D[g, i, j] of G pairs of one shape:
    ``D[i][0] = i``, ``D[0][j] = 0`` (the text prefix free)."""
    G, m = cq.shape
    n = ct.shape[1]
    D = np.zeros((G, m + 1, n + 1), np.int64)
    D[:, :, 0] = np.arange(m + 1)
    steps = np.arange(n + 1)
    for i in range(1, m + 1):
        sub = (ct != cq[:, i - 1 : i]) & ~wild[:, i - 1 : i]
        D[:, i, 1:] = np.minimum(D[:, i - 1, :-1] + sub, D[:, i - 1, 1:] + 1)
        # the left-to-right chain D[i][j] = min(D[i][j], D[i][j-1] + 1), in one pass
        D[:, i] = np.minimum.accumulate(D[:, i] - steps, axis=1) + steps
    return D


def _traceback_core(cq: np.ndarray, ct: np.ndarray, wild: np.ndarray) -> tuple[int, int, int, str]:
    return _traceback_walk(_traceback_dp(cq[None], ct[None], wild[None])[0], cq, ct, wild)


def _traceback_walk(D: np.ndarray, cq: np.ndarray, ct: np.ndarray, wild: np.ndarray) -> tuple[int, int, int, str]:
    """``(dist, start, end, cigar)`` from one pair's DP matrix: the first
    best end, then the walk back preferring M, then I, then D."""
    m = len(cq)
    end = int(np.argmin(D[m]))  # first best end
    dist = int(D[m, end])
    D, cq, ct, wild = D.tolist(), cq.tolist(), ct.tolist(), wild.tolist()  # the walk reads Python ints
    i, j, ops = m, end, []
    while i > 0:
        if j > 0 and D[i][j] == D[i - 1][j - 1] + ((cq[i - 1] != ct[j - 1]) and not wild[i - 1]):
            ops.append("M")
            i, j = i - 1, j - 1
        elif D[i][j] == D[i - 1][j] + 1:
            ops.append("I")
            i -= 1
        else:
            ops.append("D")
            j -= 1
    ops.reverse()
    cigar, run = [], 0
    for k, op in enumerate(ops):
        run += 1
        if k + 1 == len(ops) or ops[k + 1] != op:
            cigar.append(f"{run}{op}")
            run = 0
    return dist, j, end, "".join(cigar)


def _b5_digits_of(seq: bytes) -> np.ndarray:
    return spec.BYTE_LUT_B5[np.frombuffer(bytes(seq), np.uint8)]


def edit_distance_reference_b5(a: bytes, b: bytes) -> int:
    """DP oracle over base-5 digits: the five-symbol alphabet, ``N`` a
    literal (no wildcards)."""
    ca = _b5_digits_of(a)
    return int(_dp_last_row(ca, _b5_digits_of(b), np.zeros(len(ca), bool))[-1])


def best_match_reference_b5(q: bytes, t: bytes) -> tuple[int, int]:
    """Base-5-digit DP oracle for :func:`best_match_packed_b5`."""
    cq = _b5_digits_of(q)
    return _dp_best_match(cq, _b5_digits_of(t), np.zeros(len(cq), bool))


def best_match_reference(q: bytes, t: bytes) -> tuple[int, int]:
    """DP oracle for :func:`best_match_packed`: ``(dist, first end)``
    (``N``/``n`` in the query matches any base)."""
    return _dp_best_match(_fold_codes(q), _fold_codes(t), _wild_rows(q))
