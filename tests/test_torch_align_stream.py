"""The port's one-stream approximate search against the JAX package's on
the CPU, at tolerance 0: the row plans number for number, ``_overlap_rows``
(a halo spanning more rows than exist included), and
``best_match_stream`` / ``best_match_stream_b5`` with their errors, ragged
lengths, wildcards, a long query on a short stream and the empty text; and
the key of ``kernels.myers_stream_best`` (its plain version here) against
the eager reduction of the rows' results and the DP oracles, case by case."""

import numpy as np
import pytest
import torch

from cute_nucleotides_tpu.ops import align as ref
from cute_nucleotides_tpu_torch.ops import align, native
from cute_nucleotides_tpu_torch.ops import kernels as K

ACGT = np.frombuffer(b"ACGT", np.uint8)
ACGTN = np.frombuffer(b"ACGTN", np.uint8)


def test_row_plans_equal_reference():
    for W in (1, 2, 3, 7, 16, 100, 4097, 65536, 1 << 22, 15_559_777):
        for m in (1, 2, 3, 20, 21, 64, 300, 5000):
            assert align.stream_rows_plan(W, m) == ref.stream_rows_plan(W, m), (W, m)
            assert align.stream_rows_plan_b5(W, m) == ref.stream_rows_plan_b5(W, m), (W, m)
            assert align.halo_words(m) == ref.halo_words(m)


@pytest.mark.parametrize("W, R, wrb, H", ((12, 3, 4, 2), (10, 3, 4, 9), (5, 1, 5, 40), (7, 4, 2, 7), (8, 8, 1, 3)))
def test_overlap_rows_equal_reference(W, R, wrb, H):
    """Ragged tails pad with zeros; H > wrb spans several successors; H past
    the last row (the r05 case) takes an all-R zero block."""
    flat = np.random.default_rng(W + H).integers(0, 2**32, W, dtype=np.uint32)
    got = align._overlap_rows(torch.from_numpy(flat), R, wrb, H)
    want = np.asarray(ref._overlap_rows(flat, R, wrb, H))
    assert got.dtype == torch.uint32 and tuple(got.shape) == want.shape == (R, wrb + H)
    assert np.array_equal(got.numpy(), want)


def _stream(rng, n: int, alphabet, query: bytes, plant_at=()):
    s = bytearray(rng.choice(alphabet, n).tobytes())
    for at in plant_at:
        s[at : at + len(query)] = query
    return bytes(s)


@pytest.mark.parametrize("n", (1, 31, 32, 33, 1000, 5003))
def test_best_match_stream_equals_reference_and_host(n):
    rng = np.random.default_rng(n)
    query = b"GATTACAGNTTACA"
    text = _stream(rng, n, ACGT, b"GATTACAGATTTACA", (n // 2,) if n > 40 else ())
    words = np.ascontiguousarray(native.n_to_bits(text)).view(np.uint32)
    for length in sorted({n, max(n - 7, 0)}):
        got = align.best_match_stream(torch.from_numpy(words), length, query)
        assert got == ref.best_match_stream(words, length, query) == native.best_match(query, text[:length])
    assert align.best_match_stream(words, n, query) == native.best_match(query, text)  # a numpy stream


@pytest.mark.parametrize("n", (1, 26, 27, 28, 1000))
def test_best_match_stream_b5_equals_reference(n):
    rng = np.random.default_rng(100 + n)
    text = _stream(rng, n, ACGTN, b"GATNACA", (n // 3,) if n > 20 else ())
    words = np.ascontiguousarray(native.n_to_bits2(text)).view(np.uint32)
    for query in (b"GATNACA", b"GA?TACA", b"N"):
        got = align.best_match_stream_b5(torch.from_numpy(words), n, query)
        assert got == ref.best_match_stream_b5(words, n, query)
        if b"?" not in query:
            assert got == align.best_match_reference_b5(query, text)


def test_long_query_on_a_short_stream():
    """m = 40 over 48 nt: one row, and a halo wider than the stream (the
    successor rows do not exist)."""
    rng = np.random.default_rng(7)
    query = bytes(rng.choice(ACGT, 40))
    text = _stream(rng, 48, ACGT, query[:30], (10,))
    words = np.ascontiguousarray(native.n_to_bits(text)).view(np.uint32)[:3]
    assert align.stream_rows_plan(3, 40) == (1, 3, 5)
    assert align.best_match_stream(torch.from_numpy(words), 48, query) == ref.best_match_stream(words, 48, query)
    w5 = np.ascontiguousarray(native.n_to_bits2(text)).view(np.uint32)
    assert align.stream_rows_plan_b5(2, 40) == (1, 2, 3)
    assert align.best_match_stream_b5(torch.from_numpy(w5), 48, query) == ref.best_match_stream_b5(w5, 48, query)


def test_stream_errors_and_empty_text():
    w = torch.zeros(4, dtype=torch.uint32)
    wn = np.zeros(4, np.uint32)
    for fn, ref_fn, bad_shape, msg in (
            (align.best_match_stream, ref.best_match_stream, torch.zeros((2, 2), dtype=torch.uint32), "1-D u32"),
            (align.best_match_stream_b5, ref.best_match_stream_b5, torch.zeros(3, dtype=torch.uint32), "whole pairs")):
        with pytest.raises(ValueError, match=msg):
            fn(bad_shape, 1, b"ACGT")
        with pytest.raises(ValueError, match=msg):
            ref_fn(bad_shape.numpy(), 1, b"ACGT")
        with pytest.raises(ValueError, match="exceeds stream capacity"):
            fn(w, 65 if fn is align.best_match_stream else 55, b"ACGT")
        with pytest.raises(ValueError, match="exceeds stream capacity"):
            ref_fn(wn, 65 if fn is align.best_match_stream else 55, b"ACGT")
        with pytest.raises(ValueError, match="empty query"):
            fn(w, 1, b"")
        assert fn(w, 0, b"ACGTA") == ref_fn(wn, 0, b"ACGTA") == (5, 0)
        assert fn(torch.zeros(0, dtype=torch.uint32), 0, b"AC") == ref_fn(np.zeros(0, np.uint32), 0, b"AC") == (2, 0)
    # streams of 2^31 nt or more: the reference's messages, before any scan
    # (a stride-0 view stands in for the 512 MiB of words)
    huge = torch.zeros(1, dtype=torch.uint32).expand(1 << 27)
    with pytest.raises(ValueError, match=r"^single-device scan positions are int32; shard streams >= 2\^31 nt "
                                         r"with parallel.longseq.best_match_long$"):
        align.best_match_stream(huge, 2**31, b"ACGT")
    huge5 = torch.zeros(1, dtype=torch.uint32).expand(2 * ((2**31 // 27) + 1))
    with pytest.raises(ValueError, match=r"^single-device scan positions are int32$"):
        align.best_match_stream_b5(huge5, 2**31, b"ACGT")


# --- the stream key (kernels.myers_stream_best), case by case ------------------

def _sub(query: bytes, at: int, alphabet: bytes) -> bytes:
    """``query`` with one substitution at ``at``."""
    return query[:at] + bytes([next(c for c in alphabet if c != query[at])]) + query[at + 1:]


def _words(text: bytes, b5: bool) -> np.ndarray:
    return np.ascontiguousarray(native.n_to_bits2(text) if b5 else native.n_to_bits(text)).view(np.uint32)


def _rows(W: int, m: int, b5: bool) -> tuple[int, int, int]:
    """(rows, row stride, row length) in u32 of ``best_match_stream``'s plan."""
    if b5:
        R, prb, Hp = align.stream_rows_plan_b5(W // 2, m)
        return R, 2 * prb, 2 * (prb + Hp)
    R, wrb, H = align.stream_rows_plan(W, m)
    return R, wrb, wrb + H


def _stream_case(case: str, b5: bool) -> tuple[bytes, bytes, int, tuple | None]:
    """(text, query, length, the expected (dist, end) or None) of a case."""
    rng = np.random.default_rng(sum(map(ord, case)) + b5)
    alphabet = b"ACGTN" if b5 else b"ACGT"
    text = bytearray(rng.choice(np.frombuffer(alphabet, np.uint8), 4000).tobytes())
    query = bytes(rng.choice(ACGT, 20))
    if case == "tie":  # two hits at distance 1 in different rows: the first end wins
        text[700:720] = _sub(query, 10, b"ACGT")
        text[3100:3120] = _sub(query, 9, b"ACGT")
        return bytes(text), query, 4000, (1, 720)
    if case == "halo":  # an exact hit inside row 5's start, which row 4's halo covers too
        _, stride, row_len = _rows(len(_words(bytes(text), b5)), 20, b5)
        nt_row, nt_cap = (27 * (stride // 2), 27 * (row_len // 2)) if b5 else (16 * stride, 16 * row_len)
        at = 5 * nt_row + 10
        assert at + 20 <= 4 * nt_row + nt_cap
        text[at:at + 20] = query
        return bytes(text), query, 4000, (0, at + 20)
    if case == "none":  # nothing beats the empty alignment: (m, 0)
        return (b"N" if b5 else b"A") * 900, b"ACGTC" if b5 else b"CCTGC", 900, (5, 0)
    if case == "ragged":  # a length that is no multiple of a row cuts a hit at the end
        text[3970:3990] = query
        return bytes(text), query, 3993 - 7, None
    if case == "one":
        return bytes(text), query, 1, None
    if case == "wild":  # N the 2-bit query's wildcard, ? the base-5 query's
        q = query[:6] + (b"?" if b5 else b"N") + query[7:]
        text[2000:2020] = query
        return bytes(text), q, 4000, (0, 2020)
    assert case == "long"  # 1,040 nt: past the stream form's 32 blocks, the rows' path
    query = bytes(text[60:1100])
    for at in (100, 400, 700, 1000):
        query = _sub(query, at, b"ACGT")
    return bytes(text[:1150]), query, 1150, None


def _eager_reduction(peq, m: int, words: torch.Tensor, length: int, b5: bool) -> tuple[int, int]:
    """The reduction the stream path ran before its key: the plain scan of
    the plan's rows, then the least distance and, among the rows at it, the
    least global end, as eager ops; ``(m, 0)`` where nothing beats ``m``."""
    R, stride, row_len = _rows(words.numel(), m, b5)
    nt = 27 * (stride // 2) if b5 else 16 * stride
    base = nt * torch.arange(R, dtype=torch.int64)
    tl = (length - base).clamp(0, (27 * (row_len // 2) if b5 else 16 * row_len)).to(torch.int32)
    p = torch.from_numpy(peq)
    d, e = K.myers_scan_plain(p[None].expand(R, *p.shape), torch.full((R,), m, dtype=torch.int32), words, tl,
                              stride, row_len, mode="semiglobal", b5=b5)
    dmin = int(d.min())
    emin = int(torch.where(d == dmin, base + e, torch.iinfo(torch.int64).max).min())
    return dmin, emin if dmin < m else 0


@pytest.mark.parametrize("b5", (False, True), ids=("2bit", "b5"))
@pytest.mark.parametrize("case", ("tie", "halo", "none", "ragged", "one", "wild", "long"))
def test_stream_key_equals_eager_reduction_and_oracle(case, b5):
    """The plain ``myers_stream_best`` key, split, equals the eager reduction
    of the rows' results, ``best_match_stream(_b5)`` and the DP oracle (the
    JAX package's stream scan for a ``?`` query)."""
    text, query, length, want = _stream_case(case, b5)
    words = _words(text, b5)
    peq, m = (align.peq_from_bytes_b5 if b5 else align.peq_from_bytes)(query)
    R, stride, row_len = _rows(len(words), m, b5)
    key = K.myers_stream_best(peq, m, torch.from_numpy(words), length, R, stride, row_len, b5=b5)
    assert key.dtype == torch.int64 and key.ndim == 0
    got = (int(key) >> 32, int(key) & 0xFFFFFFFF)
    assert _same_key(key, K.myers_stream_best_plain(torch.from_numpy(peq), m, torch.from_numpy(words), length, R,
                                                    stride, row_len, b5=b5))
    assert got == _eager_reduction(peq, m, torch.from_numpy(words), length, b5)
    call = align.best_match_stream_b5 if b5 else align.best_match_stream
    assert call(torch.from_numpy(words), length, query) == got
    if b5 and b"?" in query:
        oracle = ref.best_match_stream_b5(words, length, query)
    else:
        oracle = (align.best_match_reference_b5 if b5 else align.best_match_reference)(query, text[:length])
    assert got == oracle
    if want is not None:
        assert got == want


def _same_key(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and int(a) == int(b)


def test_stream_best_refusals():
    """The wrapper's checks, before any scan: the Peq's planes and blocks,
    the query length against its blocks, rows that leave words uncovered,
    base-5 rows of half pairs and a length past 2^31."""
    peq, m = align.peq_from_bytes(b"GATTACA")
    w = torch.zeros(40, dtype=torch.uint32)
    with pytest.raises(TypeError, match="Peq"):
        K.myers_stream_best(peq[:3], m, w, 100, 4, 10, 12)
    with pytest.raises(ValueError, match="outside the Peq"):
        K.myers_stream_best(peq, 33, w, 100, 4, 10, 12)
    with pytest.raises(ValueError, match="do not cover"):
        K.myers_stream_best(peq, m, w, 100, 3, 10, 12)
    with pytest.raises(ValueError, match="whole u32 pairs"):
        K.myers_stream_best(align.peq_from_bytes_b5(b"GATTACA")[0], m, w, 100, 4, 10, 13, b5=True)
    with pytest.raises(ValueError, match="2\\^31"):
        K.myers_stream_best(peq, m, w, 2**31, 4, 10, 12)
    with pytest.raises(TypeError, match="flat u32"):
        K.myers_stream_best(peq, m, w.view(4, 10), 100, 4, 10, 12)
    assert int(K.myers_stream_best(peq, m, w, 0, 4, 10, 12)) == m << 32  # no text: (m, 0)


@pytest.mark.parametrize("b5", (False, True), ids=("2bit", "b5"))
def test_stream_key_into_out(b5):
    """``out=`` takes the key in place of a new tensor, the same value; a key
    of another dtype or shape is refused before any scan."""
    text, query, length, want = _stream_case("tie", b5)
    words = torch.from_numpy(_words(text, b5))
    peq, m = (align.peq_from_bytes_b5 if b5 else align.peq_from_bytes)(query)
    rows = _rows(words.numel(), m, b5)
    out = torch.full((), -1, dtype=torch.int64)
    key = K.myers_stream_best(peq, m, words, length, *rows, b5=b5, out=out)
    assert key is out and int(out) == int(K.myers_stream_best(peq, m, words, length, *rows, b5=b5))
    assert (int(out) >> 32, int(out) & 0xFFFFFFFF) == want
    for bad in (torch.zeros((), dtype=torch.int32), torch.zeros(1, dtype=torch.int64)):
        with pytest.raises(TypeError, match="int64 0-d key"):
            K.myers_stream_best(peq, m, words, length, *rows, b5=b5, out=bad)


def test_stream_calls_keep_one_key_slot_a_thread():
    """``best_match_stream(_b5)`` read their key back before they return, so
    a thread's calls share one key slot a device; another thread has its
    own, and calls in turns on both codecs keep their answers."""
    import threading

    slot = align._key_slot(torch.device("cpu"))
    assert align._key_slot(torch.device("cpu")) is slot
    other = []
    t = threading.Thread(target=lambda: other.append(align._key_slot(torch.device("cpu"))))
    t.start()
    t.join()
    assert other[0] is not slot
    cases = [(b5, *_stream_case(c, b5)) for c in ("tie", "halo", "none") for b5 in (False, True)]
    for _ in range(2):
        for b5, text, query, length, want in cases:
            call = align.best_match_stream_b5 if b5 else align.best_match_stream
            assert call(torch.from_numpy(_words(text, b5)), length, query) == want
    assert align._key_slot(torch.device("cpu")) is slot
