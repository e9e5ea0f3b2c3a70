"""The port's one-stream approximate search against the JAX package's on
the CPU, at tolerance 0: the row plans number for number, ``_overlap_rows``
(a halo spanning more rows than exist included), and
``best_match_stream`` / ``best_match_stream_b5`` with their errors, ragged
lengths, wildcards, a long query on a short stream and the empty text."""

import numpy as np
import pytest
import torch

from cute_nucleotides_tpu.ops import align as ref
from cute_nucleotides_tpu_torch.ops import align, native

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
