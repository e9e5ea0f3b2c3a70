"""The port's ``ops/align.py`` against the JAX package's on the CPU, at
tolerance 0: every exported scan of both alphabets (global, semiglobal,
prefix, every end within a threshold, and the Peq forms with a broadcast
query), the Peq constructors and their errors, and the copied host oracles and
tracebacks.  The batches put the hard cases in their rows: query lengths at
the 32-row block seams (1, 31-33, 64, 65), texts of 31-33 nt (2-bit) and
26-28, 53-55 nt (base-5), empty queries and texts, wildcards, base-5
triplets 125-127 in texts and queries, and ``max_errors == INT32_MAX``.  On
the CPU the port runs kernel #19's plain version.  Inputs come from numpy
seeds."""

import numpy as np
import pytest
import torch

from cute_nucleotides_tpu.ops import align as ref, native as ref_native
from cute_nucleotides_tpu_torch.ops import align, kernels, native

ACGT = np.frombuffer(b"ACGT", np.uint8)
ACGTN = np.frombuffer(b"ACGTN", np.uint8)
INT32_MAX = 2**31 - 1
SEAM_M = (1, 31, 32, 33, 64, 65)


def _rows(seqs, encode, width_u32: int) -> np.ndarray:
    """ASCII rows -> packed u32[len(seqs), width_u32]: each row's words,
    zero-padded or cut to the width (a cut u32 holds only padding)."""
    out = np.zeros((len(seqs), width_u32), np.uint32)
    for i, s in enumerate(seqs):
        w = np.ascontiguousarray(encode(s)).view(np.uint32)[:width_u32]
        out[i, : w.size] = w
    return out


def _planted(rng, n: int, query: bytes, alphabet=ACGT) -> bytes:
    """A random text of n nt with the query planted with up to 2 edits."""
    t = bytearray(rng.choice(alphabet, n).tobytes())
    if n > len(query) + 2:
        q = bytearray(query)
        for _ in range(int(rng.integers(0, 3))):
            q[int(rng.integers(0, len(q)))] = int(rng.choice(alphabet))
        at = int(rng.integers(0, n - len(q)))
        t[at : at + len(q)] = q
    return bytes(t)


def _same(got, want) -> None:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "cpu" and g.dtype in (torch.int32, torch.bool)
        assert np.array_equal(g.numpy(), np.asarray(w)), (g.numpy(), np.asarray(w))


def _batch_2bit(rng, wq: int, wt: int):
    """(qwords, qlens, twords, tlens, queries, texts): every query length at
    the seams that fits wq words against texts of 0, 31, 32, 33 and the full
    capacity, plus empty queries."""
    ms = [m for m in SEAM_M if m <= 16 * wq] + [0]
    ns = (0, 31, 32, 33, 16 * wt)
    queries, texts = [], []
    for m in ms:
        for n in ns:
            q = bytes(rng.choice(ACGT, m))
            queries.append(q)
            texts.append(_planted(rng, n, q) if m else bytes(rng.choice(ACGT, n)))
    qw, tw = _rows(queries, native.n_to_bits, wq), _rows(texts, native.n_to_bits, wt)
    ql = np.array([len(q) for q in queries], np.int32)
    tl = np.array([len(t) for t in texts], np.int32)
    return qw, ql, tw, tl, queries, texts


@pytest.mark.parametrize("wq", (2, 5))
def test_packed_2bit_scans_match_reference_and_oracles(wq):
    rng = np.random.default_rng(wq)
    qw, ql, tw, tl, queries, texts = _batch_2bit(rng, wq, 3)
    tq, ttw = torch.from_numpy(qw), torch.from_numpy(tw)
    tl_short = tl.copy()
    tl_short[::3] = np.maximum(tl_short[::3] - 5, 0)  # tlens below the words' content
    dist = align.edit_distance_packed(tq, ql, ttw, tl_short)
    _same(dist, ref.edit_distance_packed(qw, ql, tw, tl_short))
    best = align.best_match_packed(tq, ql, ttw, tl)
    _same(best, ref.best_match_packed(qw, ql, tw, tl))
    _same(align.prefix_distance_packed(tq, ql, ttw, tl), ref.prefix_distance_packed(qw, ql, tw, tl))
    errs = np.array([(0, 2, INT32_MAX)[i % 3] for i in range(len(ql))], np.int32)
    _same(align.match_ends_packed(tq, ql, ttw, tl_short, errs), ref.match_ends_packed(qw, ql, tw, tl_short, errs))
    _same(align.peq_from_packed(tq, ql).view(torch.int32), np.asarray(ref.peq_from_packed(qw, ql)).view(np.int32))
    # the scans against the host DP oracles (independent of both packages' scans)
    for i, (q, t) in enumerate(zip(queries, texts)):
        if len(q):
            assert int(best[0][i]) == ref.best_match_reference(q, t)[0]
            assert (int(best[0][i]), int(best[1][i])) == align.best_match_reference(q, t)
            assert int(dist[i]) == native.edit_distance(q, t[: tl_short[i]])
        else:
            assert (int(best[0][i]), int(best[1][i])) == (0, 0) and int(dist[i]) == tl_short[i]


def test_ends_past_tlens_stay_clear_at_int32_max():
    """``max_errors == INT32_MAX`` admits every valid end and no column at
    or past ``tlens`` (the reference's round-5 fix)."""
    rng = np.random.default_rng(11)
    qw = _rows([bytes(rng.choice(ACGT, 20)) for _ in range(4)], native.n_to_bits, 2)
    tw = rng.integers(0, 2**32, (4, 3), dtype=np.uint32)
    ql = np.array([20, 20, 0, 20], np.int32)
    tl = np.array([48, 17, 30, 0], np.int32)
    errs = np.full(4, INT32_MAX, np.int32)
    got = align.match_ends_packed(torch.from_numpy(qw), ql, torch.from_numpy(tw), tl, errs)
    _same(got, ref.match_ends_packed(qw, ql, tw, tl, errs))
    assert got.shape == (4, 48) and got.sum(1).tolist() == [48, 17, 30, 0]


def test_peq_forms_with_broadcast_wildcard_queries():
    rng = np.random.default_rng(5)
    for query in (b"GANTACA", b"NNNN", b"acgtuN" * 6):
        peq, m = align.peq_from_bytes(query)
        want_peq, want_m = ref.peq_from_bytes(query)
        assert m == want_m and np.array_equal(peq, want_peq) and peq.dtype == want_peq.dtype
        texts = [_planted(rng, n, query.upper().replace(b"N", b"A"), ACGT) for n in (0, 31, 32, 33, 60, 64)]
        tw = _rows(texts, native.n_to_bits, 4)
        tl = np.array([len(t) for t in texts], np.int32)
        ql = np.full(len(texts), m, np.int32)
        expanded = torch.from_numpy(peq)[None].expand(len(texts), *peq.shape)  # stride 0, as the CLI passes it
        got = align.best_match_peq(expanded, ql, torch.from_numpy(tw), tl)
        _same(got, ref.best_match_peq(np.broadcast_to(peq, (len(texts),) + peq.shape), ql, tw, tl))
        for i, t in enumerate(texts):
            assert (int(got[0][i]), int(got[1][i])) == native.best_match(query, t) == align.best_match_reference(query, t)
        errs = np.array([0, 1, 2, INT32_MAX, 3, 0], np.int32)
        _same(align.match_ends_peq(expanded, ql, torch.from_numpy(tw), tl, errs),
              ref.match_ends_peq(np.broadcast_to(peq, (len(texts),) + peq.shape), ql, tw, tl, errs))


def test_long_query_past_the_register_blocks():
    """m = 300 (10 blocks: the kernel's scratch form) against 400-nt texts,
    held to the JAX package's host Myers scan (its device scan at 10 blocks
    takes XLA-CPU minutes to compile)."""
    rng = np.random.default_rng(300)
    query = bytes(rng.choice(ACGT, 300))
    peq, m = align.peq_from_bytes(query)
    texts = [_planted(rng, 400, query), bytes(rng.choice(ACGT, 400)), _planted(rng, 310, query)]
    tw = _rows(texts, native.n_to_bits, 25)
    tl, ql = np.array([400, 400, 310], np.int32), np.full(3, m, np.int32)
    got = align.best_match_peq(torch.from_numpy(np.ascontiguousarray(np.broadcast_to(peq, (3,) + peq.shape))), ql,
                               torch.from_numpy(tw), tl)
    dist = align.edit_distance_packed(torch.from_numpy(_rows([query] * 3, native.n_to_bits, 19)), ql,
                                      torch.from_numpy(tw), tl)
    for i, t in enumerate(texts):
        assert (int(got[0][i]), int(got[1][i])) == ref_native.best_match(query, t)
        assert int(dist[i]) == ref_native.edit_distance(query, t)


def _batch_b5(rng, wq_pairs: int, wt_pairs: int):
    ms = [m for m in SEAM_M if m <= 27 * wq_pairs] + [0]
    ns = (0, 26, 27, 28, 53, 54, 55)[: 1 + 3 * wt_pairs]
    queries, texts = [], []
    for k, m in enumerate(ms):
        for n in ns:
            q = bytes(rng.choice(ACGTN, m))
            queries.append(q)
            texts.append(_planted(rng, n, q, ACGTN) if m else bytes(rng.choice(ACGTN, n)))
    qw, tw = _rows(queries, native.n_to_bits2, 2 * wq_pairs), _rows(texts, native.n_to_bits2, 2 * wt_pairs)
    ql = np.array([len(q) for q in queries], np.int32)
    tl = np.array([len(t) for t in texts], np.int32)
    return qw, ql, tw, tl, queries, texts


def _corrupt(words: np.ndarray, rng, every: int) -> np.ndarray:
    """Set one triplet of every ``every``-th row to 125, 126 or 127."""
    out = words.copy()
    pairs = out.view(np.uint64)
    for r in range(0, out.shape[0], every):
        t = int(rng.integers(0, 9))
        pairs[r, int(rng.integers(0, pairs.shape[1]))] |= np.uint64(int(rng.integers(125, 128)) << (7 * t))
    return out


@pytest.mark.parametrize("wq_pairs", (1, 3))
def test_packed_b5_scans_match_reference(wq_pairs):
    rng = np.random.default_rng(50 + wq_pairs)
    qw, ql, tw, tl, queries, texts = _batch_b5(rng, wq_pairs, 3)
    for corrupt in (False, True):
        q_in, t_in = (_corrupt(qw, rng, 3), _corrupt(tw, rng, 2)) if corrupt else (qw, tw)
        tq, ttw = torch.from_numpy(q_in), torch.from_numpy(t_in)
        dist = align.edit_distance_packed_b5(tq, ql, ttw, tl)
        _same(dist, ref.edit_distance_packed_b5(q_in, ql, t_in, tl))
        best = align.best_match_packed_b5(tq, ql, ttw, tl)
        _same(best, ref.best_match_packed_b5(q_in, ql, t_in, tl))
        if not corrupt:
            for i, (q, t) in enumerate(zip(queries, texts)):
                if len(q):
                    assert (int(best[0][i]), int(best[1][i])) == align.best_match_reference_b5(q, t)
                    assert int(dist[i]) == align.edit_distance_reference_b5(q, t)
    # the digit unpack and the code Peq, corrupt digits included
    q_bad = _corrupt(qw, rng, 1)
    _same(align._unpack_digits_b5_t(torch.from_numpy(q_bad)).to(torch.int32),
          np.asarray(ref._unpack_digits_b5_t(q_bad)).astype(np.int32))
    digits = align._unpack_digits_b5_t(torch.from_numpy(q_bad)).T
    assert int(digits.max()) == 5
    _same(align._peq_from_codes(digits, ql, 5).view(torch.int32),
          np.asarray(ref._peq_from_codes(np.asarray(ref._unpack_digits_b5_t(q_bad)).T, ql, 5)).view(np.int32))


def test_b5_peq_form_wildcard_and_literal_n():
    rng = np.random.default_rng(9)
    for query in (b"GAT?ACAN", b"NNN", b"??A"):
        peq, m = align.peq_from_bytes_b5(query)
        want_peq, want_m = ref.peq_from_bytes_b5(query)
        assert m == want_m and np.array_equal(peq, want_peq)
        texts = [_planted(rng, n, query.replace(b"?", b"C"), ACGTN) for n in (0, 26, 27, 28, 54)]
        tw = _corrupt(_rows(texts, native.n_to_bits2, 4), rng, 2)
        tl = np.array([len(t) for t in texts], np.int32)
        ql = np.full(len(texts), m, np.int32)
        got = align.best_match_peq_b5(torch.from_numpy(peq)[None].expand(len(texts), *peq.shape), ql,
                                      torch.from_numpy(tw), tl)
        _same(got, ref.best_match_peq_b5(np.broadcast_to(peq, (len(texts),) + peq.shape), ql, tw, tl))


def test_corrupt_text_digit_reads_as_a_and_query_digit_matches_nothing():
    """Text triplet 125 = digits (0, 0, 5): the 5 selects plane 0, so a query
    'AAA' matches it exactly; a query word with triplet 125 has a digit 5
    that matches nothing, so against 'AAA' it costs one substitution."""
    word = np.array([[125, 0]], np.uint32)  # triplet 0 = 125, then 'A's
    peq, m = align.peq_from_bytes_b5(b"AAA")
    got = align.best_match_peq_b5(torch.from_numpy(peq)[None], [3], torch.from_numpy(word), [3])
    _same(got, ref.best_match_peq_b5(peq[None], np.array([3], np.int32), word, np.array([3], np.int32)))
    assert (int(got[0][0]), int(got[1][0])) == (0, 3)
    aaa = np.ascontiguousarray(native.n_to_bits2(b"AAA")).view(np.uint32)[None]
    got = align.edit_distance_packed_b5(torch.from_numpy(word), [3], torch.from_numpy(aaa), [3])
    _same(got, ref.edit_distance_packed_b5(word, np.array([3], np.int32), aaa, np.array([3], np.int32)))
    assert int(got[0]) == 1


@pytest.mark.parametrize("fn, msg", ((align.peq_from_bytes, "non-ACGTUN bytes: \\['X'\\]"),
                                     (align.peq_from_bytes_b5, "non-ACGTUN\\? bytes: \\['X'\\]")))
def test_peq_from_bytes_errors(fn, msg):
    ref_fn = getattr(ref, fn.__name__)
    for bad, pattern in ((b"", "empty query"), (b"ACXGT", msg), ("", "empty query")):
        with pytest.raises(ValueError, match=pattern):
            fn(bad)
        with pytest.raises(ValueError, match=pattern):
            ref_fn(bad)
    assert str(pytest.raises(ValueError, fn, b"A?Z").value) == str(pytest.raises(ValueError, ref_fn, b"A?Z").value)
    peq, m = fn("acgu")
    want, want_m = ref_fn("acgu")
    assert m == want_m and np.array_equal(peq, want)


def test_b5_odd_word_count_raises_as_the_reference():
    odd = np.zeros((2, 3), np.uint32)
    ql = tl = np.array([1, 1], np.int32)
    with pytest.raises(ValueError, match="even u32 count"):
        ref.best_match_packed_b5(np.zeros((2, 2), np.uint32), ql, odd, tl)
    with pytest.raises(ValueError, match="even u32 count"):
        align.best_match_packed_b5(torch.zeros((2, 2), dtype=torch.uint32), ql, torch.from_numpy(odd), tl)
    with pytest.raises(ValueError, match="even u32 count"):
        align._unpack_digits_b5_t(torch.from_numpy(odd))



#: query widths of the base-5 Peq build: 1, 2, 3 and 9 blocks
PEQ_B5_WQ = (2, 4, 6, 20)


def _peq_b5_cases(rng, wq: int) -> tuple[np.ndarray, np.ndarray]:
    """(qwords, qlens): each length at the block and word seams, at the
    words' rows, past them and negative, twice: packed ACGTN queries, then
    the same with a triplet 125-127 in every row; and two rows of random
    bits (bit 63 set, corrupt triplets where they fall)."""
    have = 27 * wq // 2
    lens = [0, 1, 26, 27, 31, 32, 33, 53, 54, have, have + 5, -3]
    clean = _rows([bytes(rng.choice(ACGTN, have)) for _ in lens], native.n_to_bits2, wq)
    q = np.concatenate([clean, _corrupt(clean, rng, 1), rng.integers(0, 2**32, (2, wq), dtype=np.uint32)])
    return q, np.array(lens * 2 + [have, 40], np.int32)


@pytest.mark.parametrize("wq", PEQ_B5_WQ + (3,))
def test_peq_b5_wrapper_matches_reference(wq):
    """``kernels.peq_b5`` on CPU tensors (its plain version) against the JAX
    package's ``_peq_from_codes(_unpack_digits_b5_t(q).T, qlens, 5)``: every
    row below min(qlen, 27 Wq / 2) in the plane of its digit, a corrupt
    triplet's digit 5 in none, rows past the words empty; an odd word count
    raises the reference's error."""
    rng = np.random.default_rng(70 + wq)
    if wq % 2:
        odd, ql = np.zeros((2, wq), np.uint32), np.array([1, 1], np.int32)
        want = pytest.raises(ValueError, ref._unpack_digits_b5_t, odd).value
        got = pytest.raises(ValueError, kernels.peq_b5, torch.from_numpy(odd), torch.from_numpy(ql)).value
        assert str(got) == str(want)
        return
    q, ql = _peq_b5_cases(rng, wq)
    got = kernels.peq_b5(torch.from_numpy(q), torch.from_numpy(ql))
    digits = np.asarray(ref._unpack_digits_b5_t(q)).T  # [B, 27 Wq / 2]
    want = np.asarray(ref._peq_from_codes(digits, ql, 5))
    assert got.shape == (len(q), 5, max(1, -(-digits.shape[1] // 32))) and got.dtype == torch.uint32
    assert np.array_equal(got.view(torch.int32).numpy(), want.view(np.int32))
    # each row counted in exactly the plane of its digit; digit 5 nowhere
    bits = (want[..., None] >> np.arange(32, dtype=np.uint32)) & 1  # [B, 5, NB, 32]
    planes = bits.reshape(len(q), 5, -1)[:, :, : digits.shape[1]]
    rows = np.arange(digits.shape[1]) < np.minimum(ql, digits.shape[1])[:, None]
    assert (digits == 5).any() and np.array_equal(planes.sum(1), rows & (digits < 5))
    assert kernels.peq_b5.launches == 0  # the CPU launches nothing


def test_b5_packed_takes_column_strided_queries():
    """Query words not contiguous within a row (every other column of a
    wider array, a transposed array) give the contiguous words' results."""
    rng = np.random.default_rng(75)
    q, ql = (torch.from_numpy(a) for a in _peq_b5_cases(rng, 4))
    tw = torch.from_numpy(rng.integers(0, 2**32, (len(q), 12), dtype=np.uint32))
    tl = torch.from_numpy(rng.integers(0, 163, len(q)).astype(np.int32))
    want = align.best_match_packed_b5(q, ql, tw, tl) + (align.edit_distance_packed_b5(q, ql, tw, tl),)
    wide = torch.zeros((len(q), 8), dtype=torch.uint32)
    wide[:, ::2] = q
    for v in (wide[:, ::2], q.T.contiguous().T):
        assert v.stride(1) != 1
        got = align.best_match_packed_b5(v, ql, tw, tl) + (align.edit_distance_packed_b5(v, ql, tw, tl),)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_align_cu_names_only_the_scan_myers():
    """The benchmark counts every device event whose name holds ``myers_``
    as #19: no kernel of ``csrc/align.cu`` but #19's forms (batch lanes,
    scratch, stream) may carry it."""
    import os
    import re

    src = open(os.path.join(os.path.dirname(kernels.__file__), "..", "csrc", "align.cu")).read()
    names = set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", src))
    assert {"myers_lanes", "myers_scratch", "myers_stream", "peq_b5_kernel"} <= names
    assert {n for n in names if "myers_" in n} == {"myers_lanes", "myers_scratch", "myers_stream"}


def test_scan_wrapper_refuses_bad_inputs():
    peq = torch.zeros((2, 4, 1), dtype=torch.uint32)
    lens = torch.zeros(2, dtype=torch.int32)
    words = torch.zeros(4, dtype=torch.uint32)
    with pytest.raises(ValueError, match="unknown mode"):
        kernels.myers_scan(peq, lens, words, lens, 2, 2, mode="local")
    with pytest.raises(ValueError, match="expected 5 Peq planes"):
        kernels.myers_scan(peq, lens, words, lens, 2, 2, mode="global", b5=True)
    with pytest.raises(ValueError, match="no ends mode"):
        kernels.myers_scan(torch.zeros((2, 5, 1), dtype=torch.uint32), lens, words, lens, 2, 2, mode="ends",
                           b5=True, max_errors=lens)
    with pytest.raises(TypeError, match="max_errors"):
        kernels.myers_scan(peq, lens, words, lens, 2, 2, mode="ends")
    with pytest.raises(TypeError, match="tlens"):
        kernels.myers_scan(peq, lens, words, lens.long(), 2, 2, mode="global")
    with pytest.raises(ValueError, match="do not cover"):
        kernels.myers_scan(peq, lens, words, lens, 1, 2, mode="global")
    assert kernels.myers_scan.launches == 0  # the CPU launches nothing


ORACLE_PAIRS = ((b"", b"ACGT"), (b"ACGT", b""), (b"A", b"A"), (b"GATTACA", b"GATACAGATTTACA"), (b"NNA", b"CCCT"),
                (b"acgu", b"ACGT"), (b"GANTACA", b"TTGACTACATT"), (b"ACGTACGTAC", b"TTTTTTTTTTTTTT"))
ORACLE_PAIRS_B5 = ((b"GATNACA", b"GATTACA"), (b"NNN", b"ACNNNT"), (b"ACG?T", b"TTACGCTAA"), (b"A", b""),
                   (b"ACGTN", b"acgun"), (b"N", b"A"))


def test_oracles_equal_reference():
    rng = np.random.default_rng(13)
    pairs = list(ORACLE_PAIRS) + [(bytes(rng.choice(ACGT, int(rng.integers(1, 40)))),
                                   bytes(rng.choice(ACGT, int(rng.integers(0, 70))))) for _ in range(8)]
    for q, t in pairs:
        assert align.edit_distance_reference(q, t) == ref.edit_distance_reference(q, t)
        assert align.best_match_reference(q, t) == ref.best_match_reference(q, t)
        if q:
            assert align.prefix_distance_reference(q, t) == ref.prefix_distance_reference(q, t)
            assert align.semiglobal_traceback(q, t) == ref.semiglobal_traceback(q, t)
            assert align.semiglobal_traceback(q.decode(), t) == ref.semiglobal_traceback(q.decode(), t)
    pairs5 = [p for p in ORACLE_PAIRS_B5 if b"?" not in p[0]] + [
        (bytes(rng.choice(ACGTN, int(rng.integers(1, 40)))), bytes(rng.choice(ACGTN, int(rng.integers(0, 70)))))
        for _ in range(8)]
    for q, t in pairs5:
        assert align.edit_distance_reference_b5(q, t) == ref.edit_distance_reference_b5(q, t)
        assert align.best_match_reference_b5(q, t) == ref.best_match_reference_b5(q, t)
    for q, t in ORACLE_PAIRS_B5 + tuple(pairs5):
        if q:
            assert align.semiglobal_traceback_b5(q, t) == ref.semiglobal_traceback_b5(q, t)


def test_exports_are_the_reference_names():
    assert align.__all__ == ref.__all__
    assert all(callable(getattr(align, name)) for name in align.__all__)
    assert align.ROWS_PER_BLOCK == ref.ROWS_PER_BLOCK
