"""The port's packed-domain search (``ops/search.py`` and the plain versions
of the two search kernels) against the JAX package's ``ops/search.py``: the
same seeded inputs through both, exact equality (integer bitmasks, boolean
masks, positions and counts).  The reference's Pallas scans run in interpret
mode on the CPU, as ``tests/test_search.py`` runs them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cute_nucleotides_tpu.ops import oracle, spec
from cute_nucleotides_tpu.ops import search as ref
from cute_nucleotides_tpu_torch import interop
from cute_nucleotides_tpu_torch.ops import eager, kernels as K, search

ACGT = np.frombuffer(b"ACGT", np.uint8)
ACGTN = np.frombuffer(b"ACGTN", np.uint8)


def _words(seq, codec: str = "2bit") -> np.ndarray:
    """Flat packed u32 stream of an ASCII sequence (the host oracle's words)."""
    seq = np.frombuffer(bytes(seq), np.uint8) if isinstance(seq, (bytes, bytearray)) else seq
    enc = oracle.n_to_bits_lut if codec == "2bit" else oracle.n_to_bits2_lut
    return spec.u64_to_u32_pairs(enc(seq)).reshape(-1)


def _both(w: np.ndarray):
    return jnp.asarray(w), interop.to_tensor(w)


def _seq(rng, n: int, alpha=ACGT, plant: bytes = b"", at=()) -> np.ndarray:
    s = rng.choice(alpha, size=n)
    for p in at:
        if 0 <= p <= n - len(plant):
            s[p : p + len(plant)] = np.frombuffer(plant, np.uint8)
    return s


def _naive(seq: np.ndarray, query: bytes, wildcard: bytes) -> np.ndarray:
    """Match positions by a byte scan of the normalized sequence."""
    s = bytes(seq).upper().replace(b"U", b"T")
    q = query.upper().replace(b"U", b"T")
    return np.asarray([i for i in range(len(s) - len(q) + 1)
                       if all(c == wildcard[0] or c == t for t, c in zip(s[i:], q))], dtype=np.int64)


def _ref_flat(bits, n_words: int) -> np.ndarray:
    """The reference's row-major bits, cut to the stream's words (its tail,
    past the stream, must be zero)."""
    flat = np.asarray(bits).reshape(-1)
    assert not flat[n_words:].any()
    return flat[:n_words]


def _np(t: torch.Tensor) -> np.ndarray:
    return interop.to_numpy(t)


# --- query compilers ---------------------------------------------------------------

QUERIES_2BIT = [b"ACGT" * 8 + b"NN", b"acgu", b"ANNT", b"N", b"GATTACA", b"A" * 33,
                b"ACGTN" * 28 + b"A", "GATtacaU", b"ACGT" * 256, b"ACGT" * 256 + b"C"]
QUERIES_B5 = [b"AC?N", b"acgu", b"A??T", b"?", b"NNC", b"TAN?GA", b"ACGTN" * 9,
              "gaT?acaU", b"ACGTN" * 204 + b"ACGT", b"ACGTN" * 205]


@pytest.mark.parametrize("query", QUERIES_2BIT)
def test_compile_query_equals_reference(query):
    q, care, m = search.compile_query(query)
    rq, rcare, rm = ref.compile_query(query)
    assert m == rm and q.dtype == care.dtype == np.uint32
    assert np.array_equal(q, rq) and np.array_equal(care, rcare)


@pytest.mark.parametrize("query", QUERIES_B5)
def test_compile_query_b5_equals_reference(query):
    got, want = search.compile_query_b5(query), ref.compile_query_b5(query)
    assert len(got) == 3
    for (q8, c8), (rq8, rc8) in zip(got, want):
        assert q8.dtype == c8.dtype == np.uint32
        assert np.array_equal(q8, rq8) and np.array_equal(c8, rc8)
    assert search._qc_host(query) == ref._qc_host(query)


@pytest.mark.parametrize("compiler,query", [
    ("compile_query", b""), ("compile_query", b"ACGX"), ("compile_query", b"AC?G"),
    ("compile_query", "acg1 "), ("compile_query_b5", b""), ("compile_query_b5", b"ACGX"),
    ("compile_query_b5", b"A*C-"),
])
def test_query_errors_word_for_word(compiler, query):
    with pytest.raises(ValueError) as got:
        getattr(search, compiler)(query)
    with pytest.raises(ValueError) as want:
        getattr(ref, compiler)(query)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("query", [b"AACGTN", b"acgu", b"GATTACA", "NNNN", b"T"])
def test_revcomp_query_equals_reference(query):
    assert search.revcomp_query(query) == ref.revcomp_query(query)


# --- 2-bit ------------------------------------------------------------------------------

@pytest.mark.parametrize("L,query", [
    (31, b"ACG"), (32, b"ANNT"), (33, b"GATTACA"), (33, b"N" * 33), (300, b"acgu"),
    (500, b"ACGTACGTACGTACGTA"),
])
def test_match_mask_equals_reference(L, query):
    s = _seq(np.random.default_rng(L), L, plant=query.upper().replace(b"N", b"A").replace(b"U", b"T"),
             at=(0, L // 3, L - len(query)))
    rw, tw = _both(_words(s))
    got = _np(search.match_mask(tw, L, query))
    assert got.dtype == np.bool_
    assert np.array_equal(got, np.asarray(ref.match_mask(rw, L, query)))
    assert np.array_equal(np.flatnonzero(got), _naive(s, query, b"N"))


@pytest.mark.parametrize("L,query", [
    (1, b"A"), (31, b"ACG"), (32, b"N"), (33, b"GATTACA"), (300, b"ACGT"), (9000, b"ANNNT"),
    (700, b"T" * 35), (4000, b"ACGTN" * 9), (2000, bytes(b"ACGT" * 36)[:141]),
])
def test_match_bits_count_positions_equal_reference(L, query):
    concrete = query.replace(b"N", b"C")
    s = _seq(np.random.default_rng(7 + L), L, plant=concrete, at=(0, 1, 16, L // 2, L - len(query)))
    rw, tw = _both(_words(s))
    bits = search.match_bits(tw, L, query)
    assert bits.dtype == torch.uint32 and bits.shape == (tw.shape[0],)
    assert np.array_equal(_np(bits), _ref_flat(ref.match_bits(rw, L, query), tw.shape[0]))
    count = search.match_count(tw, L, query)
    assert count.dtype == torch.int32 and count.shape == ()
    assert int(count) == int(ref.match_count(rw, L, query))
    got = search.match_positions(tw, L, query)
    assert got.dtype == np.int64
    assert np.array_equal(got, ref.match_positions(rw, L, query))
    assert np.array_equal(got, _naive(s, query, b"N"))


def test_match_bits_prefilter_fuzz():
    """Mirror of the reference's prefilter fuzz: random lengths across the
    single/multi-word boundary, N wildcards, planted hits, and a two-letter
    stream (dense anchor candidates); the kernel tier's plain version
    against the reference's mask tier."""
    rng = np.random.default_rng(1234)
    for trial in range(6):
        L = int(rng.integers(4000, 30000))
        s = rng.choice(ACGT[:2] if trial == 5 else ACGT, L)
        m = int(rng.integers(2, 200))
        q = bytearray(rng.choice(ACGT, m).tobytes())
        for i in sorted(rng.choice(m, size=min(m // 5, 8), replace=False)):
            q[i] = ord("N")
        q = bytes(q)
        planted = np.frombuffer(q.replace(b"N", b"C"), np.uint8)
        for p in (0, int(rng.integers(0, max(L - m, 1))), L - m):
            s[p : p + m] = planted
        rw, tw = _both(_words(s))
        want = np.flatnonzero(np.asarray(ref.match_mask(rw, L, q)))
        assert want.size >= 1
        assert np.array_equal(search.match_positions(tw, L, q), want), (trial, L, m)
        assert np.array_equal(np.flatnonzero(_np(search.match_mask(tw, L, q))), want)


def test_query_longer_than_8192_nt():
    """The reference takes any 2-bit query length (its halo then outgrows a
    row); the port's kernel tier does too."""
    rng = np.random.default_rng(5)
    L, m = 20000, 8200
    q = bytearray(rng.choice(ACGT, m).tobytes())
    q[::97] = b"N" * len(q[::97])
    q = bytes(q)
    s = _seq(rng, L, plant=q.replace(b"N", b"G"), at=(3, L - m))
    tw = interop.to_tensor(_words(s))
    want = _naive(s, q, b"N")
    assert want.tolist() == [3, L - m]
    assert np.array_equal(search.match_positions(tw, L, q), want)
    assert np.array_equal(np.flatnonzero(_np(search.match_mask(tw, L, q))), want)


def test_tail_padding_makes_no_hits():
    L = 40
    s = np.frombuffer(b"C" * (L - 3) + b"AAA", np.uint8)
    rw, tw = _both(_words(s))
    assert search.match_positions(tw, L, b"AAA").tolist() == [L - 3]
    assert int(search.match_count(tw, L, b"NNN")) == int(ref.match_count(rw, L, b"NNN")) == L - 2


# --- the 2-bit kernel's table and its plain version -----------------------------------------

_REP2 = 0x55555555


def _table(query: bytes) -> np.ndarray:
    return K._match_table(*search.compile_query(query)[:2])


def test_match_table_gattaca_by_hand():
    """GATTACA, worked out by hand: seven steps in word 0 at shifts 0..12,
    codes G = 3, A = 0, T = 2, C = 1 replicated into the 16 fields."""
    table = _table(b"GATTACA")
    assert table[:4].tolist() == [7, 7, 1, 0]
    codes = (3, 0, 2, 2, 0, 1, 0)
    assert table[4:].tolist() == [v for r, c in enumerate(codes) for v in (2 * r, c * _REP2)]


def test_match_table_n_loses_exactly_its_steps():
    """N at nt 15 and 16 (the last field of word 0, the first of word 1):
    exactly those two steps are gone, and nothing else changes."""
    full = b"ACGTACGTACGTACGTACGTA"
    holes = full[:15] + b"NN" + full[17:]
    steps = {tuple(p) for p in _table(full)[4:].reshape(-1, 2).tolist()}
    kept = {tuple(p) for p in _table(holes)[4:].reshape(-1, 2).tolist()}
    assert steps - kept == {(15 * 2, 2 * _REP2), (1 << 5 | 0, 0)}  # T at (0, 15), A at (1, 0)
    assert not kept - steps and _table(holes)[:4].tolist() == [15, 19, 2, 0]


@pytest.mark.parametrize("query,head,order", [
    (b"ACGTACGTACGTACGTA", [16, 17, 2, 0], [(0, r) for r in range(16)] + [(1, 0)]),
    (b"N" * 16 + b"G", [1, 1, 2, 1], [(1, 0)]),
    (b"N" * 15 + b"CG", [1, 2, 2, 0], [(0, 15), (1, 0)]),  # a tie: the first word anchors
    (b"NNNNANNNNNNNNNNNCG" + b"T" * 15, [16, 18, 3, 1], [(1, r) for r in range(16)] + [(0, 4), (2, 0)]),
])
def test_match_table_anchor_order(query, head, order):
    """The anchor word (most concrete nt, the first of equals) comes first,
    then the other words in order, each in nt order."""
    table = _table(query)
    assert table[:4].tolist() == head
    assert [(e >> 5, (e & 31) // 2) for e in table[4::2].tolist()] == order


@pytest.mark.parametrize("query", [b"GATTACA", b"N", b"N" * 40, b"ACGTN" * 28 + b"A", (b"ACGTACNGTT" * 5)[:45],
                                   b"ACGT" * 256 + b"C"])
def test_match_table_entries(query):
    """Every concrete nt of compile_query is in exactly one step with its
    replicated code, anchor word first; look is the last offset + 1."""
    q, care, m = search.compile_query(query)
    table = K._match_table(q, care)
    n_first, n_steps, look, anchor = table[:4].tolist()
    assert table.size == 4 + 2 * n_steps
    want = {(i // 16, i % 16): ((int(q[i // 16]) >> (2 * (i % 16))) & 3) * _REP2
            for i in range(m) if query[i : i + 1] not in (b"N", b"n")}
    got = {}
    for k, (e, c) in enumerate(table[4:].reshape(-1, 2).tolist()):
        a, r = e >> 5, (e & 31) // 2
        assert e & 1 == 0 and (a, r) not in got and (k < n_first) == (a == anchor)
        got[(a, r)] = c
    assert got == want
    assert look == max([a for a, _ in want] + [0]) + 1
    assert n_first == sum(1 for a, _ in want if a == anchor)


def test_match_table_refuses_partial_care():
    with pytest.raises(ValueError, match="0b11 or 0b00"):
        K._match_table(np.zeros(1, np.uint32), np.array([0b01], np.uint32))


def _plain_vs_reference(s: np.ndarray, query: bytes, L: int | None = None) -> np.ndarray:
    """Kernel #8's plain version on the ceil(s.size / 16) words of s, a
    stream of length L (default s.size), against the reference's packed
    bits (Pallas, interpret mode) and its mask; returns the mask."""
    L = s.size if L is None else L
    rw, tw = _both(_words(s)[: -(-s.size // 16)])
    q, care, m = search.compile_query(query)
    bits = K.match_bits_stream_plain(tw, q, care, L - m + 1)
    assert bits.dtype == torch.uint32 and bits.shape == (tw.shape[0],)
    assert np.array_equal(_np(bits), _ref_flat(ref.match_bits(rw, L, query), tw.shape[0]))
    mask = np.asarray(ref.match_mask(rw, L, query))
    assert np.array_equal(search._bit_positions(bits, spec.NT_PER_U32_2BIT), np.flatnonzero(mask))
    return mask


@pytest.mark.parametrize("m", range(1, 41))
def test_match_plain_every_query_length(m):
    """Every query length 1-40 with random Ns, planted at start slots 0, 9
    and 15 and at the last start, on a ragged 12-word stream."""
    rng = np.random.default_rng(200 + m)
    query = bytearray(rng.choice(ACGT, m).tobytes())
    for i in np.flatnonzero(rng.random(m) < 0.2):
        query[i] = ord("N")
    query = bytes(query)
    L = 16 * 11 + 9
    at = (0, 16 * 2 + 9, 16 * 5 + 15, L - m)
    mask = _plain_vs_reference(_seq(rng, L, plant=query.replace(b"N", b"T"), at=at), query)
    assert set(at) <= set(np.flatnonzero(mask).tolist())


@pytest.mark.parametrize("slot", range(16))
def test_match_plain_n_in_each_field_slot(slot):
    """A 32-nt query with N in field ``slot`` of word 0 and field 15 - slot
    of word 1, planted at start slots 0, slot and 15."""
    rng = np.random.default_rng(300 + slot)
    query = bytearray(rng.choice(ACGT, 32).tobytes())
    query[slot], query[16 + 15 - slot] = ord("N"), ord("N")
    query = bytes(query)
    at = (16, 16 * 4 + slot, 16 * 7 + 15)
    mask = _plain_vs_reference(_seq(rng, 16 * 10, plant=query.replace(b"N", b"G"), at=at), query)
    assert set(at) <= set(np.flatnonzero(mask).tolist())


@pytest.mark.parametrize("query", [b"N", b"N" * 16, b"N" * 17])
def test_match_plain_all_n_query(query):
    """A query of only Ns has no step: every start below n_starts matches."""
    L = 16 * 6 + 5
    mask = _plain_vs_reference(_seq(np.random.default_rng(len(query)), L), query)
    assert mask.all() and mask.size == L - len(query) + 1


@pytest.mark.parametrize("L", [15, 16, 17, 16 * 3, 16 * 4, 16 * 5 - 7, 16 * 511, 16 * 512 - 1, 16 * 513 - 9])
def test_match_plain_stream_edges(L):
    """Stream lengths around a word (15/16/17 nt) and W of 1, 3, 4, 5, 511,
    512 and 513 words (a thread's 4-word run, a block's 512 words): a
    7-nt query and a 20-nt one, planted at the last start."""
    rng = np.random.default_rng(L)
    for query in (b"GATNACA", b"ACGTTGCANNTGCAACGTAC"):
        if len(query) <= L:
            s = _seq(rng, L, plant=query.replace(b"N", b"C"), at=(0, L // 2, L - len(query)))
            assert _plain_vs_reference(s, query)[-1]


@pytest.mark.parametrize("last_word", [5, 6])
def test_match_plain_n_starts_mid_run(last_word):
    """n_starts ends inside a 4-word run (its last start in word 5 or 6 of
    the run 4..7), with hits planted on both sides of it."""
    m = 7
    n_starts = 16 * last_word + 9
    L = n_starts + m - 1
    rng = np.random.default_rng(last_word)
    query = b"GANTACA"
    s = _seq(rng, 16 * 8, plant=b"GATTACA", at=(n_starts + 7, n_starts - 1, n_starts - 10, 16 * 4))
    mask = _plain_vs_reference(s, query, L)
    assert mask.size == n_starts and mask[n_starts - 1] and mask[16 * 4]


# --- base-5 -------------------------------------------------------------------------------

@pytest.mark.parametrize("L,query", [
    (26, b"ACG"), (27, b"NN"), (28, b"A??T"), (301, b"GATTACA"), (301, b"TAN?GA"), (100, b"?"),
])
def test_match_mask_b5_equals_reference(L, query):
    s = _seq(np.random.default_rng(L), L, ACGTN, plant=query.replace(b"?", b"A"), at=(0, 1, 2, L - len(query)))
    rw, tw = _both(_words(s, "base5"))
    got = _np(search.match_mask_b5(tw, L, query))
    assert np.array_equal(got, np.asarray(ref.match_mask_b5(rw, L, query)))
    assert np.array_equal(np.flatnonzero(got), _naive(s, query, b"?"))


@pytest.mark.parametrize("L,query", [
    (27 * 80, b"A"), (13824 + 311, b"GATTACA"), (3000, b"??C??"), (2000, b"ACGTN" * 9),
    (2600, (b"ACGTN" * 29)[:141]),
])
def test_match_bits_b5_equals_reference(L, query):
    """Mirror of the reference's bits-vs-mask test: row seams, phases,
    wildcards, the anchor prefilter (45 and 141 nt) and ragged tails."""
    s = _seq(np.random.default_rng(L), L, ACGTN, plant=query.replace(b"?", b"A"),
             at=(0, 1, 2, 27, 13824 - len(query), L - len(query)))
    rw, tw = _both(_words(s, "base5"))
    bits = search.match_bits_b5(tw, L, query)
    assert bits.shape == (tw.shape[0] // 2,)
    assert np.array_equal(_np(bits), _ref_flat(ref.match_bits_b5(rw, L, query), tw.shape[0] // 2))
    want = np.flatnonzero(np.asarray(ref.match_mask_b5(rw, L, query)))
    assert np.array_equal(search.match_positions_b5(tw, L, query), want)
    assert int(search.match_count_b5(tw, L, query)) == want.size


@pytest.mark.parametrize("L", [26, 27, 28, 27 * 511, 27 * 512, 27 * 512 + 5])
def test_b5_routing_threshold_both_sides(L):
    """Counts and positions agree with the reference on both sides of the
    1024-u32 kernel threshold (1022 vs 1024 u32 at 27 * 511 / 27 * 512 nt)."""
    query = b"GAT?ACA"
    s = _seq(np.random.default_rng(L), L, ACGTN, plant=b"GATAACA", at=(5, L - 7))
    rw, tw = _both(_words(s, "base5"))
    assert search._use_b5_kernel(tw, query) == ref._use_b5_kernel(rw, query) == (tw.shape[0] >= 1024)
    want = ref.match_positions_b5(rw, L, query)
    assert np.array_equal(search.match_positions_b5(tw, L, query), want)
    assert int(search.match_count_b5(tw, L, query)) == int(ref.match_count_b5(rw, L, query)) == want.size


@pytest.mark.parametrize("m", [1024, 1025])
def test_b5_query_cap_1024_against_1025(m):
    """A 1024-nt query takes the kernel tier, a 1025-nt one the mask tier;
    both give the reference's mask."""
    rng = np.random.default_rng(m)
    q = bytes(rng.choice(ACGTN, m))
    L = 27 * 600
    s = _seq(rng, L, ACGTN, plant=q, at=(0, 4000, L - m))
    rw, tw = _both(_words(s, "base5"))
    assert search._use_b5_kernel(tw, q) == (m <= 1024)
    want = np.flatnonzero(np.asarray(ref.match_mask_b5(rw, L, q)))
    assert want.tolist() == [0, 4000, L - m]
    assert np.array_equal(search.match_positions_b5(tw, L, q), want)
    assert int(search.match_count_b5(tw, L, q)) == want.size
    if m > 1024:
        with pytest.raises(ValueError, match="caps queries at 1024"):
            search.match_bits_b5(tw, L, q)


def test_b5_corrupt_triplets_never_match_a_literal_n():
    """Triplets 125..127 split to a high digit of 5 in every tier of the
    reference's search, so a literal-N query does not match there.  The
    codec's clamped split (eager.b5_triplet_digits) would read 4 = N: the
    search must not use it."""
    t = np.arange(128, dtype=np.uint64)
    w64 = np.concatenate([(t << np.uint64(7 * j)) | (np.uint64(b) << np.uint64(63))
                          for j in range(9) for b in (0, 1)])
    w = np.ascontiguousarray(w64).view(np.uint32)
    rw, tw = _both(w)
    L = 27 * w64.size
    clamped = eager.b5_triplet_digits(torch.arange(125, 128))[:, 2]
    assert clamped.tolist() == [4, 4, 4]  # the trap: a clamped split reads N
    for query in (b"N", b"NN", b"?N", b"N?A", b"AAN", b"CAN"):
        mask = np.asarray(ref.match_mask_b5(rw, L, query))
        assert np.array_equal(_np(search.match_mask_b5(tw, L, query)), mask), query
        bits = _np(search.match_bits_b5(tw, L, query))
        assert np.array_equal(bits, _ref_flat(ref.match_bits_b5(rw, L, query), w64.size)), query
        assert np.array_equal(search.match_positions_b5(tw, L, query), np.flatnonzero(mask))
    # no start on the high digit of a corrupt triplet matches N
    hits = set(search.match_positions_b5(tw, L, b"N").tolist())
    corrupt = [27 * k + 3 * j + 2 for k, word in enumerate(w64.tolist())
               for j in range(9) if (word >> (7 * j)) & 0x7F >= 125]
    assert corrupt and not hits & set(corrupt)


# --- the base-5 kernel's table and its plain version ---------------------------------------

def _plain_positions(tw, n_starts: int, query: bytes) -> np.ndarray:
    """Start positions from the plain version of kernel #9 (bits 27..31 of
    every word must be zero)."""
    bits = K.match_b5_bits_stream_plain(tw, search.compile_query_b5(query), n_starts)
    assert not (_np(bits) >> 27).any()
    return search._bit_positions(bits, spec.NT_PER_WORD_B5)


#: plant starts (word, nt offset in the word): the three phases, and word
#: offsets 0, 8, 9 and 26, two words apart (queries up to 30 nt do not overlap)
B5_PLANTS = ((1, 0), (3, 1), (5, 2), (7, 8), (9, 9), (11, 26))


@pytest.mark.parametrize("m", range(1, 31))
def test_b5_plain_every_query_length(m):
    """Every query length 1-30, planted at each phase and at word offsets 0,
    8, 9 and 26, against the reference's mask (interpret mode)."""
    rng = np.random.default_rng(100 + m)
    query = bytearray(rng.choice(ACGTN, m).tobytes())
    if m >= 4:
        query[m // 2] = ord("?")
    query = bytes(query)
    L = 27 * 40 + 13
    s = _seq(rng, L, ACGTN, plant=query.replace(b"?", b"G"), at=[27 * w + o for w, o in B5_PLANTS] + [L - m])
    rw, tw = _both(_words(s, "base5"))
    want = np.flatnonzero(np.asarray(ref.match_mask_b5(rw, L, query)))
    assert {27 * w + o for w, o in B5_PLANTS} | {L - m} <= set(want.tolist())
    assert np.array_equal(_plain_positions(tw, L - m + 1, query), want)


@pytest.mark.parametrize("query", [b"?CGTTACA", b"A?GTTACA", b"AC?TTACA", b"??GTTACA", b"A??TTACA",
                                   b"?C?TTACA"])
def test_b5_plain_wildcard_in_each_slot(query):
    """'?' in each slot of a tap, alone (two digits of the triplet cared
    for) and in pairs (one), shifted through the three phases by the
    plants, against the reference's packed bits."""
    rng = np.random.default_rng(sum(query))
    L = 27 * 30
    s = _seq(rng, L, ACGT, plant=query.replace(b"?", b"T"), at=[27 * w + o for w, o in B5_PLANTS])
    rw, tw = _both(_words(s, "base5"))
    n = tw.shape[0] // 2
    bits = K.match_b5_bits_stream_plain(tw, search.compile_query_b5(query), L - len(query) + 1)
    assert np.array_equal(_np(bits), _ref_flat(ref.match_bits_b5(rw, L, query), n))


def test_b5_plain_1024_nt_query_reaches_the_lookahead():
    """A 1024-nt query: phase 2's last tap sits at triplet 341, 38 words past
    the start, so the table asks for the kernel's 39 lookahead words (of
    40); hits at the last start and at the last slot of a word."""
    rng = np.random.default_rng(1024)
    query = bytearray(rng.choice(ACGTN, 1024).tobytes())
    query[::97] = b"?" * len(query[::97])
    query = bytes(query)
    table, look = K._b5_table(search.compile_query_b5(query))
    assert look == 39
    L = 27 * 120 + 6
    last = L - 1024
    assert last % 3 == 2  # phase 2: the longest phase table
    s = _seq(rng, L, ACGTN, plant=query.replace(b"?", b"C"), at=(27 * 2 + 26, last))
    rw, tw = _both(_words(s, "base5"))
    want = np.flatnonzero(np.asarray(ref.match_mask_b5(rw, L, query)))
    assert want.tolist() == [27 * 2 + 26, last]
    assert np.array_equal(_plain_positions(tw, last + 1, query), want)


@pytest.mark.parametrize("bit63", [0, 1])
@pytest.mark.parametrize("query", [b"N", b"?N", b"CAN"])
def test_b5_plain_on_every_triplet(query, bit63):
    """All 128 triplet values in every slot, with bit 63 clear or set,
    against literal-N queries: a corrupt triplet's c digit is 5."""
    t = np.arange(128, dtype=np.uint64)
    w64 = np.concatenate([(t << np.uint64(7 * j)) | (np.uint64(bit63) << np.uint64(63)) for j in range(9)])
    rw, tw = _both(np.ascontiguousarray(w64).view(np.uint32))
    L = 27 * w64.size
    bits = K.match_b5_bits_stream_plain(tw, search.compile_query_b5(query), L - len(query) + 1)
    assert np.array_equal(_np(bits), _ref_flat(ref.match_bits_b5(rw, L, query), w64.size))


def test_b5_table_entries_by_hand():
    """GATTACA's first step, worked out by hand: offset 0; phase 0 cares
    for a, b, c (G A T = digits 3 0 2), phase 1 for b, c (G A), phase 2
    for c (G)."""
    table, look = K._b5_table(search.compile_query_b5(b"GATTACA"))
    assert table[:8].tolist() == [3, 3, 0, 0, 0, 0, 0, 0] and look == 2
    rep = 0x1249249
    assert table[8:20].tolist() == [0b100_110_111 << 5, 3 * rep, 0, 2 * rep, 0, 3 * rep, 0, 0, 0, 3 * rep, 0, 0]
    assert table[20:32].tolist() == [0x1FF << 5 | 3, 2 * rep, 0, rep, 2 * rep, 2 * rep, 0, 0, 2 * rep, 2 * rep, 0, 0]
    assert table[32:44].tolist() == [0b111_011_001 << 5 | 6, 0, 0, 0, rep, 0, 0, 0, rep, 0, 0, 0]


@pytest.mark.parametrize("query", [b"GATTACA", b"A", b"?", b"AC?N", b"N?" * 8, (b"ACGTACNGTT" * 5)[:45],
                                   bytes(np.random.default_rng(7).choice(ACGTN, 1024))])
def test_b5_table_entries(query):
    """Every cared-for (phase, offset, digit) of compile_query_b5 is in
    exactly one step, with its replicated digit; anchor taps (the
    reference's prefilter) in the first part, the rest after, each part in
    offset order; nothing else is set."""
    qc = search.compile_query_b5(query)
    table, look = K._b5_table(qc)
    n_first, n_steps = int(table[0]), int(table[1])
    assert not table[2:8].any() and table.size == 8 + 12 * n_steps
    anchors = K._b5_anchor_taps(qc)
    want = {(p, i, d): ((int(q8[i]) >> (3 * d)) & 7) * 0x1249249
            for p, (q8, care8) in enumerate(qc) for i in range(len(care8)) for d in range(3)
            if (int(care8[i]) >> (3 * d)) & 7}
    got, offsets = {}, ([], [])
    for k, row in enumerate(table[8:].reshape(n_steps, 12).tolist()):
        a, kinds, sh = row[0] >> 16, (row[0] >> 5) & 0x1FF, row[0] & 31
        assert (row[0] >> 14) & 3 == 0 and sh % 3 == 0 and sh < 27 and kinds and row[10:] == [0, 0]
        i, part = 9 * a + sh // 3, k >= n_first
        offsets[part].append(i)
        for p in range(3):
            for d in range(3):
                if kinds >> (3 * p + d) & 1:
                    assert (p, i, d) not in got
                    got[(p, i, d)] = row[1 + 3 * p + d]
                    assert part == (anchors is not None and i not in anchors[p])
                else:
                    assert row[1 + 3 * p + d] == 0
    assert got == want
    assert all(o == sorted(set(o)) for o in offsets)
    last = max([i for _, i, _ in want] + [0])
    assert look == -(-last // 9) + 1


# --- batches -------------------------------------------------------------------------------

@pytest.mark.parametrize("codec", ["2bit", "base5"])
def test_batch_forms_ragged(codec):
    """Batched masks and counts over ragged lengths (0, the full row, and
    random ones) equal the reference's; padding tails never match."""
    rng = np.random.default_rng(99)
    B, L = 7, 64 if codec == "2bit" else 54
    alpha = ACGT if codec == "2bit" else ACGTN
    query = b"GAT?ACA" if codec == "base5" else b"GANTACA"
    reads = rng.choice(alpha, size=(B, L))
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    lengths[0], lengths[1], lengths[2] = 0, L, len(query)
    rows = []
    for b in range(B):
        reads[b, lengths[b]:] = ord("A")
        if lengths[b] > len(query) + 2:
            reads[b, 1 : 1 + len(query)] = np.frombuffer(query.replace(b"?", b"C").replace(b"N", b"C"), np.uint8)
        rows.append(_words(reads[b], codec))
    rw, tw = _both(np.stack(rows))
    fn, rfn = ((search.match_mask_batch, ref.match_mask_batch) if codec == "2bit"
               else (search.match_mask_b5_batch, ref.match_mask_b5_batch))
    for lens in (lengths, interop.to_tensor(lengths)):
        got = _np(fn(tw, lens, query))
        assert np.array_equal(got, np.asarray(rfn(rw, jnp.asarray(lengths), query)))
        counts = search.match_counts_batch(tw, lens, query, codec=codec)
        assert counts.dtype == torch.int32
        assert np.array_equal(_np(counts), np.asarray(ref.match_counts_batch(rw, jnp.asarray(lengths), query,
                                                                             codec=codec)))
    assert _np(fn(tw, L, query)).sum() == np.asarray(rfn(rw, L, query)).sum()


# --- errors -------------------------------------------------------------------------------

_W2 = _words(b"ACGTACGT")
_W5 = _words(b"ACGTN" * 600, "base5")
ERROR_CASES = [
    ("match_mask", lambda w: (w, 8, b"ACGTACGTT")),
    ("match_mask", lambda w: (w, 8, b"")),
    ("match_bits", lambda w: (w, 999, b"ACG")),
    ("match_bits", lambda w: (w, 8, b"ACGX")),
    ("match_count", lambda w: (w, 999, b"ACG")),
    ("match_positions", lambda w: (w, 3, b"ACGT")),
    ("match_mask", lambda w: (w.reshape(2, -1), 8, b"ACG")),
    ("match_bits", lambda w: (w.reshape(2, -1), 8, b"ACG")),
    ("match_mask_batch", lambda w: (w, 8, b"ACG")),
    ("match_mask_batch", lambda w: (w.reshape(1, -1), 8, b"A" * 33)),
]
ERROR_CASES_B5 = [
    ("match_mask_b5", lambda w: (w, 3, b"ACGTN")),
    ("match_mask_b5", lambda w: (w, 20000, b"ACG")),
    ("match_mask_b5", lambda w: (w.reshape(2, -1), 20, b"ACG")),
    ("match_mask_b5", lambda w: (w[:3], 20, b"ACG")),
    ("match_mask_b5", lambda w: (w, 20, b"")),
    ("match_bits_b5", lambda w: (w, 3000, b"A" * 1025)),
    ("match_bits_b5", lambda w: (w, 3, b"ACGTN")),
    ("match_bits_b5", lambda w: (w, 20000, b"ACG")),
    ("match_bits_b5", lambda w: (w.reshape(2, -1), 20, b"ACG")),
    ("match_bits_b5", lambda w: (w[:3], 20, b"ACG")),
    ("match_bits_b5", lambda w: (w, 30, b"ACGZ")),
    ("match_count_b5", lambda w: (w, 3, b"ACGTN")),
    ("match_positions_b5", lambda w: (w, 20000, b"ACG")),
    ("match_mask_b5_batch", lambda w: (w[:6].reshape(2, 3), 20, b"ACG")),
    ("match_mask_b5_batch", lambda w: (w[:4].reshape(2, 2), 20, b"A" * 28)),
]


@pytest.mark.parametrize("name,args", ERROR_CASES + ERROR_CASES_B5,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(ERROR_CASES + ERROR_CASES_B5)])
def test_errors_equal_reference(name, args):
    w = _W5 if name.endswith(("_b5", "_b5_batch")) else _W2
    rw, tw = _both(w)
    with pytest.raises((TypeError, ValueError)) as got:
        getattr(search, name)(*args(tw))
    with pytest.raises((TypeError, ValueError)) as want:
        getattr(ref, name)(*args(rw))
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


def test_plain_versions_take_only_cpu_tensors():
    """On the CPU the wrappers run their plain versions; any device that is
    neither the CPU nor CUDA is refused, never computed on."""
    q, care, m = search.compile_query(b"GATTACA")
    qc = search.compile_query_b5(b"GAT?ACA")
    w = interop.to_tensor(_words(b"GATTACA" * 40))
    w5 = interop.to_tensor(_words(b"GATTACA" * 40, "base5"))
    K.reset_launch_counts()
    assert torch.equal(K.match_bits_stream(w, q, care, 280 - m + 1),
                       K.match_bits_stream_plain(w, q, care, 280 - m + 1))
    assert torch.equal(K.match_b5_bits_stream(w5, qc, 274), K.match_b5_bits_stream_plain(w5, qc, 274))
    assert [fn.launches for fn in K.WRAPPERS] == [0] * len(K.WRAPPERS)
    for call in (lambda: K.match_bits_stream(w.to("meta"), q, care, 10),
                 lambda: K.match_b5_bits_stream(w5.to("meta"), qc, 10),
                 lambda: search.match_bits(w.to("meta"), 280, b"GATTACA"),
                 lambda: search.match_positions_b5(torch.zeros(1024, dtype=torch.uint32, device="meta"),
                                                   100, b"ACG")):
        with pytest.raises(ValueError, match="no kernel for device meta"):
            call()
    with pytest.raises(TypeError):
        K.match_bits_stream(w.view(torch.int32), q, care, 10)
    with pytest.raises(ValueError, match="342 triplets"):
        K.match_b5_bits_stream(w5, search.compile_query_b5(b"A" * 1030), 10)
