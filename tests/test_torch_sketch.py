"""The port's k-mer hashes and MinHash sketches (``ops/kmer.py`` hashes,
``ops/sketch.py`` and the plain version of kernel #12) against the JAX
package's ``ops/kmer.py`` and ``ops/sketch.py``: the same seeded inputs
through both, exact equality (tolerance 0: hashes, sketches and counts are
integers, and Jaccard and containment are float32 quotients of two int32
counts, so they are bit-equal too).  The reference's Pallas kernels run in
interpret mode on the CPU, as ``tests/test_kmer.py`` runs them; each (shape,
k) compiles anew, so the cases stay few."""

import jax.numpy as jnp
import numpy as np
import pytest

from cute_nucleotides_tpu.ops import kmer as ref_kmer
from cute_nucleotides_tpu.ops import sketch as ref
from cute_nucleotides_tpu_torch import interop
from cute_nucleotides_tpu_torch.ops import kernels as K, kmer, sketch

SENTINEL = 0xFFFFFFFF


def _rand_u32(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 2**32, shape, dtype=np.uint32)


def _same(got, want) -> None:
    """Port output (tensor or tuple) == reference output, dtype and bits."""
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    w = np.asarray(want)
    g = interop.to_numpy(got)
    assert g.dtype == w.dtype and g.shape == w.shape
    assert np.array_equal(g, w)


# --- hashes ------------------------------------------------------------------


@pytest.mark.parametrize("k", list(range(16, 32)) + [1, 8, 15])
def test_kmer_hashes_equal_reference(k):
    """Both hash forms, whole arrays in their own order (position order,
    planar order with SENTINEL slots), canonical and forward."""
    length = 16 * 530 + 11  # a ragged last word and a second, partial row of 512 words
    flat = _rand_u32(100 + k, -(-length // 16))
    w, wt = jnp.asarray(flat), interop.to_tensor(flat)
    for canonical in (True, False):
        _same(kmer.kmer_hashes(wt, length, k, canonical=canonical),
              ref_kmer.kmer_hashes(w, length, k, canonical=canonical))
        _same(kmer.kmer_hashes_planar(wt, length, k, canonical=canonical),
              ref_kmer.kmer_hashes_planar(w, length, k, canonical=canonical))


@pytest.mark.parametrize("length,k", [(40, 31), (300, 8), (16 * 512, 21), (16 * 512 + 1, 16)])
def test_kmer_hashes_planar_short_and_seam_lengths(length, k):
    flat = _rand_u32(length, -(-length // 16))
    _same(kmer.kmer_hashes_planar(interop.to_tensor(flat), length, k),
          ref_kmer.kmer_hashes_planar(jnp.asarray(flat), length, k))


HASH_ERRORS = [
    (lambda m, w: m.kmer_hashes_planar(w, 100, 32), ValueError),
    (lambda m, w: m.kmer_hashes_planar(w, 100, 0), ValueError),
    (lambda m, w: m.kmer_hashes_planar(w, 20, 21), ValueError),
    (lambda m, w: m.kmer_hashes_planar(w, 10_000, 21), ValueError),
    (lambda m, w: m.kmer_hashes(w, 100, 32), ValueError),
    (lambda m, w: m.kmer_hashes(w, 10, 15), ValueError),
]


@pytest.mark.parametrize("i", range(len(HASH_ERRORS)))
def test_hash_errors_equal_reference(i):
    call, exc = HASH_ERRORS[i]
    flat = _rand_u32(9, 256)
    with pytest.raises(exc) as want:
        call(ref_kmer, jnp.asarray(flat))
    with pytest.raises(exc) as got:
        call(kmer, interop.to_tensor(flat))
    assert str(got.value) == str(want.value)


def test_hash_kernel_plain_version_segments_and_tail():
    """Plain version of #12: seg = Wr hashes each row of a batch as its own
    stream (= the gather hashes of each row), and n_valid sets the tail to
    SENTINEL."""
    B, Wr, k = 3, 40, 23
    batch = _rand_u32(31, (B, Wr))
    h = K.kmer_hashes_planar_pair(interop.to_tensor(batch).view(-1), k, B * Wr * 16, seg=Wr)
    assert h.shape == (1, 16 * 512)
    planar = interop.to_numpy(h).reshape(16, 512)[:, : B * Wr].T.reshape(B, Wr * 16)  # -> position order
    for b in range(B):
        want = np.asarray(ref_kmer.kmer_hashes(jnp.asarray(batch[b]), Wr * 16, k))
        assert np.array_equal(planar[b, : Wr * 16 - k + 1], want)
    cut = interop.to_numpy(K.kmer_hashes_planar_pair(interop.to_tensor(batch).view(-1), k, 700, seg=Wr))
    full, pos = interop.to_numpy(h), 16 * np.arange(512)[None, :] + np.arange(16)[:, None]
    assert (cut.reshape(16, 512)[pos >= 700] == SENTINEL).all()
    assert np.array_equal(cut.reshape(16, 512)[pos < 700], full.reshape(16, 512)[pos < 700])


def _unmix32(h: int) -> int:
    """The inverse of Murmur3 fmix32."""
    inv1, inv2 = pow(0x85EBCA6B, -1, 2**32), pow(0xC2B2AE35, -1, 2**32)
    h ^= h >> 16
    h = (h * inv2) % 2**32
    h ^= (h >> 13) ^ (h >> 26)
    h = (h * inv1) % 2**32
    return h ^ (h >> 16)


def _mix32(h: int) -> int:
    h ^= h >> 16
    h = (h * 0x85EBCA6B) % 2**32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) % 2**32
    return h ^ (h >> 16)


def _revcomp_code(code: int, k: int) -> int:
    return sum((((code >> (2 * j)) & 3) ^ 2) << (2 * (k - 1 - j)) for j in range(k))


def sentinel_kmer(k: int, canonical: bool = True) -> int:
    """A 2k-bit code, canonical where asked, whose hash is 0xFFFFFFFF: fmix32
    is invertible, so for k >= 16 lo follows from any hi (mix(lo ^ mix(hi)));
    for k <= 15 the code is the inverse of 0xFFFFFFFF itself, which fits 15
    nt but is not canonical."""
    if k <= 15:
        code = _unmix32(SENTINEL)
        assert code < 4**k and not canonical
        return code
    for hi in range(1 << min(2 * k - 32, 16)):
        code = (_unmix32(SENTINEL) ^ _mix32(hi)) | hi << 32
        if not canonical or code <= _revcomp_code(code, k):
            return code
    raise AssertionError("no canonical sentinel k-mer")


def _plant(words: np.ndarray, pos: int, code: int, k: int) -> None:
    """Write the 2k-bit code at nt ``pos`` of a flat u32 stream, in place."""
    q, s = divmod(pos, 16)
    v = int(words[q]) | int(words[q + 1]) << 32 | int(words[q + 2]) << 64
    mask = ((1 << (2 * k)) - 1) << (2 * s)
    v = (v & ~mask) | (code << (2 * s))
    for j in range(3):
        words[q + j] = (v >> (32 * j)) & 0xFFFFFFFF


@pytest.mark.parametrize("k,canonical", [(15, False), (16, True), (31, False)])
def test_sentinel_kmer_hashes_to_sentinel(k, canonical):
    flat = _rand_u32(5, 64)
    _plant(flat, 100, sentinel_kmer(k, canonical), k)
    h = np.asarray(ref_kmer.kmer_hashes(jnp.asarray(flat), 64 * 16, k, canonical=canonical))
    assert h[100] == SENTINEL
    got = kmer.kmer_hashes(interop.to_tensor(flat), 64 * 16, k, canonical=canonical)
    assert interop.to_numpy(got)[100] == SENTINEL


# --- sketches ------------------------------------------------------------------


def _sketch_inputs(kind: str, nt: int) -> np.ndarray:
    """u32 streams of ``nt`` nt, the last 90% of them: random, poly-A
    (whose hash is fmix32(0) = 0: it passes every cutoff and fills whole
    128-lane rows of the planar hashes, so the reference's prefilter
    capacity overflows), or a period-4 repeat (four k-mers whose hashes
    lie above the cutoff, so too few distinct hashes pass it)."""
    W = -(-nt // 16)
    flat = _rand_u32(nt, W)
    if kind == "poly-A":
        flat[W // 10 :] = 0
    elif kind == "ACGT repeat":
        flat[W // 10 :] = 0xE4E4E4E4  # A C T G = codes 0 1 2 3, repeated
    return flat


SKETCH_CASES = [("random", 21, 64), ("random", 9, 1000), ("poly-A", 21, 1000), ("ACGT repeat", 21, 1000),
                ("ACGT repeat", 15, 200), ("random", 25, 8192)]


@pytest.mark.parametrize("kind,k,s", SKETCH_CASES, ids=[f"{a}-k{b}-s{c}" for a, b, c in SKETCH_CASES])
def test_bottom_k_sketch_equals_reference(kind, k, s):
    nt = 16 * 9000 + 5  # 147,456 planar hashes: the reference's prefilter is on (>= 2**17)
    flat = _sketch_inputs(kind, nt)
    got = sketch.bottom_k_sketch(interop.to_tensor(flat), nt, k, s)
    _same(got, ref.bottom_k_sketch(jnp.asarray(flat), nt, k, s))


FRAC_CASES = [("random", 21, 64, 1 << 14), ("random", 9, 1, 1 << 17), ("poly-A", 21, 64, 4096),
              ("ACGT repeat", 15, 8, 64), ("random", 31, 1000, 8)]


@pytest.mark.parametrize("kind,k,scale,cap", FRAC_CASES, ids=[f"{a}-k{b}-x{c}-cap{d}" for a, b, c, d in FRAC_CASES])
def test_frac_sketch_equals_reference(kind, k, scale, cap):
    nt = 16 * 9000 + 5
    flat = _sketch_inputs(kind, nt)
    got = sketch.frac_sketch(interop.to_tensor(flat), nt, k, scale=scale, cap=cap)
    want = ref.frac_sketch(jnp.asarray(flat), nt, k, scale=scale, cap=cap)
    _same(got, want)


def test_prefilter_cases_reach_the_fallbacks():
    """The duplication-heavy inputs above do drive the reference off its
    prefilter's fast path: overflow (a 128-lane row past its capacity) and
    underflow (fewer than s distinct survivors)."""
    nt = 16 * 9000 + 5
    h = ref_kmer.kmer_hashes_planar(jnp.asarray(_sketch_inputs("poly-A", nt)), nt, 21)
    thresh = 2**32 // 64
    plan = ref._prefilter_plan(h.size, h.size * thresh / 2**32)
    assert plan is not None and not bool(ref._compact_lt(h, thresh, plan)[1])
    h = np.asarray(ref_kmer.kmer_hashes_planar(jnp.asarray(_sketch_inputs("ACGT repeat", nt)), nt, 21))
    c = int(np.ceil(ref._ALPHA * 1000 * 2**32 / h.size))
    assert ref._prefilter_plan(h.size, ref._ALPHA * 1000.0) is not None and np.unique(h[h < c]).size < 1000


def test_sketch_of_a_stream_shorter_than_k():
    flat = _rand_u32(1, 2)
    _same(sketch.bottom_k_sketch(interop.to_tensor(flat), 20, 21, 16), ref.bottom_k_sketch(jnp.asarray(flat), 20, 21, 16))
    _same(sketch.frac_sketch(interop.to_tensor(flat), 20, 21, scale=2, cap=16),
          ref.frac_sketch(jnp.asarray(flat), 20, 21, scale=2, cap=16))
    with pytest.raises(ValueError, match="scale must be >= 1"):
        sketch.frac_sketch(interop.to_tensor(flat), 32, 21, scale=0, cap=16)


def _batch(seed: int, B: int = 9, Wr: int = 37):
    rng = np.random.default_rng(seed)
    batch = _rand_u32(seed, (B, Wr))
    lengths = rng.integers(0, Wr * 16 + 1, B).astype(np.int32)
    lengths[:4] = (0, 20, Wr * 16, 5)  # empty, shorter than k, full, shorter than k
    invalid = rng.random((B, Wr * 16 - 7)) < 0.01  # byte masks narrower than the word capacity
    invalid[2, 100:140] = True  # an N run
    return batch, lengths, invalid


@pytest.mark.parametrize("k", (5, 15, 16, 21, 31))
@pytest.mark.parametrize("masked", (False, True))
def test_batch_sketches_equal_reference(k, masked):
    batch, lengths, invalid = _batch(k)
    inv = invalid if masked else None
    for canonical in (True, False):
        got = sketch.bottom_k_sketch_batch(interop.to_tensor(batch), lengths, k, 300, canonical=canonical,
                                           invalid=None if inv is None else interop.to_tensor(inv))
        want = ref.bottom_k_sketch_batch(jnp.asarray(batch), jnp.asarray(lengths), k, 300, canonical=canonical,
                                         invalid=None if inv is None else jnp.asarray(inv))
        _same(got, want)
    got = sketch.frac_sketch_batch(interop.to_tensor(batch), lengths, k, scale=3, cap=2000, invalid=inv)
    want = ref.frac_sketch_batch(jnp.asarray(batch), jnp.asarray(lengths), k, scale=3, cap=2000,
                                 invalid=None if inv is None else jnp.asarray(inv))
    _same(got, want)


def test_batch_sketch_edges():
    """A scalar length, a batch narrower than k, and a bad invalid mask."""
    batch, _, _ = _batch(3)
    _same(sketch.bottom_k_sketch_batch(interop.to_tensor(batch), 300, 21, 64),
          ref.bottom_k_sketch_batch(jnp.asarray(batch), 300, 21, 64))
    narrow = batch[:, :1]
    _same(sketch.bottom_k_sketch_batch(interop.to_tensor(narrow), 16, 21, 8),
          ref.bottom_k_sketch_batch(jnp.asarray(narrow), 16, 21, 8))
    bad = np.zeros((9, 37 * 16 + 1), bool)
    with pytest.raises(ValueError) as want:
        ref.bottom_k_sketch_batch(jnp.asarray(batch), 300, 21, 8, invalid=jnp.asarray(bad))
    with pytest.raises(ValueError) as got:
        sketch.bottom_k_sketch_batch(interop.to_tensor(batch), 300, 21, 8, invalid=bad)
    assert str(got.value) == str(want.value)
    with pytest.raises(TypeError):
        sketch.bottom_k_sketch_batch(interop.to_tensor(batch).view(-1), 300, 21, 8)
    for k in (0, 32):
        with pytest.raises(ValueError) as want:
            ref.bottom_k_sketch_batch(jnp.asarray(batch), 300, k, 8)
        with pytest.raises(ValueError) as got:
            sketch.bottom_k_sketch_batch(interop.to_tensor(batch), 300, k, 8)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("k,canonical", [(15, False), (16, True), (21, True), (31, True)])
def test_sentinel_kmer_gives_equal_batch_sketches(k, canonical):
    """A k-mer whose hash is 0xFFFFFFFF: the reference's gather form reports
    it as a hash, the port's planar form as padding; every sketch drops it,
    so both batch forms give the same sketches."""
    batch, lengths, _ = _batch(40 + k)
    row = batch[4].copy()
    _plant(row, 33, sentinel_kmer(k, canonical), k)
    batch[4] = row
    lengths[4] = 37 * 16
    gather = np.asarray(ref._batch_hashes(jnp.asarray(batch), jnp.asarray(lengths), k, canonical))
    kept = int(np.maximum(lengths - k + 1, 0).sum())
    assert (gather == SENTINEL).sum() == gather.size - kept + 1  # the planted hash
    args = (interop.to_tensor(batch), lengths, k), (jnp.asarray(batch), jnp.asarray(lengths), k)
    for s in (64, 8192):
        _same(sketch.bottom_k_sketch_batch(*args[0], s, canonical=canonical),
              ref.bottom_k_sketch_batch(*args[1], s, canonical=canonical))
    _same(sketch.frac_sketch_batch(*args[0], scale=1, cap=8192, canonical=canonical),
          ref.frac_sketch_batch(*args[1], scale=1, cap=8192, canonical=canonical))


# --- merging and estimators ----------------------------------------------------


@pytest.fixture(scope="module")
def ref_sketches():
    """Reference-made sketches of overlapping batches: bottom-s at s = 300
    and 8192 (fewer distinct hashes than s: SENTINEL tails), and one empty."""
    batch, lengths, _ = _batch(77, B=12, Wr=64)
    out = {}
    for s in (300, 8192):
        a = ref.bottom_k_sketch_batch(jnp.asarray(batch[:7]), jnp.asarray(lengths[:7]), 21, s)
        b = ref.bottom_k_sketch_batch(jnp.asarray(batch[4:]), jnp.asarray(lengths[4:]), 21, s)
        out[s] = (np.asarray(a), np.asarray(b), np.full(s, SENTINEL, np.uint32))
    return out


@pytest.mark.parametrize("s", (300, 8192))
def test_merge_and_estimators_equal_reference(ref_sketches, s):
    """JAX-made sketches (numpy u32[s] through interop.to_tensor) merged and
    compared in the port: the same sketches and bit-equal float32s."""
    a, b, empty = ref_sketches[s]
    pairs = [(a, b), (b, a), (a, a), (a, empty), (empty, empty)]
    for x, y in pairs:
        tx, ty, jx, jy = interop.to_tensor(x), interop.to_tensor(y), jnp.asarray(x), jnp.asarray(y)
        _same(sketch.merge(tx, ty), ref.merge(jx, jy))
        _same(sketch.jaccard(tx, ty), ref.jaccard(jx, jy))
        _same(sketch.containment(tx, ty), ref.containment(jx, jy))
        j = float(sketch.jaccard(tx, ty))
        assert sketch.mash_distance(j, 21) == ref.mash_distance(float(ref.jaccard(jx, jy)), 21)
    stacked = np.stack([a, b, empty])
    _same(sketch.merge_many(interop.to_tensor(stacked)), ref.merge_many(jnp.asarray(stacked)))
    _same(sketch.jaccard_matrix(interop.to_tensor(stacked)), ref.jaccard_matrix(jnp.asarray(stacked)))


def test_merge_errors_equal_reference(ref_sketches):
    a, _, _ = ref_sketches[300]
    for call in (lambda m, t: m.merge(t, t[:10]), lambda m, t: m.merge_many(t), lambda m, t: m.jaccard_matrix(t)):
        with pytest.raises(ValueError) as want:
            call(ref, jnp.asarray(a))
        with pytest.raises(ValueError) as got:
            call(sketch, interop.to_tensor(a))
        assert str(got.value) == str(want.value)


def test_mash_distance_equals_reference():
    for j in (0.0, -1.0, 1e-9, 0.01, 0.5, 0.999, 1.0):
        for k in (11, 21, 31):
            assert sketch.mash_distance(j, k) == ref.mash_distance(j, k)
    assert sketch.SENTINEL == int(ref.SENTINEL)
