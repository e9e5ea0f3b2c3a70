"""The port's base-5 packed-domain ops (``ops/seqops.py``: GC and N counts,
reverse complement, region slices and concatenation) against the JAX
package's: the same seeded words through both, exact equality, on valid
streams, on corrupt triplets 125..127 in every slot and on words with pad
bit 63 set; and the route of ``gc_content_packed_b5`` to kernel #7, held to
the reference's Pallas kernel (interpret mode)."""

import jax.numpy as jnp
import numpy as np
import pytest

from cute_nucleotides_tpu.ops import oracle
from cute_nucleotides_tpu.ops import seqops as ref
from cute_nucleotides_tpu_torch import interop
from cute_nucleotides_tpu_torch.ops import kernels, seqops

ALPHABET_N = np.frombuffer(b"ACGTUNacgtun", np.uint8)
COMP_N = bytes.maketrans(b"ACGTN", b"TGCAN")


def _seq(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).choice(ALPHABET_N, n)


def _enc(s: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(oracle.n_to_bits2_lut(s)).view(np.uint32)


def _norm(s: np.ndarray) -> np.ndarray:
    return oracle.bits_to_n2_lut(oracle.n_to_bits2_lut(s), len(s))


def _corrupt_words(seed: int, W: int) -> np.ndarray:
    """W random words of any triplet values 0..127, every slot of the first
    27 words holding one of 125..127, every third word with bit 63 set."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 128, (W, 9)).astype(np.uint64)
    for i in range(min(W, 27)):
        t[i, i % 9] = 125 + i // 9
    w = np.zeros(W, np.uint64)
    for j in range(9):
        w |= t[:, j] << np.uint64(7 * j)
    w[::3] |= np.uint64(1) << np.uint64(63)
    return w.view(np.uint32)


def _same(got, want) -> None:
    w, g = np.asarray(want), interop.to_numpy(got)
    assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w), (g[:6], w[:6])


def _t(a: np.ndarray):
    return interop.to_tensor(a)


@pytest.mark.parametrize("n", (1, 26, 27, 28, 54, 1000))
def test_counts_equal_reference_and_bytes(n):
    s = _seq(n, n)
    w = _enc(s)
    up = bytes(_norm(s))
    gc, nn = seqops.gc_content_packed_b5(_t(w)), seqops.n_count_packed_b5(_t(w))
    _same(gc, ref.gc_content_packed_b5(jnp.asarray(w)))
    _same(nn, ref.n_count_packed_b5(jnp.asarray(w)))
    assert int(gc) == sum(c in b"CG" for c in up) and int(nn) == up.count(b"N")


def test_counts_batched_equal_reference():
    batch = np.stack([_corrupt_words(i, 30) for i in range(4)])
    for fn, rfn in ((seqops.gc_content_packed_b5, ref.gc_content_packed_b5),
                    (seqops.n_count_packed_b5, ref.n_count_packed_b5)):
        _same(fn(_t(batch)), rfn(jnp.asarray(batch)))
        _same(fn(_t(batch[:, :0])), rfn(jnp.asarray(batch[:, :0])))


@pytest.mark.parametrize("W", (1, 27, 400))
def test_counts_on_corrupt_triplets_and_bit63(W):
    w = _corrupt_words(W, W)
    _same(seqops.gc_content_packed_b5(_t(w)), ref.gc_content_packed_b5(jnp.asarray(w)))
    _same(seqops.n_count_packed_b5(_t(w)), ref.n_count_packed_b5(jnp.asarray(w)))


def test_gc_formula_counts_corrupt_triplets():
    """t = 125, 126, 127 in every slot count 1, 2, 1 (the reference's
    formula; a decode reads t = 125 as 'AAN', GC 0); bit 63 counts nothing."""
    for t, want in ((125, 1), (126, 2), (127, 1)):
        for j in range(9):
            for b63 in (0, 1):
                w = np.array([(t << (7 * j)) | (b63 << 63)], np.uint64).view(np.uint32)
                assert int(seqops.gc_content_packed_b5(_t(w))) == want, (t, j, b63)
                assert int(kernels.gc_b5_stream_plain(_t(w))) == want


def test_gc_route_to_kernel_7(monkeypatch):
    """Flat, even and at least 1024 u32 calls kernels.gc_b5_stream; 513 nt
    (38 u32), a batch and an odd count do not; the routed count equals the
    reference's Pallas kernel (interpret mode) and the eager form."""
    calls = []
    real = kernels.gc_b5_stream

    def counting(words):
        calls.append(words.shape)
        return real(words)

    monkeypatch.setattr(kernels, "gc_b5_stream", counting)
    big = _corrupt_words(7, 1024)  # 27 * 1024 nt: 2048 u32
    got = seqops.gc_content_packed_b5(_t(big))
    assert calls == [(2048,)]
    _same(got, ref.gc_content_packed_b5(jnp.asarray(big)))
    _same(got, seqops.b5_word_gc(seqops._b5_words(_t(big))).sum().to(got.dtype))
    for w in (_enc(_seq(1, 513)), big[:1022], big.reshape(2, 1024)):
        seqops.gc_content_packed_b5(_t(w))
    assert calls == [(2048,)]
    seqops.gc_content_packed_b5(_t(big[:1024]))
    assert calls == [(2048,), (1024,)]
    with pytest.raises(ValueError, match="even"):
        seqops.gc_content_packed_b5(_t(big[:1025]))


@pytest.mark.parametrize("n", (1, 26, 27, 28, 53, 54, 55, 541))
def test_revcomp_packed_b5_equals_reference(n):
    s = _seq(n, n)
    w = _enc(s)
    got = seqops.revcomp_packed_b5(_t(w), n)
    _same(got, ref.revcomp_packed_b5(jnp.asarray(w), n))
    want = bytes(_norm(s)).translate(COMP_N)[::-1]
    _same(got, _enc(np.frombuffer(want, np.uint8)))


@pytest.mark.parametrize("slack", (1, 2, 5))
@pytest.mark.parametrize("n", (1, 53, 541))
def test_revcomp_packed_b5_slack_capacity(n, slack):
    """Trailing zero words (the reference's r05 fix): the same words as the
    reference's, the slack zero."""
    w = np.concatenate([_enc(_seq(n, n)), np.zeros(2 * slack, np.uint32)])
    _same(seqops.revcomp_packed_b5(_t(w), n), ref.revcomp_packed_b5(jnp.asarray(w), n))


@pytest.mark.parametrize("n", (1, 28, 27 * 30 - 1, 27 * 30))
def test_revcomp_packed_b5_on_corrupt_words(n):
    w = _corrupt_words(n, 30)
    _same(seqops.revcomp_packed_b5(_t(w), n), ref.revcomp_packed_b5(jnp.asarray(w), n))


SLICES = ((0, 27), (0, 10), (3, 30), (7, 26), (26, 29), (54, 27), (-4, 9), (95, 30), (-40, 20), (300, 4), (5, 0))


@pytest.mark.parametrize("start,n", SLICES)
def test_packed_slice_b5_equals_reference(start, n):
    s = _seq(200 + n, 100)
    w = _enc(s)
    got = seqops.packed_slice_b5(_t(w), start, n)
    _same(got, ref.packed_slice_b5(jnp.asarray(w), start, n))
    ext = np.full(500, ord("A"), np.uint8)
    ext[100:200] = _norm(s)
    _same(got, _enc(ext[100 + start : 100 + start + n]) if n else np.zeros(0, np.uint32))


@pytest.mark.parametrize("start,n", ((0, 27 * 4), (1, 31), (2, 55), (13, 3), (-7, 40), (100, 80)))
def test_packed_slice_b5_on_corrupt_words(start, n):
    w = _corrupt_words(start + 50, 12)
    _same(seqops.packed_slice_b5(_t(w), start, n), ref.packed_slice_b5(jnp.asarray(w), start, n))


@pytest.mark.parametrize("la,lb", ((0, 30), (27, 27), (13, 41), (28, 2), (1, 1), (14, 13)))
def test_packed_concat_b5_equals_reference(la, lb):
    sa, sb = _seq(la, la), _seq(lb + 3, lb)
    a, b = _enc(sa), _enc(sb)
    got = seqops.packed_concat_b5(_t(a), la, _t(b), lb)
    _same(got, ref.packed_concat_b5(jnp.asarray(a), la, jnp.asarray(b), lb))
    _same(got, _enc(np.concatenate([_norm(sa), _norm(sb)]).astype(np.uint8)))
    ca, cb = _corrupt_words(la, 3), _corrupt_words(lb + 9, 3)  # corrupt words, dirty tails
    _same(seqops.packed_concat_b5(_t(ca), la, _t(cb), lb), ref.packed_concat_b5(jnp.asarray(ca), la, jnp.asarray(cb), lb))


def test_slice_then_concat_round_trips_b5():
    n = 211
    w = _enc(_seq(9, n))
    for k in (0, 2, 27, 55, 200, n):
        left, right = seqops.packed_slice_b5(_t(w), 0, k), seqops.packed_slice_b5(_t(w), k, n - k)
        _same(seqops.packed_concat_b5(left, k, right, n - k), w)


def test_errors_equal_reference():
    w = np.zeros(4, np.uint32)
    cases = ((lambda m: m.revcomp_packed_b5, (w.reshape(2, 2), 27), TypeError),
             (lambda m: m.revcomp_packed_b5, (w[:3], 27), TypeError),
             (lambda m: m.revcomp_packed_b5, (w, 55), ValueError),
             (lambda m: m.packed_slice_b5, (w[:3], 0, 2), TypeError),
             (lambda m: m.packed_slice_b5, (w, 0, -1), ValueError),
             (lambda m: m.n_count_packed_b5, (w[:3],), ValueError),
             (lambda m: m.gc_content_packed_b5, (w.reshape(1, 4)[:, :3],), ValueError))
    for fn, args, exc in cases:
        with pytest.raises(exc) as want:
            fn(ref)(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args))
        with pytest.raises(exc) as got:
            fn(seqops)(*(_t(a) if isinstance(a, np.ndarray) else a for a in args))
        assert str(got.value) == str(want.value)
