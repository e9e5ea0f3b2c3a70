"""The port's 2-bit packed-domain ops (``ops/seqops.py``: complement,
reverse complement, byte GC count, region slices and concatenation) against
the JAX package's ``ops/seqops.py``: the same seeded words through both,
exact equality, and the same errors word for word."""

import jax.numpy as jnp
import numpy as np
import pytest

from cute_nucleotides_tpu.ops import oracle
from cute_nucleotides_tpu.ops import seqops as ref
from cute_nucleotides_tpu_torch import interop
from cute_nucleotides_tpu_torch.ops import seqops

ALPHABET = np.frombuffer(b"ACGTUacgtu", np.uint8)
COMP = bytes.maketrans(b"ACGT", b"TGCA")


def _seq(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).choice(ALPHABET, n)


def _enc(s: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(oracle.n_to_bits_lut(s)).view(np.uint32)


def _norm(s: np.ndarray) -> np.ndarray:
    return oracle.bits_to_n_lut(oracle.n_to_bits_lut(s), len(s))


def _words(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint32)


def _same(got, want) -> None:
    w, g = np.asarray(want), interop.to_numpy(got)
    assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w), (g[:6], w[:6])


def _t(a: np.ndarray):
    return interop.to_tensor(a)


@pytest.mark.parametrize("n", (0, 1, 15, 16, 17, 31, 32, 33, 1000))
def test_revcomp_packed_equals_reference(n):
    s = _seq(n, n)
    w = _enc(s)
    got = seqops.revcomp_packed(_t(w), n)
    _same(got, ref.revcomp_packed(jnp.asarray(w), n))
    want = bytes(_norm(s)).translate(COMP)[::-1]
    _same(got, _enc(np.frombuffer(want, np.uint8)))


@pytest.mark.parametrize("length", (0, 1, 100, 155, 160))
def test_revcomp_packed_ignores_dirty_tail_bits(length):
    """Random words: only the first ``length`` nt count, the tail re-zeroes."""
    w = _words(length, 10)
    _same(seqops.revcomp_packed(_t(w), length), ref.revcomp_packed(jnp.asarray(w), length))


def test_complement_packed_equals_reference_and_is_an_involution():
    w = _words(3, 77)
    got = seqops.complement_packed(_t(w))
    _same(got, ref.complement_packed(jnp.asarray(w)))
    _same(seqops.complement_packed(got), w)


@pytest.mark.parametrize("shape", ((77,), (3, 77), (2, 0)))
def test_gc_content_bytes_equals_reference(shape):
    x = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    _same(seqops.gc_content_bytes(_t(x)), ref.gc_content_bytes(jnp.asarray(x)))


SLICES = ((0, 16), (0, 7), (5, 20), (16, 16), (31, 3), (33, 40), (-5, 12), (90, 20), (-40, 30), (200, 5), (3, 0))


@pytest.mark.parametrize("start,n", SLICES)
def test_packed_slice_equals_reference(start, n):
    """The reference's cases (test_seqops.py), a window wholly before and one
    wholly past the stream: the reference's output, and the encoding of the
    'A'-extended window of the bytes."""
    s = _seq(100 + n, 100)
    w = _enc(s)
    got = seqops.packed_slice(_t(w), start, n)
    _same(got, ref.packed_slice(jnp.asarray(w), start, n))
    ext = np.full(400, ord("A"), np.uint8)
    ext[100:200] = _norm(s)
    want = _enc(ext[100 + start : 100 + start + n]) if n else np.zeros(0, np.uint32)
    _same(got, want)


def test_packed_slice_fuzz_on_random_words():
    rng = np.random.default_rng(11)
    for _ in range(20):
        W = int(rng.integers(0, 10))
        start, n = int(rng.integers(-35, 16 * W + 35)), int(rng.integers(0, 70))
        w = _words(int(rng.integers(1 << 30)), W)
        _same(seqops.packed_slice(_t(w), start, n), ref.packed_slice(jnp.asarray(w), start, n))


@pytest.mark.parametrize("la,lb", ((0, 40), (40, 0), (32, 32), (17, 45), (3, 1), (0, 0)))
def test_packed_concat_equals_reference(la, lb):
    """Dirty bits past either length do not leak."""
    a, b = _words(la, max(1, -(-la // 16))), _words(100 + lb, max(1, -(-lb // 16)))
    got = seqops.packed_concat(_t(a), la, _t(b), lb)
    _same(got, ref.packed_concat(jnp.asarray(a), la, jnp.asarray(b), lb))
    sa, sb = _seq(la, la), _seq(lb + 7, lb)
    joined = seqops.packed_concat(_t(_enc(sa)), la, _t(_enc(sb)), lb)
    want = _enc(np.concatenate([_norm(sa), _norm(sb)]).astype(np.uint8))
    _same(joined, want if la + lb else np.zeros(0, np.uint32))


def test_slice_then_concat_round_trips():
    n = 211
    w = _enc(_seq(5, n))
    for k in (0, 1, 16, 33, 100, n):
        left, right = seqops.packed_slice(_t(w), 0, k), seqops.packed_slice(_t(w), k, n - k)
        _same(seqops.packed_concat(left, k, right, n - k), w)


def _raises_like(port_call, ref_call, exc):
    with pytest.raises(exc) as want:
        ref_call()
    with pytest.raises(exc) as got:
        port_call()
    assert str(got.value) == str(want.value)


def test_errors_equal_reference():
    w = _words(1, 4)
    flat, rows = (_t(w), jnp.asarray(w)), (_t(w.reshape(2, 2)), jnp.asarray(w.reshape(2, 2)))
    _raises_like(lambda: seqops.revcomp_packed(rows[0], 3), lambda: ref.revcomp_packed(rows[1], 3), TypeError)
    _raises_like(lambda: seqops.revcomp_packed(flat[0], 65), lambda: ref.revcomp_packed(flat[1], 65), ValueError)
    _raises_like(lambda: seqops.packed_slice(rows[0], 0, 3), lambda: ref.packed_slice(rows[1], 0, 3), TypeError)
    _raises_like(lambda: seqops.packed_slice(flat[0], 0, -1), lambda: ref.packed_slice(flat[1], 0, -1), ValueError)
    _raises_like(lambda: seqops.packed_concat(rows[0], 3, flat[0], 3),
                 lambda: ref.packed_concat(rows[1], 3, flat[1], 3), TypeError)
