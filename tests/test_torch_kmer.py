"""The port's k-mer path (``ops/kmer.py``, ``ops/sort.py`` and the plain
versions of kernels #10, #11 and #13) against the JAX package's
``ops/kmer.py`` and ``ops/sort.py``: the same seeded inputs through both,
exact equality (tolerance 0: every output is an integer).  The reference's
Pallas kernels run in interpret mode on the CPU, as ``tests/test_kmer.py``
runs them; each (shape, k) compiles anew, so the cases stay few."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cute_nucleotides_tpu.ops import kmer as ref
from cute_nucleotides_tpu.ops import sort as ref_sort
from cute_nucleotides_tpu_torch import interop
from cute_nucleotides_tpu_torch.ops import kernels as K, kmer, sort

ROWS, W = 3, 512


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


@pytest.fixture(scope="module")
def panels():
    return tuple(_rand_u32(s, (ROWS, W)) for s in (1, 2, 3))


@pytest.mark.parametrize("k", range(1, 16))
def test_kmer_codes_planar_equals_reference(panels, k):
    w, n, _ = panels
    got = kmer.kmer_codes_planar(interop.to_tensor(w), interop.to_tensor(n), k)
    _same(got, ref.kmer_codes_planar(jnp.asarray(w), jnp.asarray(n), k))
    _same(kmer.canonical_codes(got, k), ref.canonical_codes(jnp.asarray(interop.to_numpy(got)), k))


@pytest.mark.parametrize("k", range(16, 32))
def test_kmer_codes_planar_pair_equals_reference(panels, k):
    w, n, n2 = panels
    got = kmer.kmer_codes_planar_pair(*(interop.to_tensor(a) for a in panels), k)
    want = ref.kmer_codes_planar_pair(jnp.asarray(w), jnp.asarray(n), jnp.asarray(n2), k)
    _same(got, want)
    _same(kmer.canonical_codes_pair(*got, k), ref.canonical_codes_pair(*want, k))
    _same(kmer.revcomp_code_pair(*got, k), ref.revcomp_code_pair(*want, k))


@pytest.mark.parametrize("W_odd", (1, 511, 513))
def test_planar_plain_versions_at_any_width(W_odd):
    """The kernels take any W (the reference's panels are 128-lane
    multiples): the plain versions equal the gather codes of the stream the
    rows cut, column W s + w holding position 16 w + s."""
    flat = _rand_u32(W_odd, 2 * W_odd + 2)
    rows = [flat[: 2 * W_odd].reshape(2, W_odd), flat[1 : 2 * W_odd + 1].reshape(2, W_odd),
            flat[2:].reshape(2, W_odd)]
    w, n, n2 = (interop.to_tensor(np.ascontiguousarray(a)) for a in rows)
    length = 16 * (2 * W_odd + 2)
    pos = (16 * np.arange(2 * W_odd).reshape(2, 1, W_odd) + np.arange(16).reshape(1, 16, 1)).reshape(2, -1)
    for k in (3, 15):
        codes = np.asarray(ref.kmer_codes(jnp.asarray(flat), length, k))
        assert np.array_equal(interop.to_numpy(K.kmer_codes_planar(w, n, k)), codes[pos])
    for k in (16, 31):
        lo, hi = (np.asarray(a) for a in ref.kmer_codes_pair(jnp.asarray(flat), length, k))
        plo, phi = K.kmer_codes_planar_pair(w, n, n2, k)
        assert np.array_equal(interop.to_numpy(plo), lo[pos]) and np.array_equal(interop.to_numpy(phi), hi[pos])


HIST_CASES = {
    "random": lambda rng: rng.integers(0, 65536, (16, 512)),
    "masked": lambda rng: np.where(np.arange(512) < 143, rng.integers(0, 65536, (16, 512)), 0),
    "all 65535": lambda rng: np.full((8, 512), 65535),
    "out of range": lambda rng: rng.integers(-70000, 140000, (8, 512)),
}


@pytest.mark.parametrize("case", HIST_CASES)
def test_hist_codes_equals_reference(case):
    codes = HIST_CASES[case](np.random.default_rng(4)).astype(np.int32)
    _same(K.hist_codes(interop.to_tensor(codes)), ref._hist_mxu(jnp.asarray(codes)))


@pytest.mark.parametrize("k", (2, 8, 10))
@pytest.mark.parametrize("canonical", (False, True))
def test_kmer_histogram_equals_reference(k, canonical):
    flat = _rand_u32(k, 700)
    length = 700 * 16 - 5
    got = kmer.kmer_histogram(interop.to_tensor(flat), length, k, canonical=canonical)
    _same(got, ref.kmer_histogram(jnp.asarray(flat), length, k, canonical=canonical))
    assert int(got.sum()) == length - k + 1


@pytest.mark.parametrize("k", (3, 8, 11))
@pytest.mark.parametrize("canonical", (False, True))
def test_kmer_histogram_batch_equals_reference(k, canonical):
    rng = np.random.default_rng(k)
    batch = _rand_u32(10 + k, (9, 37))
    lengths = rng.integers(0, 37 * 16 + 1, 9).astype(np.int32)
    lengths[:3] = (0, k - 1, 37 * 16)  # empty, one short of k, full
    got = kmer.kmer_histogram_batch(interop.to_tensor(batch), lengths, k, canonical=canonical)
    _same(got, ref.kmer_histogram_batch(jnp.asarray(batch), jnp.asarray(lengths), k, canonical=canonical))
    assert int(got.sum()) == int(np.maximum(lengths - (k - 1), 0).sum())
    scalar = kmer.kmer_histogram_batch(interop.to_tensor(batch), 100, k, canonical=canonical)
    _same(scalar, ref.kmer_histogram_batch(jnp.asarray(batch), 100, k, canonical=canonical))


@pytest.mark.parametrize("k", (5, 15, 16, 21, 31))
@pytest.mark.parametrize("canonical", (False, True))
def test_kmer_counts_equals_reference(k, canonical):
    flat = _rand_u32(20 + k, 700)
    flat[100:200] = 0  # poly-A: long runs of one k-mer
    length = 700 * 16 - 5
    got = kmer.kmer_counts(interop.to_tensor(flat), length, k, canonical=canonical)
    _same(got, ref.kmer_counts(jnp.asarray(flat), length, k, canonical=canonical))
    assert int(got[2].sum()) == length - k + 1


@pytest.mark.parametrize("length", (31, 100, 16 * 512 - 1))
def test_kmer_counts_short_stream(length):
    """Streams shorter than one row of 512 words: the sentinel block holds
    most of the padded length."""
    flat = _rand_u32(length, -(-length // 16))
    for k in (5, 21):
        got = kmer.kmer_counts(interop.to_tensor(flat), length, k, canonical=True)
        _same(got, ref.kmer_counts(jnp.asarray(flat), length, k, canonical=True))


def test_gather_codes_equal_reference():
    flat = _rand_u32(5, 70)
    for k in (1, 8, 15):
        _same(kmer.kmer_codes(interop.to_tensor(flat), 70 * 16 - 3, k), ref.kmer_codes(jnp.asarray(flat), 70 * 16 - 3, k))
        codes = kmer.kmer_codes(interop.to_tensor(flat), 1000, k)
        _same(kmer.revcomp_code(codes, k), ref.revcomp_code(jnp.asarray(interop.to_numpy(codes)), k))
    for k in (16, 23, 31):
        _same(kmer.kmer_codes_pair(interop.to_tensor(flat), 70 * 16, k), ref.kmer_codes_pair(jnp.asarray(flat), 70 * 16, k))


def test_sort_pairs_equals_reference():
    rng = np.random.default_rng(6)
    hi, lo = _rand_u32(7, 5000), _rand_u32(8, 5000)
    hi[:300] = 0xFFFFFFFF  # the sentinel pair, and keys with the top bit set
    lo[:150] = 0xFFFFFFFF
    hi[300:600] = rng.integers(0, 4, 300)  # ties on hi
    _same(sort.sort_pairs(interop.to_tensor(hi), interop.to_tensor(lo)),
          ref_sort.sort_pairs(jnp.asarray(hi), jnp.asarray(lo)))


ERRORS = [
    (lambda m, w: m.kmer_codes(w, 100, 16), ValueError),
    (lambda m, w: m.kmer_codes(w, 3, 5), ValueError),
    (lambda m, w: m.kmer_codes(w, 10_000, 5), ValueError),
    (lambda m, w: m.kmer_codes(w.reshape(2, -1), 100, 5), TypeError),
    (lambda m, w: m.kmer_codes_pair(w, 100, 15), ValueError),
    (lambda m, w: m.kmer_histogram(w, 100, 13), ValueError),
    (lambda m, w: m.kmer_histogram(w, 100, 0), ValueError),
    (lambda m, w: m.kmer_histogram(w, 10_000, 4), ValueError),
    (lambda m, w: m.kmer_histogram_batch(w.reshape(2, -1), 100, 13), ValueError),
    (lambda m, w: m.kmer_histogram_batch(w, 100, 4), TypeError),
    (lambda m, w: m.kmer_counts(w, 100, 32), ValueError),
    (lambda m, w: m.kmer_counts(w, 20, 21), ValueError),
    (lambda m, w: m.kmer_counts(w, 10_000, 21), ValueError),
    (lambda m, w: m.revcomp_code_pair(w, w, 15), ValueError),
    (lambda m, w: m.kmer_codes_planar_pair(w.reshape(2, -1), w.reshape(2, -1), w.reshape(2, -1), 15), ValueError),
    (lambda m, w: m.kmer_codes_planar(w.reshape(4, -1), w.reshape(4, -1), 5), TypeError),
]


@pytest.mark.parametrize("i", range(len(ERRORS)))
def test_errors_equal_reference(i):
    call, exc = ERRORS[i]
    flat = _rand_u32(9, 256)
    with pytest.raises(exc) as want:
        call(ref, jnp.asarray(flat))
    with pytest.raises(exc) as got:
        call(kmer, interop.to_tensor(flat))
    assert str(got.value) == str(want.value)


def test_kernel_wrappers_check_their_inputs():
    w = interop.to_tensor(_rand_u32(1, (2, 8)))
    with pytest.raises(ValueError, match="k must be in"):
        K.kmer_codes_planar(w, w, 16)
    with pytest.raises(ValueError, match="k must be in"):
        K.kmer_codes_planar_pair(w, w, w, 15)
    with pytest.raises(TypeError, match="successor"):
        K.kmer_codes_planar(w, w[:1], 5)
    with pytest.raises(TypeError, match="codes"):
        K.hist_codes(w)
    assert torch.equal(K.hist_codes(torch.zeros((0, 4), dtype=torch.int32)), torch.zeros((256, 256), dtype=torch.int32))
