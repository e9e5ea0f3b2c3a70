"""The port's minimizers (``kmer.minimizers``, ``kmer.minimizer_bits`` and
the plain version of kernel #14) against the JAX package's: the same seeded
streams through both, exact equality (tolerance 0: masks, hashes and bits
are integers).  The cases mirror ``tests/test_kmer.py``'s: the kernel route
(one row plus a ragged tail, two rows, k = 1, the w - 1 = 2048 - k
boundary), short streams on the windowed route, n <= w, and the route
predicate.  The reference's Pallas minimizer kernel runs in interpret mode
(seconds a call on the CPU, a minute at the widest window), so two routed
cases go through its public functions and the rest are held to its
windowed passes, as its own tests hold its kernel."""

import jax.numpy as jnp
import numpy as np
import pytest

from cute_nucleotides_tpu.ops import kmer as ref
from cute_nucleotides_tpu.ops import pallas_kernels as pk
from cute_nucleotides_tpu_torch import interop
from cute_nucleotides_tpu_torch.ops import kernels as K, kmer


def _stream(seed: int, length: int) -> np.ndarray:
    """A packed u32 stream of ``length`` random nt, zero past the last."""
    s = np.random.default_rng(seed).integers(0, 4, length)
    words = np.zeros(-(-length // 16), np.uint32)
    np.bitwise_or.at(words, np.arange(length) // 16, (s << (2 * (np.arange(length) % 16))).astype(np.uint32))
    return words


def _ref_windowed_mask(words, length, k, w, canonical):
    """The reference's windowed passes, bypassing its kernel route."""
    h = ref.kmer_hashes(jnp.asarray(words), length, k, canonical=canonical)
    n = h.shape[0]
    wm = ref._windowed(h, w - 1, jnp.minimum, jnp.uint32(0xFFFFFFFF), left=False)
    wm = jnp.where(jnp.arange(n) <= n - w, wm, 0)
    best = ref._windowed(wm, w - 1, jnp.maximum, jnp.uint32(0), left=True)
    return np.asarray(h == best), np.asarray(h)


def _pack(mask: np.ndarray) -> np.ndarray:
    n = mask.size
    full = np.zeros(-(-n // 16) * 16, bool)
    full[:n] = mask
    return (full.reshape(-1, 16).astype(np.uint32) << np.arange(16, dtype=np.uint32)).sum(1).astype(np.uint32)


ROUTED = [
    (16 * 1024 + 5, 15, 10, True),    # one kernel row and a ragged tail
    (16 * 2048, 15, 10, True),        # exactly two rows: the seam
    (16 * 1500, 7, 64, False),
    (16 * 1100 + 3, 15, 2033, True),  # w - 1 == 2048 - k, the route's limit
    (16 * 1024, 1, 5, True),          # k = 1
    (16 * 1030, 13, 2, True),         # w = 2, the smallest window
]


@pytest.mark.parametrize("L,k,w,canonical", ROUTED)
def test_kernel_route_equals_reference_windowed_form(L, k, w, canonical):
    words = _stream(L + k + w, L)
    assert kmer._route_minimizer_kernel(words.size, L - k + 1, k, w)
    mask, h = kmer.minimizers(interop.to_tensor(words), L, k, w, canonical=canonical)
    want_mask, want_h = _ref_windowed_mask(words, L, k, w, canonical)
    assert np.array_equal(interop.to_numpy(mask), want_mask)
    assert np.array_equal(interop.to_numpy(h), want_h)
    bits = kmer.minimizer_bits(interop.to_tensor(words), L, k, w, canonical=canonical)
    assert np.array_equal(interop.to_numpy(bits), _pack(want_mask))


@pytest.mark.parametrize("L,k,w,canonical", [ROUTED[0], ROUTED[2]])
def test_kernel_route_equals_reference_kernel(L, k, w, canonical):
    """Through the reference's public functions, its Pallas kernel in
    interpret mode."""
    words = _stream(L + k + w, L)
    got = kmer.minimizers(interop.to_tensor(words), L, k, w, canonical=canonical)
    want = ref.minimizers(jnp.asarray(words), L, k, w, canonical=canonical)
    for g, x in zip(got, want):
        assert np.array_equal(interop.to_numpy(g), np.asarray(x))
    got_bits = kmer.minimizer_bits(interop.to_tensor(words), L, k, w, canonical=canonical)
    want_bits = np.asarray(ref.minimizer_bits(jnp.asarray(words), L, k, w, canonical=canonical))
    assert interop.to_numpy(got_bits).dtype == want_bits.dtype and np.array_equal(interop.to_numpy(got_bits), want_bits)


WINDOWED = [(300, 5, 4, True), (300, 15, 10, False), (300, 21, 11, True), (5000, 15, 10, True),
            (16 * 1200, 16, 10, True), (16 * 1100, 15, 2040, True), (40, 31, 64, True), (40, 15, 26, True),
            (31, 31, 1, True), (2000, 9, 1, False)]


@pytest.mark.parametrize("L,k,w,canonical", WINDOWED)
def test_windowed_route_equals_reference(L, k, w, canonical):
    """Streams under 1024 words, k >= 16, w past the kernel's range, n <= w
    (the degenerate min) and w = 1: the reference's own route."""
    words = _stream(L * 7 + k, L)
    assert not kmer._route_minimizer_kernel(words.size, L - k + 1, k, w)
    got = kmer.minimizers(interop.to_tensor(words), L, k, w, canonical=canonical)
    want = ref.minimizers(jnp.asarray(words), L, k, w, canonical=canonical)
    for g, x in zip(got, want):
        assert np.array_equal(interop.to_numpy(g), np.asarray(x))
    _same_bits(kmer.minimizer_bits(interop.to_tensor(words), L, k, w, canonical=canonical),
               ref.minimizer_bits(jnp.asarray(words), L, k, w, canonical=canonical))


def _same_bits(got, want) -> None:
    want = np.asarray(want)
    got = interop.to_numpy(got)
    assert got.dtype == want.dtype and got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("L,k,w", [(16 * 1100, 15, 10), (5000, 11, 7)])
def test_poly_a_ties_select_every_position(L, k, w):
    """All hashes tie on a poly-A stream: every position is a minimizer."""
    words = np.zeros(-(-L // 16), np.uint32)
    mask, _ = kmer.minimizers(interop.to_tensor(words), L, k, w)
    want, _ = _ref_windowed_mask(words, L, k, w, True)
    assert np.array_equal(interop.to_numpy(mask), want) and want.all()
    _same_bits(kmer.minimizer_bits(interop.to_tensor(words), L, k, w), _pack(want))


def test_route_predicate_equals_reference():
    ov = 16 * pk.MZ_OV
    assert kmer.MZ_OV == pk.MZ_OV and kmer._MZ_THRESHOLD == ref._MZ_THRESHOLD
    cases = [(2048, 30000, 15, ov - 15 + 1), (2048, 30000, 15, ov - 15 + 2), (1023, 16000, 15, 10),
             (2048, 30000, 16, 10), (2048, 5, 15, 10), (1024, 1025, 1, 2), (1024, 1025, 1, 1), (4096, 11, 15, 10)]
    for c in cases:
        assert kmer._route_minimizer_kernel(*c) == ref._route_minimizer_kernel(*c), c


def test_plain_version_reads_zeros_past_the_stream():
    """Kernel #14's plain version takes n past the stream's last whole k-mer
    (the words read 0 there), and bits past n stay 0."""
    words = _stream(3, 16 * 40)
    n = 16 * 40 + 5  # 19 positions whose k-mers run past the stream
    bits = interop.to_numpy(K.minimizer_bits_stream(interop.to_tensor(words), n, 15, 10))
    padded = np.concatenate([words, np.zeros(2, np.uint32)])
    mask, _ = _ref_windowed_mask(padded, n + 14, 15, 10, True)
    assert np.array_equal(bits, _pack(mask))
    assert bits.shape == (-(-n // 16),) and (bits >> 16 == 0).all()


ERRORS = [
    (lambda m, w: m.minimizers(w, 40, 15, 0), ValueError),
    (lambda m, w: m.minimizers(w, 10, 15, 5), ValueError),
    (lambda m, w: m.minimizer_bits(w, 40, 15, 0), ValueError),
    (lambda m, w: m.minimizer_bits(w, 10, 15, 5), ValueError),
    (lambda m, w: m.minimizers(w, 40, 32, 5), ValueError),
]


@pytest.mark.parametrize("i", range(len(ERRORS)))
def test_errors_equal_reference(i):
    call, exc = ERRORS[i]
    words = _stream(9, 64)
    with pytest.raises(exc) as want:
        call(ref, jnp.asarray(words))
    with pytest.raises(exc) as got:
        call(kmer, interop.to_tensor(words))
    assert str(got.value) == str(want.value)


def test_kernel_wrapper_checks_its_arguments():
    w = interop.to_tensor(_stream(1, 64))
    with pytest.raises(ValueError, match="kernel minimizers cover k"):
        K.minimizer_bits_stream(w, 100, 16, 10)
    with pytest.raises(ValueError, match="window w out of kernel range"):
        K.minimizer_bits_stream(w, 100, 15, 2035)
    with pytest.raises(ValueError, match="window w out of kernel range"):
        K.minimizer_bits_stream(w, 100, 15, 1)
    with pytest.raises(TypeError, match="packed u32"):
        K.minimizer_bits_stream(w.view(2, -1), 100, 15, 10)
