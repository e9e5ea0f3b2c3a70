"""The port's ``sort_pairs`` (``ops/sort.py``) with ``prefer`` "lax" and
"bitonic" against ``np.lexsort`` and the JAX package's ``sort_pairs``
(whose bitonic route runs its Pallas kernels in interpret mode here), and
the plain radix passes alone (kernel #18's CPU route)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cute_nucleotides_tpu.ops import sort as ref
from cute_nucleotides_tpu_torch import interop
from cute_nucleotides_tpu_torch.ops import kernels, sort


def _pairs(seed: int, n: int):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
            rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32))


def _lexsorted(hi, lo):
    order = np.lexsort((lo, hi))
    return hi[order], lo[order]


def _check(hi, lo, prefers=("lax", "bitonic")):
    want = _lexsorted(hi, lo)
    for prefer in prefers:
        got = sort.sort_pairs(interop.to_tensor(hi), interop.to_tensor(lo), prefer=prefer)
        for g, w in zip(got, want):
            g = interop.to_numpy(g)
            assert g.dtype == np.uint32 and np.array_equal(g, w), prefer


def test_constants_equal_reference():
    assert sort.BITONIC_COLS == ref.BITONIC_COLS
    assert sort.BITONIC_MAX_N == 1 << 28 and sort.BITONIC_MAX_N >= ref.BITONIC_MAX_N


@pytest.mark.parametrize("n", (1, 17, 4095, 4096, 8192 + 37, 16383))
def test_sort_pairs_matches_lexsort(n):
    _check(*_pairs(n, n))


@pytest.mark.parametrize("n", (17, 4096))
@pytest.mark.parametrize("prefer", ("lax", "bitonic"))
def test_sort_pairs_equals_reference(n, prefer):
    hi, lo = _pairs(n + 1, n)
    got = sort.sort_pairs(interop.to_tensor(hi), interop.to_tensor(lo), prefer=prefer)
    want = ref.sort_pairs(jnp.asarray(hi), jnp.asarray(lo), prefer=prefer)
    for g, w in zip(got, want):
        assert np.array_equal(interop.to_numpy(g), np.asarray(w))


def test_routes_follow_the_reference_envelope(monkeypatch):
    """prefer="bitonic" takes the network for padded n in [4096, 2^28] only;
    prefer="lax" never."""
    calls = []
    real = kernels.sort_pairs_bitonic
    monkeypatch.setattr(kernels, "sort_pairs_bitonic", lambda hi, lo: calls.append(hi.numel()) or real(hi, lo))
    for n in (1, 2048, 2049, 4096, 5000):
        hi, lo = _pairs(n, n)
        sort.sort_pairs(interop.to_tensor(hi), interop.to_tensor(lo), prefer="bitonic")
        sort.sort_pairs(interop.to_tensor(hi), interop.to_tensor(lo))
    assert calls == [2049, 4096, 5000]


def test_kmer_shaped_keys_with_sentinels():
    """kmer_counts' keys: a small hi (2k - 32 bits), heavy lo duplication, and
    trailing (0xFFFFFFFF, 0xFFFFFFFF) sentinel pairs, which sort last."""
    rng = np.random.default_rng(21)
    n = 8 * 1024 + 37
    hi = rng.integers(0, 1 << 10, n, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 5000, n, dtype=np.uint64).astype(np.uint32)
    hi[-1500:] = lo[-1500:] = 0xFFFFFFFF
    _check(hi, lo)


def test_adversarial_orders():
    """The reference's cases (test_sort.py): descending, ties on hi, all
    equal, and values straddling the int32 sign bit."""
    n = 4 * 1024
    asc = np.arange(n, dtype=np.uint32)
    _check(asc[::-1].copy(), asc.copy())
    _check(np.zeros(n, np.uint32), asc[::-1].copy())
    _check(np.full(n, 7, np.uint32), np.full(n, 3, np.uint32))
    rng = np.random.default_rng(5)
    hi = rng.integers(2**31 - 4, 2**31 + 4, n, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    _check(hi, lo)
    lo[:] = rng.integers(2**31 - 4, 2**31 + 4, n, dtype=np.uint64).astype(np.uint32)
    _check(hi, lo)


def _key_sets(n: int) -> dict:
    """The key shapes the radix passes must order: random, kmer_counts'
    keys with trailing sentinels, values straddling the int32 sign bit, all
    equal, and descending."""
    rng = np.random.default_rng(n)
    kmer_hi = rng.integers(0, 1 << 10, n, dtype=np.uint64).astype(np.uint32)
    kmer_lo = rng.integers(0, 5000, n, dtype=np.uint64).astype(np.uint32)
    kmer_hi[n - n // 5 :] = kmer_lo[n - n // 5 :] = 0xFFFFFFFF
    asc = np.arange(n, dtype=np.uint32)
    return {"random": _pairs(n + 2, n), "k-mer keys with sentinels": (kmer_hi, kmer_lo),
            "sign bit": tuple(rng.integers(2**31 - 4, 2**31 + 4, n, dtype=np.uint64).astype(np.uint32)
                              for _ in range(2)),
            "all equal": (np.full(n, 7, np.uint32), np.full(n, 3, np.uint32)),
            "descending": (asc[::-1].copy(), asc[::-1].copy())}


#: below one tile of kernel #18's passes (4096 keys), one tile, one tile + 1,
#: and several tiles
@pytest.mark.parametrize("n", (100, 4096, 4097, 3 * 4096 + 5, 1 << 14, (1 << 14) + 1))
def test_plain_network_alone(n):
    """Kernel #18's plain version (its CPU route) alone: the eight radix
    passes with the kernel's tiles, against np.lexsort."""
    assert kernels.SORT_TILE == 4096
    for label, (hi, lo) in _key_sets(n).items():
        got = kernels.sort_pairs_bitonic_plain(interop.to_tensor(hi), interop.to_tensor(lo))
        for g, w in zip(got, _lexsorted(hi, lo)):
            assert np.array_equal(interop.to_numpy(g), w), label
    assert kernels.bitonic_size(n) == 1 << (n - 1).bit_length()


@pytest.mark.parametrize("shift", (0, 8, 56))
def test_plain_radix_pass_is_stable_across_tiles(shift):
    """One plain pass orders by its digit alone and keeps the input order of
    equal digits, also across tiles (the look-back's carried counts)."""
    rng = np.random.default_rng(shift)
    n = 3 * kernels.SORT_TILE + 77
    key = torch.from_numpy(rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64))
    got = kernels._radix_pass_plain(key, shift).numpy()
    digit = (key.numpy() >> shift) & 255
    assert np.array_equal(got, key.numpy()[np.argsort(digit, kind="stable")])


def test_errors_equal_reference():
    z8, z9 = np.zeros(8, np.uint32), np.zeros(9, np.uint32)
    cases = ((z8.astype(np.int32), z8, {}), (z8, z9, {}), (z8, z8, {"prefer": "bionic"}),
             (z8.astype(np.int32), z9, {"prefer": "bionic"}))
    for hi, lo, kw in cases:
        with pytest.raises((TypeError, ValueError)) as want:
            ref.sort_pairs(jnp.asarray(hi), jnp.asarray(lo), **kw)
        with pytest.raises((TypeError, ValueError)) as got:
            sort.sort_pairs(interop.to_tensor(hi), interop.to_tensor(lo), **kw)
        assert type(got.value) is type(want.value)
        if "prefer" in kw:
            assert str(got.value) == str(want.value) == "prefer must be 'lax' or 'bitonic', got 'bionic'"
