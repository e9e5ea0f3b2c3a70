"""The port's 2-bit composition ops (``ops/seqops.py``: GC content, GC bins,
base composition and the SWAR popcount under them) against the JAX
package's ``ops/seqops.py``: the same seeded words through both, exact
equality."""

import jax.numpy as jnp
import numpy as np
import pytest

from cute_nucleotides_tpu.ops import oracle
from cute_nucleotides_tpu.ops import seqops as ref
from cute_nucleotides_tpu_torch import interop
from cute_nucleotides_tpu_torch.ops import seqops


def _words(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 2**32, shape, dtype=np.uint32)


def _same(got, want) -> None:
    w, g = np.asarray(want), interop.to_numpy(got)
    assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)


@pytest.mark.parametrize("shape", ((1,), (7,), (1000,), (4, 33), (2, 3, 64), (3, 0)))
def test_gc_content_and_composition_equal_reference(shape):
    w = _words(sum(shape), shape)
    t = interop.to_tensor(w)
    _same(seqops.gc_content_packed(t), ref.gc_content_packed(jnp.asarray(w)))
    _same(seqops.base_composition_packed(t), ref.base_composition_packed(jnp.asarray(w)))


@pytest.mark.parametrize("n", (0, 1, 15, 16, 17, 31, 32, 33, 1000))
def test_composition_of_encoded_sequences(n):
    """On a sequence's own words (the oracle's), with the length: the 'A'
    pad leaves the A column, and the counts equal a byte count."""
    s = np.random.default_rng(n).choice(np.frombuffer(b"ACGTUacgtu", np.uint8), n)
    w = np.ascontiguousarray(oracle.n_to_bits_lut(s)).view(np.uint32)
    t = interop.to_tensor(w)
    _same(seqops.base_composition_packed(t, n), ref.base_composition_packed(jnp.asarray(w), n))
    codes = (s >> 1) & 3
    assert seqops.base_composition_packed(t, n).tolist() == np.bincount(codes, minlength=4).tolist()
    assert int(seqops.gc_content_packed(t)) == int(np.isin(codes, (1, 3)).sum())


def test_composition_length_past_capacity_raises():
    w = _words(1, 4)
    with pytest.raises(ValueError) as want:
        ref.base_composition_packed(jnp.asarray(w), 65)
    with pytest.raises(ValueError) as got:
        seqops.base_composition_packed(interop.to_tensor(w), 65)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("bin_nt", (16, 1024, 48))
def test_gc_bins_equal_reference(bin_nt):
    w = _words(bin_nt, (3, 1000))
    _same(seqops.gc_bins_packed(interop.to_tensor(w), bin_nt), ref.gc_bins_packed(jnp.asarray(w), bin_nt))


def test_gc_bins_bad_width_raises():
    for bin_nt in (0, 24):
        with pytest.raises(ValueError, match="multiple of 16"):
            seqops.gc_bins_packed(interop.to_tensor(_words(1, 8)), bin_nt)


def test_popcount32_on_boundary_values():
    v = np.array([0, 1, 0x55555555, 0xAAAAAAAA, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 12345], dtype=np.int64)
    got = seqops.popcount32(interop.to_tensor(v)).tolist()
    assert got == [bin(int(x)).count("1") for x in v]
