"""The port's torch tier (cute_nucleotides_tpu_torch.ops.eager) against the
reference's XLA tier and the NumPy oracle, bit for bit.

Inputs come from numpy with a fixed seed; both packages compute on the same
bytes.  Ragged lengths are padded with 'A' to the 16-nt group the words API
takes, as the port's api does.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cute_nucleotides_tpu.ops import oracle, spec, xla
from cute_nucleotides_tpu_torch import interop
from cute_nucleotides_tpu_torch.ops import eager

ALPHABET = np.frombuffer(b"ACGTUacgtu", np.uint8)
LENGTHS = (0, 1, 15, 16, 17, 31, 32, 33, 257, 1000)


def _pad16(s: np.ndarray) -> np.ndarray:
    pad = (-s.size) % 16
    return np.concatenate([s, np.full(pad, ord("A"), np.uint8)])


def _seq(n: int) -> np.ndarray:
    return np.random.default_rng(1000 + n).choice(ALPHABET, size=n)


def _words_u64(words: torch.Tensor, n: int) -> np.ndarray:
    w = interop.to_numpy(words).reshape(-1)
    w = np.concatenate([w, np.zeros(w.size % 2, np.uint32)])
    return w.view("<u8")[: spec.num_words_2bit(n)]


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("variant", eager.ENCODE_2BIT_VARIANTS)
def test_encode_matches_xla_and_oracle(variant, n):
    x = _pad16(_seq(n))
    got = eager.encode_2bit_words(interop.to_tensor(x), variant)
    assert got.dtype == torch.uint32 and got.shape == (x.size // 16,)
    if x.size:
        want = np.asarray(xla.encode_2bit_words(jnp.asarray(x), variant))
        assert np.array_equal(interop.to_numpy(got), want)
    assert np.array_equal(_words_u64(got, n), oracle.n_to_bits_lut(x[:n]))


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("variant", eager.DECODE_2BIT_VARIANTS)
def test_decode_matches_xla_and_oracle(variant, n):
    s = _seq(n)
    words = oracle.n_to_bits_lut(s)
    w32 = spec.u64_to_u32_pairs(words).reshape(-1)
    got = interop.to_numpy(eager.decode_2bit_bytes(interop.u64_to_tensor(words), variant))
    assert got.shape == (16 * w32.size,)
    if w32.size:
        want = np.asarray(xla.decode_2bit_bytes(jnp.asarray(w32), variant))
        assert np.array_equal(got, want)
    assert np.array_equal(got[:n], oracle.bits_to_n_lut(words, n))


@pytest.mark.parametrize("variant", eager.ENCODE_2BIT_VARIANTS)
def test_encode_all_256_bytes(variant):
    # every byte value at every position of a 4-byte lane
    x = np.concatenate([np.roll(np.arange(256, dtype=np.uint8), k) for k in range(4)])
    got = eager.encode_2bit_words(interop.to_tensor(x), variant)
    assert np.array_equal(_words_u64(got, x.size), oracle.n_to_bits_lut(x))
    want = np.asarray(xla.encode_2bit_words(jnp.asarray(x), variant))
    assert np.array_equal(interop.to_numpy(got), want)


@pytest.mark.parametrize("variant", eager.DECODE_2BIT_VARIANTS)
def test_decode_all_256_packed_bytes(variant):
    w32 = np.arange(256, dtype=np.uint8).view(np.uint32)
    got = interop.to_numpy(eager.decode_2bit_bytes(interop.to_tensor(w32), variant))
    want = np.asarray(xla.decode_2bit_bytes(jnp.asarray(w32), variant))
    assert np.array_equal(got, want)
    assert set(got.tobytes()) == set(b"ACGT")


@pytest.mark.parametrize("variant", eager.ENCODE_2BIT_VARIANTS)
def test_batch_shape_roundtrip(variant):
    rng = np.random.default_rng(7)
    batch = rng.choice(ALPHABET, size=(3, 5, 96))
    words = eager.encode_2bit_words(interop.to_tensor(batch), variant)
    assert words.shape == (3, 5, 6)
    want = np.asarray(xla.encode_2bit_words(jnp.asarray(batch), variant))
    assert np.array_equal(interop.to_numpy(words), want)
    back = interop.to_numpy(eager.decode_2bit_bytes(words))
    upper = batch & 0xDF
    upper[upper == ord("U")] = ord("T")
    assert np.array_equal(back, upper)


def test_misaligned_view_is_copied_not_refused():
    # the torch tier may copy: a byte view at an odd offset still encodes
    s = _seq(65)
    x = interop.to_tensor(s)[1:]
    got = eager.encode_2bit_words(x, "mul")
    assert np.array_equal(_words_u64(got, 64), oracle.n_to_bits_lut(s[1:]))


def test_unknown_variant_and_bad_shapes_raise():
    x = torch.zeros(32, dtype=torch.uint8)
    with pytest.raises(ValueError):
        eager.encode_2bit_words(x, "mxu")
    with pytest.raises(ValueError):
        eager.encode_2bit_words(torch.zeros(17, dtype=torch.uint8))
    with pytest.raises(TypeError):
        eager.decode_2bit_bytes(torch.zeros(2, dtype=torch.int32))


def test_interop_keeps_every_bit():
    rng = np.random.default_rng(13)
    raw = rng.integers(0, 256, 64, dtype=np.uint8)
    t = interop.to_tensor(raw.tobytes())  # bytes: a read-only buffer, copied
    assert t.dtype == torch.uint8 and np.array_equal(interop.to_numpy(t), raw)
    w32 = raw.view(np.uint32)  # values with the top bit set survive
    t32 = interop.to_tensor(w32)
    assert t32.dtype == torch.uint32 and np.array_equal(interop.to_numpy(t32), w32)
    assert np.array_equal(interop.to_numpy(interop.nt4(t)), w32)
    assert np.array_equal(interop.to_numpy(interop.nt4_bytes(t32)), raw)
    u64 = raw.view(np.uint64).reshape(2, 4)
    pairs = interop.u64_to_tensor(u64)
    assert pairs.shape == (2, 8)
    assert np.array_equal(interop.to_numpy(pairs), spec.u64_to_u32_pairs(u64).reshape(2, 8))
    assert np.array_equal(interop.tensor_to_u64(pairs), u64)
    with pytest.raises(TypeError):
        interop.to_tensor(np.zeros(2, np.uint64))
    with pytest.raises(ValueError):
        interop.tensor_to_u64(t32[:3])
