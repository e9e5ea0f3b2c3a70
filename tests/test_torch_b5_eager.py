"""The port's eager base-5 codec (ops/eager.py) against the reference's XLA
tier and the host oracles, bit for bit; corrupt words against the native
oracle."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cute_nucleotides_tpu.ops import native, oracle, spec, xla
from cute_nucleotides_tpu_torch import interop
from cute_nucleotides_tpu_torch.ops import eager

ALPHABET_N = np.frombuffer(b"ACGTUNacgtun", np.uint8)
LENGTHS = [0, 1, 26, 27, 28, 53, 54, 55] + np.random.default_rng(7).integers(56, 2000, 4).tolist()


def _padded(s: np.ndarray) -> np.ndarray:
    return np.concatenate([s, np.full((-s.size) % 27, ord("A"), np.uint8)])


def _all_triplet_words() -> np.ndarray:
    """Every triplet value 0..127 in every slot, with and without bit 63."""
    t = np.arange(128, dtype=np.uint64)
    return np.concatenate([(t << np.uint64(7 * j)) | (np.uint64(b) << np.uint64(63))
                           for j in range(9) for b in (0, 1)])


@pytest.mark.parametrize("n", LENGTHS)
def test_ragged_lengths_match_reference(n):
    s = np.random.default_rng(n).choice(ALPHABET_N, size=n)
    x = _padded(s)
    got = eager.encode_b5_words(interop.to_tensor(x))
    assert got.dtype == torch.uint32 and got.shape == (2 * (x.size // 27),)
    assert np.array_equal(interop.to_numpy(got), np.asarray(xla.encode_b5_words(jnp.asarray(x))))
    words = oracle.n_to_bits2_lut(s)
    assert np.array_equal(interop.tensor_to_u64(got), words)
    dec = eager.decode_b5_bytes(interop.u64_to_tensor(words))
    assert dec.shape == (27 * words.size,)
    assert np.array_equal(interop.to_numpy(dec)[:n], oracle.bits_to_n2_lut(words, n))
    want = np.asarray(xla.decode_b5_bytes(jnp.asarray(spec.u64_to_u32_pairs(words).reshape(-1))))
    assert np.array_equal(interop.to_numpy(dec), want)


def test_all_256_bytes_match_reference():
    x = np.repeat(np.arange(256, dtype=np.uint8), 27)  # each byte at every position of a word
    got = interop.to_numpy(eager.encode_b5_words(interop.to_tensor(x)))
    assert np.array_equal(got, np.asarray(xla.encode_b5_words(jnp.asarray(x))))
    assert np.array_equal(spec.u32_pairs_to_u64(got), native.n_to_bits2(x))


def test_batch_shapes_match_reference():
    x = np.random.default_rng(3).choice(ALPHABET_N, size=(3, 5, 54))
    got = eager.encode_b5_words(interop.to_tensor(x))
    want = xla.encode_b5_words(jnp.asarray(x))
    assert got.shape == (3, 5, 4)
    assert np.array_equal(interop.to_numpy(got), np.asarray(want))
    dec = eager.decode_b5_bytes(got)
    assert dec.shape == x.shape
    assert np.array_equal(interop.to_numpy(dec), np.asarray(xla.decode_b5_bytes(want)))


def test_corrupt_words_decode_as_the_native_oracle():
    words = _all_triplet_words()
    got = interop.to_numpy(eager.decode_b5_bytes(interop.u64_to_tensor(words)))
    assert np.array_equal(got, native.bits_to_n2(words, 27 * words.size))
    # a corrupt triplet's high digit reads 'N'; bit 63 changes nothing
    for t, chars in ((125, b"AAN"), (126, b"CAN"), (127, b"TAN")):
        word = np.array([t | (1 << 63)], np.uint64)
        assert bytes(interop.to_numpy(eager.decode_b5_bytes(interop.u64_to_tensor(word))))[:3] == chars


def test_digit_helpers():
    b = torch.arange(256, dtype=torch.uint8)
    assert torch.equal(eager.b5_digits(b).to(torch.uint8), torch.from_numpy(spec.BYTE_LUT_B5))
    d = torch.arange(5)
    assert bytes(eager.b5_digit_chars(d).to(torch.uint8).tolist()) == spec.DIG_TO_CHAR_B5.tobytes()


def test_shape_and_type_errors():
    with pytest.raises(ValueError, match="multiple of 27"):
        eager.encode_b5_words(torch.zeros(28, dtype=torch.uint8))
    with pytest.raises(TypeError):
        eager.encode_b5_words(torch.zeros(27, dtype=torch.int32))
    with pytest.raises(ValueError, match="even"):
        eager.decode_b5_bytes(torch.zeros(3, dtype=torch.uint32))
    with pytest.raises(TypeError):
        eager.decode_b5_bytes(torch.zeros(2, dtype=torch.int32))
