"""The port's validation ops against the reference's (ops/validate.py)."""

import numpy as np
import pytest

import jax.numpy as jnp

from cute_nucleotides_tpu.ops import validate as ref
from cute_nucleotides_tpu_torch import interop
from cute_nucleotides_tpu_torch.ops import validate

ALL_BYTES = np.arange(256, dtype=np.uint8)


def _rows() -> np.ndarray:
    rng = np.random.default_rng(11)
    x = rng.choice(np.frombuffer(b"ACGTUNacgtun", np.uint8), size=(6, 300))
    x[1, 0] = ord("X")
    x[2, 299] = 0
    x[3, 150] = 0xFF
    x[3, 151] = ord("N")
    x[4, :256] = ALL_BYTES
    return x


@pytest.mark.parametrize("allow_n", [False, True])
def test_valid_mask_all_bytes(allow_n):
    got = interop.to_numpy(validate.valid_mask(interop.to_tensor(ALL_BYTES), allow_n=allow_n))
    want = np.asarray(ref.valid_mask(jnp.asarray(ALL_BYTES), allow_n=allow_n))
    assert np.array_equal(got, want)
    alphabet = b"ACGTUacgtu" + (b"Nn" if allow_n else b"")
    assert np.array_equal(np.nonzero(got)[0], np.array(sorted(alphabet)))


@pytest.mark.parametrize("allow_n", [False, True])
def test_count_invalid_matches_reference(allow_n):
    x = _rows()
    got = interop.to_numpy(validate.count_invalid(interop.to_tensor(x), allow_n=allow_n))
    want = np.asarray(ref.count_invalid(jnp.asarray(x), allow_n=allow_n))
    assert got.dtype == np.int32 and np.array_equal(got, want)


@pytest.mark.parametrize("allow_n", [False, True])
def test_first_invalid_matches_reference(allow_n):
    x = _rows()
    got = interop.to_numpy(validate.first_invalid(interop.to_tensor(x), allow_n=allow_n))
    want = np.asarray(ref.first_invalid(jnp.asarray(x), allow_n=allow_n))
    assert got.dtype == np.int32 and np.array_equal(got, want)


def test_first_invalid_clean_and_empty_rows():
    clean = interop.to_tensor(np.frombuffer(b"ACGTUacgtu" * 3, np.uint8))
    assert int(validate.first_invalid(clean)) == -1
    empty = interop.to_tensor(np.zeros((3, 0), np.uint8))
    assert interop.to_numpy(validate.first_invalid(empty)).tolist() == [-1, -1, -1]
