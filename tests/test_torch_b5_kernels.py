"""Plain versions of the port's two base-5 CUDA kernels against the
reference's Pallas kernels (run in interpret mode, as tests/test_pallas_b5.py
runs them) and the native oracle, bit for bit; and the wrappers' CPU
dispatch, argument checks and launch counts.  The kernels themselves are
held against the plain versions on the card in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cute_nucleotides_tpu.ops import native, oracle, pallas_kernels as pk, spec
from cute_nucleotides_tpu_torch import interop
from cute_nucleotides_tpu_torch.ops import kernels as K

ALPHABET_N = np.frombuffer(b"ACGTUNacgtun", np.uint8)
VALID = set(ALPHABET_N.tolist())
WORDS = (1, 2, 127, 128, 129)


def _stream(n_words: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).choice(ALPHABET_N, size=27 * n_words)


def _w32(words64: np.ndarray) -> np.ndarray:
    return spec.u64_to_u32_pairs(words64).reshape(-1)


@pytest.mark.parametrize("n", WORDS)
def test_encode_plain_matches_pallas(n):
    s = _stream(n, n)
    want = np.asarray(pk.encode_b5_words_pallas(jnp.asarray(s), interpret=True))
    got = K.encode_b5_stream_plain(interop.to_tensor(s))
    assert got.dtype == torch.uint32 and got.shape == (2 * n,)
    assert np.array_equal(interop.to_numpy(got), want)


def test_checked_encode_flag_on_all_256_bytes():
    """Row v holds byte v only: the Pallas badplane and the plain flag agree
    with the validity set on each byte value."""
    x = np.tile(np.arange(256, dtype=np.uint8)[:, None], (1, pk.B5_ROW_NT))
    words, badplane = pk.encode_b5_panels_checked(jnp.asarray(x), interpret=True)
    want_flags = np.asarray(badplane).any(-1)
    assert want_flags.tolist() == [v not in VALID for v in range(256)]
    for v in range(256):
        got_words, flag = K.encode_b5_stream_plain(interop.to_tensor(x[v, :270]), checked=True)
        assert interop.to_numpy(flag).tolist() == [int(want_flags[v])], v
        assert np.array_equal(interop.to_numpy(got_words), np.asarray(words)[v, :20]), v


@pytest.mark.parametrize("bad", [ord("X"), 0, 0x80, ord("E"), None])
def test_checked_encode_words_match_pallas(bad):
    s = _stream(129, 5)
    if bad is not None:
        s[1234] = bad
    want_w, want_bad = pk.encode_b5_words_checked(jnp.asarray(s), interpret=True)
    words, flag = K.encode_b5_words_checked(interop.to_tensor(s))
    assert np.array_equal(interop.to_numpy(words), np.asarray(want_w))
    assert flag.dtype == torch.bool and flag.shape == ()
    assert bool(flag) == bool(want_bad) == (bad is not None)


@pytest.mark.parametrize("n", (1, 128, 129))
def test_decode_plain_matches_pallas(n):
    w = _w32(oracle.n_to_bits2_lut(_stream(n, 10 + n)))
    want = np.asarray(pk.decode_b5_bytes_pallas(jnp.asarray(w), interpret=True))
    got = K.decode_b5_stream_plain(interop.to_tensor(w))
    assert got.dtype == torch.uint8 and got.shape == (27 * n,)
    assert np.array_equal(interop.to_numpy(got), want)


@pytest.mark.parametrize("corrupt", ["none", "t125", "t126", "t127", "bit63"])
def test_checked_decode_flag_matches_pallas(corrupt):
    w64 = oracle.n_to_bits2_lut(_stream(100, 11)).copy()
    if corrupt == "bit63":
        w64[37] |= np.uint64(1 << 63)
    elif corrupt != "none":
        t = int(corrupt[1:])
        w64[37] = (w64[37] & ~np.uint64(0x7F << 28)) | np.uint64(t << 28)  # triplet 4 straddles the halves
    w = _w32(w64)
    want_out, want_bad = pk.decode_b5_bytes_checked(jnp.asarray(w), interpret=True)
    out, flag = K.decode_b5_stream_plain(interop.to_tensor(w), checked=True)
    assert interop.to_numpy(flag).tolist() == [int(bool(want_bad))] == [int(corrupt != "none")]
    if corrupt in ("none", "bit63"):  # the tiers agree on the words' valid triplets
        assert np.array_equal(interop.to_numpy(out), np.asarray(want_out))


def test_digits_decode_matches_pallas_after_depad():
    s = _stream(2 * pk.B5_ROW_WORDS, 12)
    words = oracle.n_to_bits2_lut(s)
    panels = np.asarray(pk.decode_b5_digits_panels(
        jnp.asarray(np.ascontiguousarray(words).view("<u4").reshape(2, 256)), interpret=True))
    want = np.ascontiguousarray(panels.reshape(2, 8, 112)[:, :, :108]).view(np.uint8).reshape(-1)
    got = K.decode_b5_stream_plain(interop.u64_to_tensor(words), digits=True)
    assert np.array_equal(interop.to_numpy(got), want)
    assert np.array_equal(spec.DIG_TO_CHAR_B5[want], oracle.bits_to_n2_lut(words, s.size))


def test_corrupt_words_decode_as_the_native_oracle():
    t = np.arange(128, dtype=np.uint64)
    w64 = np.concatenate([(t << np.uint64(7 * j)) | (np.uint64(b) << np.uint64(63))
                          for j in range(9) for b in (0, 1)])
    w = interop.u64_to_tensor(w64)
    chars = interop.to_numpy(K.decode_b5_stream(w))
    assert np.array_equal(chars, native.bits_to_n2(w64, 27 * w64.size))
    digits = interop.to_numpy(K.decode_b5_stream(w, digits=True))
    assert digits.max() == 4 and np.array_equal(spec.DIG_TO_CHAR_B5[digits], chars)
    _, flag = K.decode_b5_stream(w, checked=True)
    assert interop.to_numpy(flag).tolist() == [1]


def test_adapters_on_cpu():
    x = np.random.default_rng(13).choice(ALPHABET_N, size=(3, 2, 54))
    t = interop.to_tensor(x)
    words = K.encode_b5_words(t)
    assert words.shape == (3, 2, 4)
    want = np.asarray(pk.encode_b5_words_pallas(jnp.asarray(x), interpret=True))
    assert np.array_equal(interop.to_numpy(words), want)
    upper = x & 0xDF
    upper[upper == ord("U")] = ord("T")
    assert np.array_equal(interop.to_numpy(K.decode_b5_bytes(words)), upper)
    out, bad = K.decode_b5_bytes_checked(words)
    assert torch.equal(out, K.decode_b5_bytes(words)) and not bool(bad)
    digits = K.decode_b5_digits(words)
    assert digits.shape == x.shape
    assert np.array_equal(spec.DIG_TO_CHAR_B5[interop.to_numpy(digits)], upper)
    empty = K.encode_b5_words(torch.zeros((4, 0), dtype=torch.uint8))
    assert empty.shape == (4, 0) and K.decode_b5_bytes(empty).shape == (4, 0)


def test_cpu_dispatch_launches_nothing():
    K.reset_launch_counts()
    x = interop.to_tensor(_stream(3, 14))
    K.encode_b5_stream(x)
    K.encode_b5_stream(x, checked=True)
    w = K.encode_b5_stream(x)
    K.decode_b5_stream(w)
    K.decode_b5_stream(w, checked=True)
    K.decode_b5_stream(w, digits=True)
    assert [fn.launches for fn in K.WRAPPERS] == [0] * len(K.WRAPPERS)


def test_wrapper_argument_checks():
    with pytest.raises(ValueError, match="not a multiple of 27"):
        K.encode_b5_stream(torch.zeros(28, dtype=torch.uint8))
    with pytest.raises(TypeError):
        K.encode_b5_stream(torch.zeros((1, 27), dtype=torch.uint8))
    with pytest.raises(ValueError, match="not a multiple of 2"):
        K.decode_b5_stream(torch.zeros(3, dtype=torch.uint32))
    with pytest.raises(TypeError):
        K.decode_b5_stream(torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="checked digit"):
        K.decode_b5_stream(torch.zeros(2, dtype=torch.uint32), checked=True, digits=True)
    with pytest.raises(ValueError, match="multiple of 27"):
        K.encode_b5_words(torch.zeros((2, 26), dtype=torch.uint8))
    with pytest.raises(ValueError, match="even"):
        K.decode_b5_bytes(torch.zeros((2, 3), dtype=torch.uint32))
