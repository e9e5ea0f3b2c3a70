"""The port's TwoBitCodec, api and compat against the reference's, and the
contract edges of the host API."""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cute_nucleotides_tpu import api as ref_api, compat as ref_compat
from cute_nucleotides_tpu.models import TwoBitCodec as RefCodec
from cute_nucleotides_tpu.ops import oracle
from cute_nucleotides_tpu_torch import api, compat, interop, models
from cute_nucleotides_tpu_torch.models import TwoBitCodec
from cute_nucleotides_tpu_torch.ops import eager, kernels

ALPHABET = np.frombuffer(b"ACGTUacgtu", np.uint8)
LENGTHS = (1, 15, 16, 17, 31, 32, 33, 100, 1027)


def _batch(rows=4, length=256, seed=3):
    return np.random.default_rng(seed).choice(ALPHABET, size=(rows, length))


def _seq(n, seed=0):
    return np.random.default_rng(seed + n).choice(ALPHABET, size=n)


# --- TwoBitCodec ---------------------------------------------------------------

@pytest.mark.parametrize("variant", eager.ENCODE_2BIT_VARIANTS)
def test_codec_encode_matches_reference(variant):
    x = _batch()
    got = TwoBitCodec(tier="torch", encode_variant=variant).encode(interop.to_tensor(x))
    want = RefCodec(tier="xla", encode_variant=variant).encode(jnp.asarray(x))
    assert np.array_equal(interop.to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("variant", eager.DECODE_2BIT_VARIANTS)
def test_codec_decode_matches_reference(variant):
    x = _batch(seed=4)
    ref = RefCodec(tier="xla", decode_variant=variant)
    words = ref.encode(jnp.asarray(x))
    got = TwoBitCodec(tier="torch", decode_variant=variant).decode(interop.to_tensor(np.asarray(words)))
    assert np.array_equal(interop.to_numpy(got), np.asarray(ref.decode(words)))


def test_codec_encode_checked_matches_reference():
    x = _batch(rows=5, seed=5)
    x[1, 17] = ord("N")
    x[4, 255] = 0x80
    words, bad = TwoBitCodec(tier="torch").encode_checked(interop.to_tensor(x))
    ref_words, ref_bad = RefCodec(tier="xla").encode_checked(jnp.asarray(x))
    assert np.array_equal(interop.to_numpy(words), np.asarray(ref_words))
    assert interop.to_numpy(bad).tolist() == np.asarray(ref_bad).tolist() == [False, True, False, False, True]


def test_codec_nt4_paths_match_reference():
    x = _batch(rows=8, length=2048, seed=6)
    nt4 = np.ascontiguousarray(x).view(np.uint32)
    codec, ref = TwoBitCodec(tier="torch"), RefCodec(tier="xla")
    packed = codec.encode_nt4(interop.to_tensor(nt4))
    ref_packed = ref.encode_nt4(jnp.asarray(nt4))
    assert np.array_equal(interop.to_numpy(packed), np.asarray(ref_packed))
    back = codec.decode_nt4(packed)
    assert np.array_equal(interop.to_numpy(back), np.asarray(ref.decode_nt4(ref_packed)))


def test_codec_defaults_and_helpers():
    codec = TwoBitCodec(tier="torch")
    assert (codec.tier, codec.device.type) == ("torch", "cpu")
    assert (codec.encode_variant, codec.decode_variant) == ("dot", "broadcast")
    ref = RefCodec(tier="xla")
    assert codec.block == ref.block
    assert codec.words_per_read(33) == ref.words_per_read(33) == 4
    reads = [b"ACGT", b"A" * 40, b""]
    for got, want in zip(codec.pad(reads), ref.pad(reads)):
        assert np.array_equal(got, want)


def test_codec_tier_guards():
    with pytest.raises(ValueError, match="CUDA kernel"):
        TwoBitCodec(tier="torch", encode_variant="mxu")
    with pytest.raises(ValueError):
        TwoBitCodec(tier="torch", encode_variant="pext")
    with pytest.raises(ValueError):
        TwoBitCodec(tier="xla")
    with pytest.raises(ValueError):
        models.CodecConfig(tier="cuda", device="cpu").resolved_device()
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="torch-tier"):
            TwoBitCodec(tier="cuda", encode_variant="dot")
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TwoBitCodec(tier="cuda")


# --- api -----------------------------------------------------------------------

ENCODE_ROUTES = [("oracle", None), ("auto", None), ("torch", "mxu")] + [
    ("torch", v) for v in eager.ENCODE_2BIT_VARIANTS
]
DECODE_ROUTES = [("oracle", None), ("auto", None)] + [("torch", v) for v in eager.DECODE_2BIT_VARIANTS]


@pytest.mark.parametrize("tier,variant", ENCODE_ROUTES)
def test_api_n_to_bits_matches_reference(tier, variant):
    for n in LENGTHS:
        s = _seq(n)
        got = api.n_to_bits(s, tier=tier, variant=variant, device="cpu" if tier != "oracle" else None)
        assert got.dtype == np.uint64
        assert np.array_equal(got, ref_api.n_to_bits(s, tier="xla")), n


@pytest.mark.parametrize("tier,variant", DECODE_ROUTES)
def test_api_bits_to_n_matches_reference(tier, variant):
    for n in LENGTHS:
        words = oracle.n_to_bits_lut(_seq(n))
        for length in (n, max(n - 5, 0)):
            got = api.bits_to_n(words, length, tier=tier, variant=variant,
                                device="cpu" if tier != "oracle" else None)
            assert np.array_equal(got, ref_api.bits_to_n(words, length, tier="xla")), (n, length)


def test_api_all_256_bytes():
    s = np.tile(np.arange(256, dtype=np.uint8), 3)
    assert np.array_equal(api.n_to_bits(s, tier="torch"), ref_api.n_to_bits(s, tier="xla"))


def test_api_empty_input_makes_no_device_call(monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("device call on empty input")

    for fn in ("encode_2bit_words", "decode_2bit_bytes"):
        monkeypatch.setattr(eager, fn, boom)
        monkeypatch.setattr(kernels, fn, boom)
    assert api.n_to_bits(b"", tier="torch").size == 0
    assert api.n_to_bits(np.zeros(0, np.uint8), tier="torch").dtype == np.uint64
    assert api.bits_to_n(np.zeros(0, np.uint64), 0, tier="torch").size == 0


@pytest.mark.parametrize("tier", ["oracle", "torch", "auto"])
def test_api_length_outside_capacity_raises(tier):
    words = oracle.n_to_bits_lut(_seq(40))  # 2 words: capacity 64
    for length in (-1, 65):
        with pytest.raises(ValueError):
            api.bits_to_n(words, length, tier=tier)
    with pytest.raises(ValueError):
        api.bits_to_n(np.zeros(0, np.uint64), 1, tier=tier)


def test_api_validate_and_tier_errors():
    with pytest.raises(ValueError, match="position 2"):
        api.n_to_bits(b"ACNGT", validate=True)
    assert np.array_equal(api.n_to_bits(b"acgtU", validate=True), ref_api.n_to_bits(b"acgtU"))
    with pytest.raises(ValueError, match="unknown tier"):
        api.n_to_bits(b"ACGT", tier="pallas")
    with pytest.raises(ValueError, match="unknown tier"):
        api.bits_to_n(np.zeros(1, np.uint64), 4, tier="xla")


def test_api_read_only_input_is_copied_quietly():
    s = np.frombuffer(b"ACGTTGCA" * 9, np.uint8)
    assert not s.flags.writeable
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        words = api.n_to_bits(s, tier="torch")
        back = api.bits_to_n(np.frombuffer(words.tobytes(), np.uint64), s.size, tier="torch")
    assert back.tobytes() == bytes(s)


# --- compat ----------------------------------------------------------------------

TWO_BIT_NAMES = [n for n in compat.__all__ if "2" not in n]


@pytest.mark.parametrize("name", [n for n in TWO_BIT_NAMES if n.startswith("n_to_bits")])
def test_compat_encoders_match_reference(name):
    s = _seq(3000, seed=9)
    assert np.array_equal(getattr(compat, name)(s), getattr(ref_compat, name)(s))


@pytest.mark.parametrize("name", [n for n in TWO_BIT_NAMES if n.startswith("bits_to_n")])
def test_compat_decoders_match_reference(name):
    n = 3001
    words = oracle.n_to_bits_lut(_seq(n, seed=10))
    assert np.array_equal(getattr(compat, name)(words, n), getattr(ref_compat, name)(words, n))


def test_compat_names_are_the_reference_2bit_names():
    assert set(TWO_BIT_NAMES) == {n for n in ref_compat.__all__ if "2" not in n}
