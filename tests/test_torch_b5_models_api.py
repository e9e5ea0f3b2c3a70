"""The port's Base5Codec, seqops, base-5 api and base-5 compat names against
the reference's, and the contract edges of the host API."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cute_nucleotides_tpu import api as ref_api, compat as ref_compat
from cute_nucleotides_tpu.models import Base5Codec as RefCodec
from cute_nucleotides_tpu.ops import oracle, seqops as ref_seqops
from cute_nucleotides_tpu_torch import api, compat, interop, models
from cute_nucleotides_tpu_torch.models import Base5Codec
from cute_nucleotides_tpu_torch.ops import eager, kernels, seqops

ALPHABET_N = np.frombuffer(b"ACGTUNacgtun", np.uint8)
LENGTHS = (1, 26, 27, 28, 53, 54, 55, 100, 1027)


def _batch(rows=4, length=270, seed=3):
    return np.random.default_rng(seed).choice(ALPHABET_N, size=(rows, length))


def _seq(n, seed=0):
    return np.random.default_rng(seed + n).choice(ALPHABET_N, size=n)


# --- Base5Codec ----------------------------------------------------------------

def test_codec_encode_decode_match_reference():
    x = _batch()
    codec, ref = Base5Codec(tier="torch"), RefCodec(tier="xla")
    words = codec.encode(interop.to_tensor(x))
    ref_words = ref.encode(jnp.asarray(x))
    assert words.shape == (4, 20)
    assert np.array_equal(interop.to_numpy(words), np.asarray(ref_words))
    assert np.array_equal(interop.to_numpy(codec.decode(words)), np.asarray(ref.decode(ref_words)))


@pytest.mark.parametrize("bad", [None, ord("X"), 0xC1, ord("n")])
def test_codec_encode_checked_matches_reference(bad):
    x = _batch(rows=5, seed=5)
    if bad is not None:
        x[3, 100] = bad
    words, flag = Base5Codec(tier="torch").encode_checked(interop.to_tensor(x))
    ref_words, ref_flag = RefCodec(tier="xla").encode_checked(jnp.asarray(x))
    assert np.array_equal(interop.to_numpy(words), np.asarray(ref_words))
    assert flag.shape == () and bool(flag) == bool(ref_flag) == (bad not in (None, ord("n")))


@pytest.mark.parametrize("corrupt", [None, "triplet", "bit63"])
def test_codec_decode_checked_matches_reference(corrupt):
    x = _batch(rows=3, seed=6)
    words = np.asarray(RefCodec(tier="xla").encode(jnp.asarray(x))).copy()
    if corrupt == "triplet":
        words[1, 4] |= np.uint32(0x7F)  # word 2, triplet 0 reads 127
    elif corrupt == "bit63":
        words[2, 7] |= np.uint32(1 << 31)
    out, flag = Base5Codec(tier="torch").decode_checked(interop.to_tensor(words))
    ref_out, ref_flag = RefCodec(tier="xla").decode_checked(jnp.asarray(words))
    assert flag.shape == () and bool(flag) == bool(ref_flag) == (corrupt is not None)
    if corrupt != "triplet":  # the tiers agree on valid triplets
        assert np.array_equal(interop.to_numpy(out), np.asarray(ref_out))


def test_codec_helpers_match_reference():
    codec, ref = Base5Codec(tier="torch"), RefCodec(tier="xla")
    assert (codec.tier, codec.device.type, codec.block) == ("torch", "cpu", ref.block)
    assert codec.words_per_read(55) == ref.words_per_read(55) == 6
    reads = [b"ACGTN", b"A" * 60, b""]
    for got, want in zip(codec.pad(reads), ref.pad(reads)):
        assert np.array_equal(got, want)


def test_codec_guards():
    with pytest.raises(ValueError, match="no variants"):
        Base5Codec(tier="torch", encode_variant="mul")
    with pytest.raises(ValueError, match="multiple of 27"):
        Base5Codec(tier="torch").encode(torch.zeros((2, 28), dtype=torch.uint8))
    with pytest.raises(ValueError):
        models.Base5Codec(tier="xla")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Base5Codec(tier="cuda")


# --- seqops --------------------------------------------------------------------

@pytest.mark.parametrize("case", ["clean", "t125", "t127_hi", "bit63", "two_rows", "empty"])
def test_first_invalid_word_matches_reference(case):
    w = np.asarray(RefCodec(tier="xla").encode(jnp.asarray(_batch(rows=3, length=270, seed=8)))).copy()
    if case == "t125":
        w[0, 6] = (w[0, 6] & ~np.uint32(0x7F)) | np.uint32(125)
    elif case == "t127_hi":
        w[1, 2 * 9 + 1] |= np.uint32(0x7F) << 24  # word 9, triplet 8
    elif case == "bit63":
        w[2, 2 * 4 + 1] |= np.uint32(1 << 31)
    elif case == "two_rows":
        w[0, 2 * 7 + 1] |= np.uint32(1 << 31)
        w[0, 2 * 3] |= np.uint32(0x7F << 7)
        w[2, 0] |= np.uint32(0x7F)
    elif case == "empty":
        w = w[:, :0]
    got = seqops.first_invalid_word_b5(interop.to_tensor(w))
    want = np.asarray(ref_seqops.first_invalid_word_b5(jnp.asarray(w)))
    assert got.dtype == torch.int32
    assert interop.to_numpy(got).tolist() == want.tolist()


# --- api -----------------------------------------------------------------------

@pytest.mark.parametrize("tier", ["oracle", "torch", "auto"])
def test_api_n_to_bits2_matches_reference(tier):
    for n in LENGTHS:
        s = _seq(n)
        got = api.n_to_bits2(s, tier=tier, device="cpu" if tier != "oracle" else None)
        assert got.dtype == np.uint64
        assert np.array_equal(got, ref_api.n_to_bits2(s, tier="xla")), n


@pytest.mark.parametrize("tier", ["oracle", "torch", "auto"])
def test_api_bits_to_n2_matches_reference(tier):
    for n in LENGTHS:
        words = oracle.n_to_bits2_lut(_seq(n))
        for length in (n, max(n - 5, 0)):
            got = api.bits_to_n2(words, length, tier=tier, device="cpu" if tier != "oracle" else None)
            assert np.array_equal(got, ref_api.bits_to_n2(words, length, tier="xla")), (n, length)


def test_api_all_256_bytes():
    s = np.tile(np.arange(256, dtype=np.uint8), 3)
    assert np.array_equal(api.n_to_bits2(s, tier="torch"), ref_api.n_to_bits2(s, tier="xla"))


def test_api_empty_input_makes_no_device_call(monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("device call on empty input")

    for fn in ("encode_b5_words", "decode_b5_bytes"):
        monkeypatch.setattr(eager, fn, boom)
        monkeypatch.setattr(kernels, fn, boom)
    assert api.n_to_bits2(b"", tier="torch").size == 0
    assert api.n_to_bits2(np.zeros(0, np.uint8), tier="torch").dtype == np.uint64
    assert api.bits_to_n2(np.zeros(0, np.uint64), 0, tier="torch").size == 0


@pytest.mark.parametrize("tier", ["oracle", "torch", "auto"])
def test_api_length_outside_capacity_raises(tier):
    words = oracle.n_to_bits2_lut(_seq(40))  # 2 words: capacity 54
    for length in (-1, 55):
        with pytest.raises(ValueError):
            api.bits_to_n2(words, length, tier=tier)
    with pytest.raises(ValueError):
        api.bits_to_n2(np.zeros(0, np.uint64), 1, tier=tier)


def test_api_validate_allows_n():
    with pytest.raises(ValueError, match="position 2"):
        api.n_to_bits2(b"ACXGT", validate=True)
    assert np.array_equal(api.n_to_bits2(b"acgtUNn", validate=True), ref_api.n_to_bits2(b"acgtUNn"))
    with pytest.raises(ValueError, match="unknown tier"):
        api.n_to_bits2(b"ACGT", tier="pallas")


# --- compat ----------------------------------------------------------------------

B5_NAMES = [n for n in compat.__all__ if "2" in n]


@pytest.mark.parametrize("name", [n for n in B5_NAMES if n.startswith("n_to_bits2")])
def test_compat_b5_encoders_match_reference(name):
    s = _seq(3000, seed=9)
    assert np.array_equal(getattr(compat, name)(s), getattr(ref_compat, name)(s))


@pytest.mark.parametrize("name", [n for n in B5_NAMES if n.startswith("bits_to_n2")])
def test_compat_b5_decoders_match_reference(name):
    n = 3001
    words = oracle.n_to_bits2_lut(_seq(n, seed=10))
    assert np.array_equal(getattr(compat, name)(words, n), getattr(ref_compat, name)(words, n))


def test_compat_names_are_the_reference_13():
    assert len(B5_NAMES) == 4
    assert set(compat.__all__) == set(ref_compat.__all__) and len(compat.__all__) == 13
