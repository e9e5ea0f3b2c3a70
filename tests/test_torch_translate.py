"""The port's codon translation (``ops/seqops.py``: ``translate_packed``,
``translate_6frame`` and their base-5 forms) against the JAX package's, and
against a byte-level translation by the standard code: frames 0-2 and all
six for both codecs, N codons as X, corrupt base-5 triplets, and the
reference's error cases."""

import jax.numpy as jnp
import numpy as np
import pytest

from cute_nucleotides_tpu.ops import oracle
from cute_nucleotides_tpu.ops import seqops as ref
from cute_nucleotides_tpu_torch import interop
from cute_nucleotides_tpu_torch.ops import seqops

_AAS = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
CODONS = {a + b + c: _AAS[16 * i + 4 * j + k] for i, a in enumerate("TCAG") for j, b in enumerate("TCAG")
          for k, c in enumerate("TCAG")}
COMP_N = bytes.maketrans(b"ACGTN", b"TGCAN")


def _naive(seq: bytes, frame: int) -> bytes:
    s = seq.upper().replace(b"U", b"T").decode()
    return "".join("X" if "N" in s[i : i + 3] else CODONS[s[i : i + 3]]
                   for i in range(frame, len(s) - 2, 3)).encode()


def _seq(seed: int, n: int, alphabet: bytes) -> bytes:
    return np.random.default_rng(seed).choice(np.frombuffer(alphabet, np.uint8), n).tobytes()


def _enc(seq: bytes, b5: bool) -> np.ndarray:
    enc = oracle.n_to_bits2_lut if b5 else oracle.n_to_bits_lut
    return np.ascontiguousarray(enc(np.frombuffer(seq, np.uint8))).view(np.uint32)


def _bytes(t) -> bytes:
    return interop.to_numpy(t).tobytes()


def _same(got, want) -> None:
    w, g = np.asarray(want), interop.to_numpy(got)
    assert g.dtype == w.dtype == np.uint8 and np.array_equal(g, w)


def test_codon_tables_equal_reference():
    assert np.array_equal(seqops._codon_lut(), ref._codon_lut())
    assert np.array_equal(seqops._codon_lut_b5(), ref._codon_lut_b5())
    assert CODONS["ATG"] == "M" and CODONS["TGA"] == CODONS["TAA"] == CODONS["TAG"] == "*"


@pytest.mark.parametrize("frame", (0, 1, 2))
@pytest.mark.parametrize("b5", (False, True), ids=("2bit", "base5"))
def test_translate_frames_equal_reference(frame, b5):
    fn, rfn = (seqops.translate_packed_b5, ref.translate_packed_b5) if b5 else (seqops.translate_packed,
                                                                              ref.translate_packed)
    for L in (3, 4, 5, 47, 300):
        if (L - frame) // 3 <= 0:
            continue
        s = _seq(L + frame, L, b"ACGTNacgtnu" if b5 else b"ACGTacgtu")
        w = _enc(s, b5)
        got = fn(interop.to_tensor(w), L, frame)
        _same(got, rfn(jnp.asarray(w), L, frame))
        assert _bytes(got) == _naive(s, frame), (L, frame)


@pytest.mark.parametrize("b5", (False, True), ids=("2bit", "base5"))
def test_six_frames_equal_reference(b5):
    L = 101
    s = _seq(101, L, b"ACGTN" if b5 else b"ACGT")
    w = _enc(s, b5)
    fn, rfn = (seqops.translate_6frame_b5, ref.translate_6frame_b5) if b5 else (seqops.translate_6frame,
                                                                              ref.translate_6frame)
    got, want = fn(interop.to_tensor(w), L), rfn(jnp.asarray(w), L)
    assert len(got) == len(want) == 6
    rc = s.translate(COMP_N)[::-1]
    for f in range(3):
        _same(got[f], want[f])
        _same(got[3 + f], want[3 + f])
        assert _bytes(got[f]) == _naive(s, f) and _bytes(got[3 + f]) == _naive(rc, f)


def test_n_codons_are_x_and_codecs_agree_without_n():
    s = b"ATGNNNAAANCGTGA" + b"ACGT" * 10
    got = _bytes(seqops.translate_packed_b5(interop.to_tensor(_enc(s, True)), len(s), 0))
    assert got[:5] == b"MXKX*" and got == _naive(s, 0)
    clean = _seq(99, 99, b"ACGT")
    for f in range(3):
        assert (_bytes(seqops.translate_packed(interop.to_tensor(_enc(clean, False)), 99, f))
                == _bytes(seqops.translate_packed_b5(interop.to_tensor(_enc(clean, True)), 99, f)))


def test_corrupt_triplets_translate_as_reference():
    """Triplets 125..127 in every slot (and bit 63 on every other word), in
    every frame and on the minus strand."""
    t = np.zeros((27, 9), np.uint64)
    t[np.arange(27), np.arange(27) % 9] = 125 + np.arange(27) // 9
    w64 = np.zeros(27, np.uint64)
    for j in range(9):
        w64 |= (t[:, j] + np.uint64(j)) << np.uint64(7 * j)
    w64[::2] |= np.uint64(1) << np.uint64(63)
    w = w64.view(np.uint32)
    L = 27 * 27
    for a, b in zip(seqops.translate_6frame_b5(interop.to_tensor(w), L), ref.translate_6frame_b5(jnp.asarray(w), L)):
        _same(a, b)


def _raises_like(port_call, ref_call):
    with pytest.raises(ValueError) as want:
        ref_call()
    with pytest.raises(ValueError) as got:
        port_call()
    assert str(got.value) == str(want.value)


def test_errors_equal_reference():
    w = np.zeros(2, np.uint32)
    t, j = interop.to_tensor(w), jnp.asarray(w)
    for length, frame in ((2, 0), (9, 3), (9, -1)):
        _raises_like(lambda: seqops.translate_packed(t, length, frame), lambda: ref.translate_packed(j, length, frame))
    for length, frame in ((2, 0), (9, 3), (28, 0), (4, 2)):
        _raises_like(lambda: seqops.translate_packed_b5(t, length, frame),
                     lambda: ref.translate_packed_b5(j, length, frame))
    with pytest.raises(TypeError, match="flat interleaved"):
        seqops.translate_packed_b5(interop.to_tensor(np.zeros(3, np.uint32)), 3)
