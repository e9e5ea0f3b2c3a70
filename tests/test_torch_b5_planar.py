"""Plain versions of the port's planar base-5 kernels (#15 encode, #16 nt4
decode padded and compact, #17 byte decode) against the reference's Pallas
kernels in interpret mode (as tests/test_pallas_b5.py runs them) on valid
words, and against the port's interleaved decode on every triplet value;
the wrappers' CPU dispatch, their argument errors beside the reference's,
and ``depad_nt4_host`` beside the reference's.  The kernels themselves are
held against these plain versions on the card in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cute_nucleotides_tpu.ops import oracle, pallas_kernels as pk
from cute_nucleotides_tpu_torch import interop
from cute_nucleotides_tpu_torch.ops import kernels as K

ALPHABET_N = np.frombuffer(b"ACGTUNacgtun", np.uint8)
PLANAR = (K.encode_b5_planar, K.decode_b5_nt4_panels, K.decode_b5_panels)


def _rows(R: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).choice(ALPHABET_N, size=(R, K.B5_ROW_NT))


def _planes(w64: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
    """u64 words (a multiple of 128) -> the (lo, hi) planes u32[R, 128]."""
    pair = np.ascontiguousarray(w64).view("<u4").reshape(-1, K.B5_ROW_WORDS, 2)
    return interop.to_tensor(np.ascontiguousarray(pair[..., 0])), interop.to_tensor(np.ascontiguousarray(pair[..., 1]))


def _every_triplet_words() -> np.ndarray:
    """Every triplet value in every slot, with and without bit 63: 2304
    words, 18 rows of 128."""
    t = np.arange(128, dtype=np.uint64)
    return np.concatenate([(t << np.uint64(7 * j)) | (np.uint64(b) << np.uint64(63)) for j in range(9) for b in (0, 1)])


def test_constants_equal_reference():
    for name in ("B5_ROW_NT", "B5_ROW_WORDS", "B5_SLICES", "B5_NT4_PAD_LANES"):
        assert getattr(K, name) == getattr(pk, name), name


@pytest.mark.parametrize("R", (1, 2))
def test_plain_versions_match_pallas(R):
    """One encode and three decodes of the reference per row count (each
    shape compiles anew in interpret mode)."""
    x = _rows(R, R)
    want_lo, want_hi = (np.asarray(p) for p in pk.encode_b5_planar(jnp.asarray(x), interpret=True))
    lo, hi = K.encode_b5_planar(interop.to_tensor(x))
    assert lo.dtype == hi.dtype == torch.uint32 and lo.shape == hi.shape == (R, 128)
    assert np.array_equal(interop.to_numpy(lo), want_lo) and np.array_equal(interop.to_numpy(hi), want_hi)
    jlo, jhi = jnp.asarray(want_lo), jnp.asarray(want_hi)
    for padded in (True, False):
        want = np.asarray(pk.decode_b5_nt4_panels(jlo, jhi, padded=padded, interpret=True))
        got = K.decode_b5_nt4_panels(lo, hi, padded=padded)
        assert got.dtype == torch.uint32 and np.array_equal(interop.to_numpy(got), want), padded
    want = np.asarray(pk.decode_b5_panels(jlo, jhi, interpret=True))
    got = K.decode_b5_panels(lo, hi)
    assert got.dtype == torch.uint8 and np.array_equal(interop.to_numpy(got), want)
    upper = x & 0xDF
    upper[upper == ord("U")] = ord("T")
    assert np.array_equal(want, upper)


def test_encode_plain_on_all_256_bytes():
    """Each byte value alone in a word and at every position of a word: the
    planes are the halves of encode_b5_stream_plain's words."""
    for x in (np.arange(256, dtype=np.uint8).repeat(27), np.tile(np.arange(256, dtype=np.uint8), 27)):
        t = interop.to_tensor(x.reshape(2, K.B5_ROW_NT))
        lo, hi = K.encode_b5_planar(t)
        words = interop.to_numpy(K.encode_b5_stream_plain(t.reshape(-1))).reshape(2, 128, 2)
        assert np.array_equal(interop.to_numpy(lo), words[..., 0]) and np.array_equal(interop.to_numpy(hi), words[..., 1])
        want = oracle.n_to_bits2_lut(x)
        assert np.array_equal(interop.to_numpy(lo).astype(np.uint64) | interop.to_numpy(hi).astype(np.uint64) << 32,
                              want.reshape(2, 128))


def test_decodes_on_every_triplet_equal_the_interleaved_decode():
    w64 = _every_triplet_words()
    lo, hi = _planes(w64)
    want = K.decode_b5_stream_plain(interop.u64_to_tensor(w64))
    assert torch.equal(K.decode_b5_panels(lo, hi).reshape(-1), want)
    assert torch.equal(K.decode_b5_nt4_panels(lo, hi, padded=False).view(torch.uint8).reshape(-1), want)
    padded = K.decode_b5_nt4_panels(lo, hi).view(torch.int32).view(18, K.B5_SLICES, 112)
    assert torch.equal(padded[:, :, :108].contiguous().view(torch.uint8).reshape(-1), want)
    assert bool((padded[:, :, 108:] == 0x41414141).all())
    assert set(interop.to_numpy(want).tolist()) == set(b"ACGTN")


def test_pad_lanes_read_AAAA():
    lo, hi = _planes(oracle.n_to_bits2_lut(_rows(3, 7).reshape(-1)))
    out = interop.to_numpy(K.decode_b5_nt4_panels(lo, hi))
    assert out.shape == (3, K.B5_NT4_PAD_LANES)
    assert np.all(out.reshape(3, 8, 112)[:, :, 108:] == 0x41414141)
    assert bytes(out.reshape(3, 8, 112)[0, 0, 108:].view(np.uint8)) == b"A" * 16


def test_empty_rows():
    lo, hi = K.encode_b5_planar(torch.zeros((0, K.B5_ROW_NT), dtype=torch.uint8))
    assert lo.shape == hi.shape == (0, 128)
    assert K.decode_b5_panels(lo, hi).shape == (0, K.B5_ROW_NT)
    assert K.decode_b5_nt4_panels(lo, hi).shape == (0, K.B5_NT4_PAD_LANES)
    assert K.decode_b5_nt4_panels(lo, hi, padded=False).shape == (0, 864)


def _messages(call_ref, call_port):
    with pytest.raises(TypeError) as want:
        call_ref()
    with pytest.raises(TypeError) as got:
        call_port()
    return str(got.value), str(want.value)


@pytest.mark.parametrize("shape", ((2, 3455), (3456,), (1, 2, 3456)))
def test_encode_type_error_equals_reference(shape):
    x = np.zeros(shape, np.uint8)
    got, want = _messages(lambda: pk.encode_b5_planar(jnp.asarray(x), interpret=True),
                          lambda: K.encode_b5_planar(interop.to_tensor(x)))
    assert got == want
    got, want = _messages(lambda: pk.encode_b5_planar(jnp.asarray(np.zeros((1, 3456), np.int32)), interpret=True),
                          lambda: K.encode_b5_planar(torch.zeros((1, 3456), dtype=torch.int32)))
    assert got == want


@pytest.mark.parametrize("shapes", (((2, 128), (3, 128)), ((2, 127), (2, 127)), ((256,), (256,))))
def test_decode_type_errors_equal_reference(shapes):
    a, b = (np.zeros(s, np.uint32) for s in shapes)
    for ref, port in ((lambda: pk.decode_b5_panels(jnp.asarray(a), jnp.asarray(b), interpret=True),
                       lambda: K.decode_b5_panels(interop.to_tensor(a), interop.to_tensor(b))),
                      (lambda: pk.decode_b5_nt4_panels(jnp.asarray(a), jnp.asarray(b), interpret=True),
                       lambda: K.decode_b5_nt4_panels(interop.to_tensor(a), interop.to_tensor(b)))):
        got, want = _messages(ref, port)
        assert got == want
    with pytest.raises(TypeError, match="planes, got int32/uint32"):
        K.decode_b5_panels(torch.zeros((1, 128), dtype=torch.int32), torch.zeros((1, 128), dtype=torch.uint32))


def test_cpu_dispatch_launches_nothing():
    K.reset_launch_counts()
    lo, hi = K.encode_b5_planar(interop.to_tensor(_rows(2, 3)))
    K.decode_b5_nt4_panels(lo, hi)
    K.decode_b5_nt4_panels(lo, hi, padded=False)
    K.decode_b5_panels(lo, hi)
    assert [fn.launches for fn in K.WRAPPERS] == [0] * len(K.WRAPPERS)
    assert all(fn in K.WRAPPERS for fn in PLANAR)


def test_meta_planes_are_refused():
    lo = torch.zeros((1, 128), dtype=torch.uint32, device="meta")
    for call in (lambda: K.encode_b5_planar(torch.zeros((1, 3456), dtype=torch.uint8, device="meta")),
                 lambda: K.decode_b5_nt4_panels(lo, lo), lambda: K.decode_b5_panels(lo, lo)):
        with pytest.raises(ValueError, match="no kernel for device meta"):
            call()


@pytest.mark.parametrize("R", (0, 1, 5))
def test_depad_nt4_host_equals_reference(R):
    lo, hi = _planes(oracle.n_to_bits2_lut(_rows(R, 20 + R).reshape(-1)))
    panels = interop.to_numpy(K.decode_b5_nt4_panels(lo, hi))
    got = K.depad_nt4_host(panels)
    assert got.dtype == np.uint8 and np.array_equal(got, pk.depad_nt4_host(panels))
    assert np.array_equal(got, interop.to_numpy(K.decode_b5_panels(lo, hi)).reshape(-1))
