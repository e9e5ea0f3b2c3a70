"""Plain versions of the port's four CUDA kernels against the reference's
Pallas kernels (run in interpret mode, as tests/test_pallas.py runs them),
bit for bit; and the wrappers' CPU dispatch, shape checks and launch
counts.  The kernels themselves are held against the plain versions on the
card in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cute_nucleotides_tpu.ops import oracle, pallas_kernels as pk
from cute_nucleotides_tpu_torch import interop
from cute_nucleotides_tpu_torch.ops import kernels as K, native

ALPHABET = np.frombuffer(b"ACGTUacgtu", np.uint8)
ENCODE = ("mul", "shift", "interleave")
DECODE = ("shuffle", "select", "swar")
RAGGED = (1, 15, 16, 17, 31, 32, 33)
#: lanes per row of the pext slot's plain-version cases: rows of 16, 48, 64
#: and 80 nt (odd u32 totals at R = 1 and 3), and the reference kernel's
#: 512-lane tile and two of them
PEXT_C = (4, 12, 16, 20, 512, 1024)
INVALID = (ord("N"), ord("X"), 0, 0x80, 0xFF, ord("B"), ord("n"), ord("@"))


def _nt4(rows: int, lanes: int, seed: int) -> np.ndarray:
    s = np.random.default_rng(seed).choice(ALPHABET, size=(rows, 4 * lanes))
    return np.ascontiguousarray(s).view(np.uint32)


def _all_bytes_rows() -> np.ndarray:
    # every byte value 0..255 at every position of a 4-byte lane
    s = np.full((8, 512 * 4), ord("A"), np.uint8)
    for pos in range(4):
        s[pos % 8, pos * 256 : (pos + 1) * 256] = np.arange(256, dtype=np.uint8)
    s[5, 1 : 1 + 4 * 256 : 4] = np.arange(256, dtype=np.uint8)
    return s


@pytest.mark.parametrize("variant", ENCODE)
def test_encode_plain_matches_pallas(variant):
    w = _nt4(8, 512, 1)
    want = np.asarray(pk.encode_2bit_nt4(jnp.asarray(w), variant, interpret=True))
    got = K.encode_2bit_nt4_plain(interop.to_tensor(w), variant)
    assert got.dtype == torch.uint8
    assert np.array_equal(interop.to_numpy(got), want)


@pytest.mark.parametrize("variant", DECODE)
def test_decode_plain_matches_pallas(variant):
    p = np.random.default_rng(2).integers(0, 256, (8, 512), dtype=np.uint8)
    want = np.asarray(pk.decode_2bit_nt4(jnp.asarray(p), variant, interpret=True))
    got = K.decode_2bit_nt4_plain(interop.to_tensor(p), variant)
    assert got.dtype == torch.uint32
    assert np.array_equal(interop.to_numpy(got), want)


@pytest.mark.parametrize("variant", ENCODE)
def test_checked_plain_matches_pallas_all_bytes(variant):
    s = _all_bytes_rows()
    w = np.ascontiguousarray(s).view(np.uint32)
    packed_want, badplane = pk.encode_2bit_nt4_checked(jnp.asarray(w), variant, interpret=True)
    packed, flags = K.encode_2bit_nt4_checked_plain(interop.to_tensor(w), variant)
    assert np.array_equal(interop.to_numpy(packed), np.asarray(packed_want))
    assert np.array_equal(interop.to_numpy(flags) != 0, np.any(np.asarray(badplane) != 0, -1))
    valid = np.isin(s, ALPHABET)
    assert np.array_equal(interop.to_numpy(flags), (~valid).any(-1).astype(np.uint32))


@pytest.mark.parametrize("bad_byte", [ord("N"), ord("X"), 0, 0x80, 0xFF, ord("B")])
def test_checked_flags_exact_rows(bad_byte):
    s = np.ascontiguousarray(_nt4(8, 512, 3)).view(np.uint8)
    s[3, 777] = bad_byte
    s[6, 0] = bad_byte
    w = s.view(np.uint32)
    _, badplane = pk.encode_2bit_nt4_checked(jnp.asarray(w), "mul", interpret=True)
    _, flags = K.encode_2bit_nt4_checked(interop.to_tensor(w), "mul")
    assert list(np.nonzero(interop.to_numpy(flags))[0]) == [3, 6]
    assert np.array_equal(interop.to_numpy(flags) != 0, np.any(np.asarray(badplane) != 0, -1))


def test_mxu_plain_matches_pallas():
    w = _nt4(8, 2048, 4)
    want = np.asarray(pk.encode_2bit_nt4_mxu(jnp.asarray(w), interpret=True))
    got = K.encode_2bit_nt4_mxu_plain(interop.to_tensor(w))
    assert got.dtype == torch.uint32 and got.shape == (8, 512)
    assert np.array_equal(interop.to_numpy(got), want)


def test_mxu_plain_all_bytes_matches_encode():
    w = np.ascontiguousarray(_all_bytes_rows()).view(np.uint32)
    t = interop.to_tensor(w)
    via_bytes = K.encode_2bit_nt4_plain(t, "mul").view(torch.uint32)
    assert np.array_equal(interop.to_numpy(K.encode_2bit_nt4_mxu_plain(t)), interop.to_numpy(via_bytes))


@pytest.mark.parametrize("rows", [_all_bytes_rows(), np.full((5, 48), ord("a"), np.uint8)])
def test_mxu_checked_plain_flags_match_checked(rows):
    t = interop.to_tensor(np.ascontiguousarray(rows).view(np.uint32))
    words, flags = K.encode_2bit_nt4_mxu(t, checked=True)
    _, want_flags = K.encode_2bit_nt4_checked_plain(t)
    assert np.array_equal(interop.to_numpy(words), interop.to_numpy(K.encode_2bit_nt4_mxu_plain(t)))
    assert flags.dtype == torch.uint32
    assert np.array_equal(interop.to_numpy(flags), interop.to_numpy(want_flags))
    assert np.array_equal(interop.to_numpy(flags), (~np.isin(rows, ALPHABET)).any(-1).astype(np.uint32))


def _every_byte_blocks(rows: int, lanes: int, seed: int) -> list[np.ndarray]:
    """Blocks u8[rows, 4 * lanes] in which, together, every byte value sits
    at every byte position of a lane (lane i of the blocks laid end to end
    holds (i + 64 p) % 256 at byte p), then one block of random bytes."""
    n = rows * lanes
    i = np.arange(-(-256 // n) * n).reshape(-1, 1)
    every = ((i + 64 * np.arange(4)) % 256).astype(np.uint8).reshape(-1, rows, 4 * lanes)
    rand = np.random.default_rng(seed).integers(0, 256, (1, rows, 4 * lanes), dtype=np.uint8)
    return list(np.concatenate([every, rand]))


def _oracle_words(s: np.ndarray) -> np.ndarray:
    """The host oracle's packed words of each row of u8[R, 16 k], as u32[R, k]."""
    return np.stack([native.n_to_bits(row).view(np.uint32)[: row.size // 16] for row in s])


@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("lanes", PEXT_C)
def test_mxu_plain_steps_match_reference(rows, lanes):
    """The plain version's plane-gather steps, tolerance 0, against the
    reference's Pallas kernel (interpret mode; its 512-lane tiles directly,
    narrower rows through its padded words form) and the host oracle, on
    every byte value at every lane position; its checked flags against the
    checked encode's and numpy's."""
    blocks = _every_byte_blocks(rows, lanes, 40 + lanes + rows)
    s = np.concatenate(blocks)
    got = np.concatenate([interop.to_numpy(K.encode_2bit_nt4_mxu_plain(interop.to_tensor(b.view(np.uint32))))
                          for b in blocks])
    assert got.dtype == np.uint32 and got.shape == (s.shape[0], lanes // 4)
    assert np.array_equal(got, np.asarray(pk.encode_2bit_words_mxu(jnp.asarray(s), interpret=True)))
    if lanes % 512 == 0:
        want = pk.encode_2bit_nt4_mxu(jnp.asarray(s.view(np.uint32)), interpret=True)
        assert np.array_equal(got, np.asarray(want))
    assert np.array_equal(got, _oracle_words(s))
    for b in blocks:
        t = interop.to_tensor(b.view(np.uint32))
        words, flags = K.encode_2bit_nt4_mxu_plain(t, checked=True)
        assert np.array_equal(interop.to_numpy(words), interop.to_numpy(K.encode_2bit_nt4_mxu_plain(t)))
        assert np.array_equal(interop.to_numpy(flags), interop.to_numpy(K.encode_2bit_nt4_checked_plain(t)[1]))
        assert np.array_equal(interop.to_numpy(flags), (~np.isin(b, ALPHABET)).any(-1).astype(np.uint32))


@pytest.mark.parametrize("where", ["first", "last"])
@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("lanes", PEXT_C)
def test_mxu_checked_plain_flags_first_and_last_nt(lanes, rows, where):
    """A bad byte at the first or the last nt of row 0 (and at the other
    end of row 2, with row 1 clean): the checked plain version flags exactly
    those rows, as the checked encode and numpy do, and its words equal the
    reference's."""
    s = np.random.default_rng(60 + lanes + rows).choice(ALPHABET, size=(rows, 4 * lanes))
    first = where == "first"
    s[0, 0 if first else -1] = INVALID[lanes % len(INVALID)]
    if rows == 3:
        s[2, -1 if first else 0] = INVALID[(lanes + 1) % len(INVALID)]
    t = interop.to_tensor(s.view(np.uint32))
    words, flags = K.encode_2bit_nt4_mxu_plain(t, checked=True)
    assert np.array_equal(interop.to_numpy(words), _oracle_words(s))
    want = (~np.isin(s, ALPHABET)).any(-1).astype(np.uint32)
    assert want.tolist() == ([1, 0, 1] if rows == 3 else [1])
    assert np.array_equal(interop.to_numpy(flags), want)
    assert np.array_equal(interop.to_numpy(flags), interop.to_numpy(K.encode_2bit_nt4_checked_plain(t)[1]))
    # the wrapper on a CPU tensor runs the same plain version
    got_words, got_flags = K.encode_2bit_nt4_mxu(t, checked=True)
    assert np.array_equal(interop.to_numpy(got_words), interop.to_numpy(words))
    assert np.array_equal(interop.to_numpy(got_flags), want)


@pytest.mark.parametrize("lanes", RAGGED)
def test_wrappers_on_cpu_ragged_lanes(lanes):
    """Any lane count encodes/decodes; packed byte j holds nt 4j..4j+3."""
    w = _nt4(3, lanes, 10 + lanes)
    t = interop.to_tensor(w)
    flat = np.ascontiguousarray(w).view(np.uint8).reshape(-1)
    want = oracle.n_to_bits_lut(flat).view(np.uint8)[: 3 * lanes]
    for v in ENCODE:
        packed = K.encode_2bit_nt4(t, v)
        assert np.array_equal(interop.to_numpy(packed).reshape(-1), want)
    back = K.decode_2bit_nt4(packed)
    upper = flat & 0xDF
    upper[upper == ord("U")] = ord("T")
    assert np.array_equal(interop.to_numpy(back).view(np.uint8).reshape(-1), upper)


@pytest.mark.parametrize("variant", ENCODE + ("mxu",))
def test_words_adapters_match_pallas(variant):
    x = np.random.default_rng(5).choice(ALPHABET, size=(3, 2048))
    x[1, 100] = ord("Z")
    if variant == "mxu":
        want = np.asarray(pk.encode_2bit_words_mxu(jnp.asarray(x), interpret=True))
    else:
        want = np.asarray(pk.encode_2bit_words(jnp.asarray(x), variant, interpret=True))
    got = K.encode_2bit_words(interop.to_tensor(x), variant)
    assert np.array_equal(interop.to_numpy(got), want)
    # the reference checks beside the mul encode for every variant
    want_w, want_bad = pk.encode_2bit_words_checked(
        jnp.asarray(x), "mul" if variant == "mxu" else variant, interpret=True)
    words, bad = K.encode_2bit_words_checked(interop.to_tensor(x), variant)
    assert np.array_equal(interop.to_numpy(words), np.asarray(want_w))
    assert interop.to_numpy(bad).tolist() == np.asarray(want_bad).tolist() == [False, True, False]
    dec = K.decode_2bit_bytes(got)
    assert np.array_equal(interop.to_numpy(dec), np.asarray(pk.decode_2bit_bytes(jnp.asarray(want), interpret=True)))


def test_cpu_dispatch_launches_nothing():
    K.reset_launch_counts()
    t = interop.to_tensor(_nt4(2, 64, 6))
    K.encode_2bit_nt4(t)
    K.encode_2bit_nt4_checked(t)
    K.encode_2bit_nt4_mxu(t)
    K.encode_2bit_nt4_mxu(t, checked=True)
    K.decode_2bit_nt4(K.encode_2bit_nt4(t))
    assert [fn.launches for fn in K.WRAPPERS] == [0] * len(K.WRAPPERS)


def test_wrapper_argument_checks():
    t = interop.to_tensor(_nt4(2, 6, 7))  # C = 6: not whole 16-nt groups
    with pytest.raises(ValueError):
        K.encode_2bit_nt4_checked(t)
    with pytest.raises(ValueError):
        K.encode_2bit_nt4_mxu(t)
    with pytest.raises(ValueError):
        K.encode_2bit_nt4(t, "dot")
    with pytest.raises(ValueError):
        K.decode_2bit_nt4(torch.zeros(2, 4, dtype=torch.uint8), "broadcast")
    with pytest.raises(TypeError):
        K.encode_2bit_nt4(t.view(torch.int32))
    with pytest.raises(TypeError):
        K.decode_2bit_nt4(torch.zeros(8, dtype=torch.uint8))
    with pytest.raises(ValueError):
        K.encode_2bit_words(torch.zeros(2, 17, dtype=torch.uint8))
