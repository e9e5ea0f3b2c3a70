"""The CUDA kernels of both codecs (with their planar forms), the search,
the k-mer path, the sketch path, the Myers scan and the base-5 Peq build on
the card: each against its plain version, the cuda tier against the torch
tier and the oracle, launch counts and refusals; and the bench's table.

Every test here needs a CUDA card and skips without one.  The file imports
no JAX, so it also runs where JAX is not installed; the tests' conftest
does import JAX, so run it there without conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
"""

import json

import numpy as np
import pytest
import torch

from cute_nucleotides_tpu_torch import api, bench, interop, models
from cute_nucleotides_tpu_torch.ops import kernels as K, native, search

pytestmark = pytest.mark.cuda

ALPHABET = np.frombuffer(b"ACGTUacgtu", np.uint8)
ALPHABET_N = np.frombuffer(b"ACGTUNacgtun", np.uint8)
ACGTN = np.frombuffer(b"ACGTN", np.uint8)
B5_MODES = ((False, False), (True, False), (False, True))  # chars, checked, digits
ENCODE = ("mul", "shift", "interleave")
DECODE = ("shuffle", "select", "swar")
RAGGED = (1, 15, 16, 17, 31, 32, 33)
#: (rows, lanes) edges of the pext kernel (#4; 2 groups of 16 nt a thread,
#: 512 a block): odd u32 totals (1, 3, 9, 21, a last thread with 1 group),
#: rows of 16 and 48 nt that split a thread's groups, and totals just past
#: one, two and four blocks' span (513, 1025, 2051)
PEXT_EDGES = ((1, 4), (2, 4), (3, 4), (3, 12), (7, 12), (64, 4), (1, 2052), (3, 684), (41, 100), (1, 4100),
              (1, 8204))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda")


def _nt4(rows: int, lanes: int, seed: int) -> np.ndarray:
    s = np.random.default_rng(seed).choice(ALPHABET, size=(rows, 4 * lanes))
    return np.ascontiguousarray(s).view(np.uint32)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    def as_i32(t):  # comparisons on uint32 may be missing on the card
        return t.view(torch.int32) if t.dtype == torch.uint32 else t

    return torch.equal(as_i32(a).cpu(), as_i32(b).cpu())


@pytest.mark.parametrize("lanes", RAGGED + (4096,))
def test_kernels_match_plain(cuda_device, lanes):
    t = interop.to_tensor(_nt4(5, lanes, 20 + lanes), cuda_device)
    for v in ENCODE:
        assert _same(K.encode_2bit_nt4(t, v), K.encode_2bit_nt4_plain(t, v))
    p = np.random.default_rng(lanes).integers(0, 256, (5, lanes), dtype=np.uint8)
    p = interop.to_tensor(p, cuda_device)
    for v in DECODE:
        assert _same(K.decode_2bit_nt4(p, v), K.decode_2bit_nt4_plain(p, v))
    s = np.ascontiguousarray(_nt4(33, 4 * lanes, 30 + lanes)).view(np.uint8)
    s[::4, -1] = ord("N")
    t = interop.to_tensor(s.view(np.uint32), cuda_device)
    for v in ENCODE:
        out, flags = K.encode_2bit_nt4_checked(t, v)
        pout, pflags = K.encode_2bit_nt4_checked_plain(t, v)
        assert _same(out, pout) and _same(flags, pflags)
        assert interop.to_numpy(flags).nonzero()[0].tolist() == list(range(0, 33, 4))
    assert _same(K.encode_2bit_nt4_mxu(t), K.encode_2bit_nt4_mxu_plain(t))
    words, flags = K.encode_2bit_nt4_mxu(t, checked=True)
    pwords, pflags = K.encode_2bit_nt4_mxu_plain(t, checked=True)
    assert _same(words, pwords) and _same(flags, pflags)
    assert interop.to_numpy(flags).nonzero()[0].tolist() == list(range(0, 33, 4))


@pytest.mark.parametrize("rows,lanes", PEXT_EDGES)
def test_mxu_kernel_edges(cuda_device, rows, lanes):
    s = np.random.default_rng(70 + rows + lanes).choice(ALPHABET, size=(rows, 4 * lanes))
    s[::3, 0] = ord("N")  # the first nt of rows 0, 3, ...
    s[2::3, -1] = 0xFF  # the last nt of rows 2, 5, ...
    bad_rows = [r for r in range(rows) if r % 3 != 1]
    t = interop.to_tensor(s.view(np.uint32), cuda_device)
    words = K.encode_2bit_nt4_mxu(t)
    assert _same(words, K.encode_2bit_nt4_mxu_plain(t))
    want = np.stack([native.n_to_bits(row).view(np.uint32)[:lanes // 4] for row in s])
    assert np.array_equal(interop.to_numpy(words), want)
    words, flags = K.encode_2bit_nt4_mxu(t, checked=True)
    pwords, pflags = K.encode_2bit_nt4_mxu_plain(t, checked=True)
    assert _same(words, pwords) and _same(flags, pflags)
    assert interop.to_numpy(flags).nonzero()[0].tolist() == bad_rows


def test_cuda_tier_matches_torch_tier(cuda_device):
    x = np.random.default_rng(3).choice(ALPHABET, size=(7, 4096))
    x[2, 5] = ord("N")
    cpu, gpu = interop.to_tensor(x), interop.to_tensor(x, cuda_device)
    ref = models.TwoBitCodec(tier="torch")
    words = ref.encode(cpu)
    for v in ENCODE + ("mxu",):
        codec = models.TwoBitCodec(device=cuda_device, encode_variant=v)
        assert codec.tier == "cuda"
        assert _same(codec.encode(gpu), words)
        got_words, bad = codec.encode_checked(gpu)
        assert _same(got_words, words)
        assert interop.to_numpy(bad).tolist() == [False, False, True, False, False, False, False]
    for v in DECODE:
        codec = models.TwoBitCodec(device=cuda_device, decode_variant=v)
        assert torch.equal(codec.decode(interop.to_tensor(interop.to_numpy(words), cuda_device)).cpu(),
                           ref.decode(words))


@pytest.mark.parametrize("n", (0,) + RAGGED + (100_003,))
def test_api_cuda_tier_matches_oracle(cuda_device, n):
    s = np.random.default_rng(n).choice(ALPHABET, size=n)
    want = native.n_to_bits(s)
    for v in ENCODE + ("mxu",):
        assert np.array_equal(api.n_to_bits(s, tier="cuda", variant=v), want)
    for v in DECODE:
        assert np.array_equal(api.bits_to_n(want, n, tier="cuda", variant=v), native.bits_to_n(want, n))


def test_launch_counts_and_alignment(cuda_device):
    K.reset_launch_counts()
    t = interop.to_tensor(_nt4(2, 64, 8), cuda_device)
    K.encode_2bit_nt4(t)
    K.encode_2bit_nt4_checked(t)
    K.encode_2bit_nt4_mxu(t)
    K.encode_2bit_nt4_mxu(t, checked=True)
    K.decode_2bit_nt4(K.encode_2bit_nt4(t))
    assert [fn.launches for fn in K.WRAPPERS] == [2, 1, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0]
    misaligned = torch.zeros(64, dtype=torch.uint8, device=cuda_device)[4:36]
    with pytest.raises(ValueError, match="aligned"):
        K.encode_2bit_nt4(misaligned.view(torch.uint32).view(2, 4))
    with pytest.raises(ValueError, match="contiguous"):
        K.encode_2bit_nt4(interop.to_tensor(_nt4(4, 8, 9), cuda_device)[:, ::2])
    assert K.encode_2bit_nt4.launches == 2


@pytest.mark.parametrize("n_words", (1, 2, 127, 128, 129, 40_000))
def test_b5_kernels_match_plain(cuda_device, n_words):
    x = interop.to_tensor(np.random.default_rng(n_words).choice(ALPHABET_N, size=27 * n_words), cuda_device)
    assert _same(K.encode_b5_stream(x), K.encode_b5_stream_plain(x))
    for bad in (False, True):
        if bad:
            x[27 * n_words // 2] = ord("X")
        words, flag = K.encode_b5_stream(x, checked=True)
        pwords, pflag = K.encode_b5_stream_plain(x, checked=True)
        assert _same(words, pwords) and _same(flag, pflag)
        assert interop.to_numpy(flag).tolist() == [int(bad)]
    words = K.encode_b5_stream_plain(x)
    for corrupt in (False, True):
        if corrupt:
            words.view(torch.int32)[-1] |= -(1 << 31)  # bit 63 of the last word
        for checked, digits in B5_MODES:
            got = K.decode_b5_stream(words, checked, digits)
            want = K.decode_b5_stream_plain(words, checked, digits)
            if checked:
                assert _same(got[0], want[0]) and _same(got[1], want[1])
                assert interop.to_numpy(got[1]).tolist() == [int(corrupt)]
            else:
                assert _same(got, want)


def test_b5_flags_exact_on_every_byte_and_triplet(cuda_device):
    valid = set(ALPHABET_N.tolist())
    for v in range(256):
        x = torch.full((54,), ord("A"), dtype=torch.uint8, device=cuda_device)
        x[v % 54] = v
        _, flag = K.encode_b5_stream(x, checked=True)
        assert interop.to_numpy(flag).tolist() == [int(v not in valid)], v
    t = np.arange(128, dtype=np.uint64)
    w64 = np.concatenate([(t << np.uint64(7 * j)) | (np.uint64(b) << np.uint64(63))
                          for j in range(9) for b in (0, 1)])
    w = interop.u64_to_tensor(w64, cuda_device)
    for checked, digits in B5_MODES:
        got, want = K.decode_b5_stream(w, checked, digits), K.decode_b5_stream_plain(w, checked, digits)
        assert _same(got[0], want[0]) if checked else _same(got, want)
    assert np.array_equal(interop.to_numpy(K.decode_b5_stream(w)), native.bits_to_n2(w64, 27 * w64.size))
    for v in range(128):
        for b in (0, 1):
            one = np.array([(v << (7 * (v % 9))) | (b << 63)], dtype=np.uint64)
            _, flag = K.decode_b5_stream(interop.u64_to_tensor(one, cuda_device), checked=True)
            assert interop.to_numpy(flag).tolist() == [int(v >= 125 or b == 1)], (v, b)


def test_b5_cuda_tier_matches_torch_tier(cuda_device):
    x = np.random.default_rng(4).choice(ALPHABET_N, size=(7, 27 * 150))
    cpu, gpu = interop.to_tensor(x), interop.to_tensor(x, cuda_device)
    ref, codec = models.Base5Codec(tier="torch"), models.Base5Codec(device=cuda_device)
    assert codec.tier == "cuda"
    words = ref.encode(cpu)
    assert _same(codec.encode(gpu), words)
    got_words, bad = codec.encode_checked(gpu)
    assert _same(got_words, words) and not bool(bad)
    gw = interop.to_tensor(interop.to_numpy(words), cuda_device)
    assert torch.equal(codec.decode(gw).cpu(), ref.decode(words))
    out, bad = codec.decode_checked(gw)
    assert torch.equal(out.cpu(), ref.decode(words)) and not bool(bad)


@pytest.mark.parametrize("n", (0, 1, 26, 27, 28, 53, 54, 55, 100_003))
def test_b5_api_cuda_tier_matches_oracle(cuda_device, n):
    s = np.random.default_rng(n).choice(ALPHABET_N, size=n)
    want = native.n_to_bits2(s)
    assert np.array_equal(api.n_to_bits2(s, tier="cuda"), want)
    assert np.array_equal(api.bits_to_n2(want, n, tier="cuda"), native.bits_to_n2(want, n))


def test_b5_launch_counts_and_alignment(cuda_device):
    K.reset_launch_counts()
    x = interop.to_tensor(np.random.default_rng(5).choice(ALPHABET_N, size=27 * 64), cuda_device)
    w = K.encode_b5_stream(x)
    K.encode_b5_stream(x, checked=True)
    for checked, digits in B5_MODES:
        K.decode_b5_stream(w, checked, digits)
    assert [fn.launches for fn in K.WRAPPERS] == [0, 0, 0, 0, 2, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0]
    with pytest.raises(ValueError, match="aligned"):
        K.encode_b5_stream(torch.zeros(64, dtype=torch.uint8, device=cuda_device)[4:31])
    with pytest.raises(ValueError, match="checked digit"):
        K.decode_b5_stream(w, checked=True, digits=True)
    assert K.encode_b5_stream.launches == 2 and K.decode_b5_stream.launches == 3


SEARCH_QUERIES = (1, 7, 16, 17, 32, 33, 45, 141)


def _planted(rng, n: int, alpha: bytes, m: int, wildcard: bytes) -> tuple[np.ndarray, bytes]:
    """A seeded stream of n nt over alpha and an m-nt query from it, with
    every fifth byte a wildcard and hits planted at the last start, in the
    middle and at 0."""
    a = np.frombuffer(alpha, np.uint8)
    q = bytearray(rng.choice(a, m).tobytes())
    q[::5] = wildcard * len(q[::5])
    s = rng.choice(a, n)
    concrete = np.frombuffer(bytes(q).replace(wildcard, alpha[:1]), np.uint8)
    for p in (n - m, n // 2, 0):  # 0 last: its hit survives any overlap
        if 0 <= p <= n - m:
            s[p : p + m] = concrete
    return s, bytes(q)


@pytest.mark.parametrize("n", RAGGED + (5000, 100_003))
def test_search_2bit_kernel_matches_plain(cuda_device, n):
    rng = np.random.default_rng(n)
    for m in SEARCH_QUERIES + (8200,):
        if m > n:
            continue
        s, query = _planted(rng, n, b"ACGT", m, b"N")
        w = interop.u64_to_tensor(native.n_to_bits(s), cuda_device)
        q, care, _ = search.compile_query(query)
        got = K.match_bits_stream(w, q, care, n - m + 1)
        assert _same(got, K.match_bits_stream_plain(w, q, care, n - m + 1)), (n, m)
        assert 0 in search.match_positions(w, n, query).tolist()
    w = interop.u64_to_tensor(native.n_to_bits(np.full(n, ord("A"), np.uint8)), cuda_device)
    for m in (1, 17, 45):  # poly-A on poly-A: every anchor fires
        if m <= n:
            assert int(search.match_count(w, n, b"A" * m)) == n - m + 1


#: 2-bit word counts off the kernel's 8-word run: a few words, and beside its
#: block's 1024 words and two blocks
SEARCH_W2 = (3, 5, 9, 1021, 1025, 2053)


@pytest.mark.parametrize("W", SEARCH_W2)
def test_search_2bit_kernel_edges(cuda_device, W):
    """All-N queries (no step: every start matches) and a 4800-nt query
    anchored in its last word, whose anchor steps read 300 words past a
    thread's own, past the 256 a block stages."""
    rng = np.random.default_rng(W)
    long_q = bytearray(rng.choice(np.frombuffer(b"ACGT", np.uint8), 300 * 16).tobytes())
    long_q[: 299 * 16 : 5] = b"N" * len(long_q[: 299 * 16 : 5])
    assert K._match_table(*search.compile_query(bytes(long_q))[:2])[3] == 299
    n = 16 * W - 5
    for query in (b"N", b"N" * 16, b"N" * 17, b"GATTACA", bytes(long_q)):
        m = len(query)
        if m > n:
            continue
        s = rng.choice(np.frombuffer(b"ACGT", np.uint8), n)
        for p in (n - m, n // 3, 0):
            s[p : p + m] = np.frombuffer(query.replace(b"N", b"A"), np.uint8)
        w = interop.u64_to_tensor(native.n_to_bits(s), cuda_device)[:W]
        q, care, _ = search.compile_query(query)
        for n_starts in (n - m + 1, 16 * W - 8 * 16 - 3, 16 * W):
            got = K.match_bits_stream(w, q, care, n_starts)
            assert _same(got, K.match_bits_stream_plain(w, q, care, n_starts)), (W, m, n_starts)
        hits = search.match_positions(w, n, query)
        assert {0, n // 3, n - m} <= set(hits.tolist())
        if set(query) == {ord("N")}:
            assert hits.size == n - m + 1


def test_search_2bit_refuses_inconsistent_head(cuda_device):
    """cn_match_2bit returns cudaErrorInvalidValue (1) before any launch for
    a table head that does not hold together; a consistent one launches."""
    from cute_nucleotides_tpu_torch.ops import _build

    lib = _build.load()
    w = torch.zeros(64, dtype=torch.int32, device=cuda_device)
    out = torch.empty_like(w)
    table = torch.zeros(16, dtype=torch.int32, device=cuda_device)
    stream = torch.cuda.current_stream().cuda_stream
    # n_first, n_steps, look, anchor
    for head in ((2, 1, 1, 0), (0, 1, 1, 0), (1, 1, 0, 0), (1, 1, 1, 1), (-1, 0, 1, 0), (0, 0, 1, -1)):
        assert lib.cn_match_2bit(w.data_ptr(), 64, table.data_ptr(), *head, 100, out.data_ptr(), stream) == 1, head
    assert lib.cn_match_2bit(w.data_ptr(), 64, table.data_ptr(), 1, 1, 1, 0, 100, out.data_ptr(), stream) == 0
    torch.cuda.synchronize()


#: base-5 stream lengths in nt: ragged short streams, then 1, 2 and 3 words,
#: and word counts at and one on each side of the kernel's run (4 words a
#: thread), its block span (512 words) and two spans, some with a ragged tail
SEARCH_B5_NT = (1, 26, 27, 28, 31, 32, 33, 54, 81, 27 * 4, 27 * 5, 27 * 127, 27 * 128, 27 * 129,
                27 * 129 + 13, 27 * 511, 27 * 512, 27 * 513 + 13, 27 * 1024 + 5)


@pytest.mark.parametrize("n", SEARCH_B5_NT)
def test_search_b5_kernel_matches_plain(cuda_device, n):
    """Planted queries (every fifth byte '?'), random queries with 10% '?'
    at random lengths up to 1024 nt, and poly-A against all-A and
    'A?A?...' queries, where every anchor tap fires."""
    rng = np.random.default_rng(n)
    for m in SEARCH_QUERIES + (1024,):
        if m > n:
            continue
        s, query = _planted(rng, n, b"ACGTN", m, b"?")
        w = interop.u64_to_tensor(native.n_to_bits2(s), cuda_device)
        qc = search.compile_query_b5(query)
        got = K.match_b5_bits_stream(w, qc, n - m + 1)
        assert _same(got, K.match_b5_bits_stream_plain(w, qc, n - m + 1)), (n, m)
        assert 0 in search.match_positions_b5(w, n, query).tolist()
    for m in rng.integers(1, min(n, 1024) + 1, 4).tolist():
        q = rng.choice(np.frombuffer(b"ACGTN", np.uint8), m)
        q[rng.random(m) < 0.1] = ord("?")
        qc = search.compile_query_b5(q.tobytes())
        assert _same(K.match_b5_bits_stream(w, qc, n - m + 1), K.match_b5_bits_stream_plain(w, qc, n - m + 1)), (n, m)
    w = interop.u64_to_tensor(native.n_to_bits2(np.full(n, ord("A"), np.uint8)), cuda_device)
    for query in (b"A", b"A" * 17, b"A" * 45, (b"A?" * 23)[:45], (b"A?" * 512)[:1023]):
        m = len(query)
        if m <= n:
            qc = search.compile_query_b5(query)
            got = K.match_b5_bits_stream(w, qc, n - m + 1)
            assert _same(got, K.match_b5_bits_stream_plain(w, qc, n - m + 1)), (n, query[:8])
            assert int(search.match_count_b5(w, n, query)) == n - m + 1


def test_search_b5_kernel_on_every_triplet(cuda_device):
    """All 128 triplet values in every slot, with and without bit 63, against
    literal-N and wildcard queries: corrupt triplets never match N."""
    t = np.arange(128, dtype=np.uint64)
    w64 = np.concatenate([(t << np.uint64(7 * j)) | (np.uint64(b) << np.uint64(63))
                          for j in range(9) for b in (0, 1)])
    w = interop.u64_to_tensor(w64, cuda_device)
    n = 27 * w64.size
    for query in (b"N", b"NN", b"?N", b"N?A", b"AAN", b"CAN", b"?"):
        m = len(query)
        qc = search.compile_query_b5(query)
        assert _same(K.match_b5_bits_stream(w, qc, n - m + 1), K.match_b5_bits_stream_plain(w, qc, n - m + 1))
        assert np.array_equal(search.match_positions_b5(w, n, query),
                              np.flatnonzero(interop.to_numpy(search.match_mask_b5(w, n, query))))


def test_search_launch_counts(cuda_device):
    K.reset_launch_counts()
    s = np.random.default_rng(9).choice(ALPHABET_N, 27 * 600)
    w2 = interop.u64_to_tensor(native.n_to_bits(s), cuda_device)
    w5 = interop.u64_to_tensor(native.n_to_bits2(s), cuda_device)
    search.match_positions(w2, s.size, b"GATTACA")
    search.match_count(w2, s.size, b"GATTACA")
    search.match_positions_b5(w5, s.size, b"GAT?ACA")
    search.match_positions_b5(w5[:1000], 13500, b"GAT?ACA")  # under 1024 u32: the mask tier
    search.match_count_b5(w5, s.size, b"A" * 1025)  # over 1024 nt: the mask tier
    assert [fn.launches for fn in K.WRAPPERS] == [0, 0, 0, 0, 0, 0, 2, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0]
    with pytest.raises(ValueError, match="aligned"):
        K.match_bits_stream(w2[1:], *search.compile_query(b"ACG")[:2], 10)


KMER_W = (1, 511, 512, 513)


@pytest.mark.parametrize("W", KMER_W)
def test_kmer_codes_kernels_match_plain(cuda_device, W):
    rng = np.random.default_rng(W)
    w, n, n2 = (interop.to_tensor(rng.integers(0, 2**32, (37, W), dtype=np.uint32), cuda_device) for _ in range(3))
    for k in range(1, 16):
        assert _same(K.kmer_codes_planar(w, n, k), K.kmer_codes_planar_plain(w, n, k)), k
    for k in range(16, 32):
        lo, hi = K.kmer_codes_planar_pair(w, n, n2, k)
        plo, phi = K.kmer_codes_planar_pair_plain(w, n, n2, k)
        assert _same(lo, plo) and _same(hi, phi), k


@pytest.mark.parametrize("case", ("zeros", "max", "one code", "random", "out of range"))
def test_hist_codes_kernel_matches_plain(cuda_device, case):
    rng = np.random.default_rng(7)
    n = (1 << 23) + 3  # over 32768 of one code per block on 132 SMs (the carry), and a ragged tail
    codes = {"zeros": np.zeros(n), "max": np.full(n, 65535), "one code": np.full(n, 12345),
             "random": rng.integers(0, 65536, n),
             "out of range": rng.integers(-70000, 140000, n)}[case].astype(np.int32)
    if case == "random":
        codes[: n // 3] = 0  # a masked block, as the callers leave it
    t = interop.to_tensor(codes.reshape(1, n), cuda_device)
    got = K.hist_codes(t)
    assert _same(got, K.hist_codes_plain(t))
    inside = codes[(codes >= 0) & (codes < 65536)]
    assert np.array_equal(interop.to_numpy(got).reshape(-1), np.bincount(inside, minlength=65536))


def test_kmer_cuda_matches_torch_tier(cuda_device):
    from cute_nucleotides_tpu_torch.ops import kmer

    rng = np.random.default_rng(11)
    flat = rng.integers(0, 2**32, 700, dtype=np.uint32)
    cpu, gpu = interop.to_tensor(flat), interop.to_tensor(flat, cuda_device)
    length = 700 * 16 - 5
    K.reset_launch_counts()
    for k in (2, 8):
        for canonical in (False, True):
            assert _same(kmer.kmer_histogram(gpu, length, k, canonical=canonical),
                         kmer.kmer_histogram(cpu, length, k, canonical=canonical))
    for k in (5, 15, 16, 21, 31):
        got = kmer.kmer_counts(gpu, length, k, canonical=True)
        want = kmer.kmer_counts(cpu, length, k, canonical=True)
        assert all(_same(a, b) for a, b in zip(got, want)), k
    batch = rng.integers(0, 2**32, (9, 37), dtype=np.uint32)
    lengths = rng.integers(0, 37 * 16 + 1, 9).astype(np.int32)
    for k in (3, 8, 11):
        assert _same(kmer.kmer_histogram_batch(interop.to_tensor(batch, cuda_device), lengths, k, canonical=True),
                     kmer.kmer_histogram_batch(interop.to_tensor(batch), lengths, k, canonical=True))
    assert [fn.launches for fn in K.WRAPPERS][8:] == [2 + 2 + 3 + 2, 3, 4 + 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0]


def test_stats_cuda_matches_torch_tier(cuda_device, tmp_path, capsys):
    from cute_nucleotides_tpu_torch import cli

    rng = np.random.default_rng(12)
    fa = tmp_path / "reads.fa"
    with open(fa, "wb") as f:
        for i, n in enumerate((0, 5, 150, 3000, 100_003)):
            f.write(b">r%d\n%s\n" % (i, rng.choice(ALPHABET, n).tobytes()))
    for argv in (["-k", "8", "--canonical"], ["-k", "10"], ["-k", "15"], ["-k", "21", "--canonical", "--top", "10"]):
        out = {}
        for tier in ("cuda", "torch"):
            assert cli.main(["stats", str(fa), *argv, "--tier", tier]) == 0
            out[tier] = capsys.readouterr().out
        assert out["cuda"] == out["torch"], argv


def _plant_sentinel(words: np.ndarray, pos: int, k: int) -> None:
    """Write at nt ``pos`` a canonical k-mer (16 < k <= 31) whose pair hash
    fmix32(lo ^ fmix32(hi)) is 0xFFFFFFFF: fmix32 is invertible, so lo
    follows from hi."""
    def mix(h):
        h ^= h >> 16
        h = (h * 0x85EBCA6B) % 2**32
        h ^= h >> 13
        h = (h * 0xC2B2AE35) % 2**32
        return h ^ (h >> 16)

    h = 0xFFFFFFFF ^ 0xFFFF  # the inverse of fmix32, applied to 0xFFFFFFFF
    h = (h * pow(0xC2B2AE35, -1, 2**32)) % 2**32
    h ^= (h >> 13) ^ (h >> 26)
    h = (h * pow(0x85EBCA6B, -1, 2**32)) % 2**32
    unmixed = h ^ (h >> 16)
    for hi in range(1, 1 << 16):
        code = (unmixed ^ mix(hi)) | hi << 32
        rc = sum((((code >> (2 * j)) & 3) ^ 2) << (2 * (k - 1 - j)) for j in range(k))
        if code < 4**k and code <= rc:
            break
    assert mix((code & 0xFFFFFFFF) ^ mix(code >> 32)) == 0xFFFFFFFF
    q, s = divmod(pos, 16)
    v = sum(int(words[q + j]) << (32 * j) for j in range(3))
    v = (v & ~(((1 << (2 * k)) - 1) << (2 * s))) | code << (2 * s)
    for j in range(3):
        words[q + j] = (v >> (32 * j)) & 0xFFFFFFFF


@pytest.mark.parametrize("W", KMER_W + (3000,))
def test_kmer_hashes_kernel_matches_plain(cuda_device, W):
    """#12 at every k in 16..31, canonical and forward, as one stream, as
    rows of 7 words (seg) and with n_valid inside the stream."""
    flat = np.random.default_rng(W).integers(0, 2**32, W + 2, dtype=np.uint32)
    if W >= 512:
        _plant_sentinel(flat, 16 * 500 + 3, 21)
    w = interop.to_tensor(flat[:W], cuda_device)
    for k in range(16, 32):
        for canonical in (False, True):
            for seg, n_valid in ((0, 16 * W - k + 1), (7, 16 * W), (0, 8 * W + 5)):
                got = K.kmer_hashes_planar_pair(w, k, n_valid, canonical=canonical, seg=seg)
                want = K.kmer_hashes_planar_pair_plain(w, k, n_valid, canonical=canonical, seg=seg)
                assert _same(got, want), (k, canonical, seg, n_valid)


#: windows of #14: powers of two and their neighbours move the doubling's
#: last offset; 2049 - k (the largest) is added per k
MZ_WINDOWS = (2, 3, 8, 9, 10, 16, 17, 33, 64, 1024, 1025)


@pytest.mark.parametrize("nt", (16384 + 5, 32768, 100_003))
def test_minimizer_kernel_matches_plain(cuda_device, nt):
    """#14 on random and poly-A streams whose n is a multiple of neither
    block span (2048 and 8192 positions), at every window of MZ_WINDOWS."""
    rng = np.random.default_rng(nt)
    words = rng.integers(0, 2**32, -(-nt // 16), dtype=np.uint32)
    poly_a = np.zeros_like(words)  # every hash ties
    for label, stream in (("random", words), ("poly-A", poly_a)):
        w = interop.to_tensor(stream, cuda_device)
        for k in (1, 7, 15):
            for win in MZ_WINDOWS + (2048 - k + 1,):
                for canonical in (False, True):
                    n = nt - k + 1
                    got = K.minimizer_bits_stream(w, n, k, win, canonical=canonical)
                    want = K.minimizer_bits_stream_plain(w, n, k, win, canonical=canonical)
                    assert _same(got, want), (label, k, win, canonical)


def test_sketch_cuda_matches_torch_tier(cuda_device):
    from cute_nucleotides_tpu_torch.ops import kmer, sketch

    rng = np.random.default_rng(13)
    length = 16 * 3000 + 7
    flat = rng.integers(0, 2**32, -(-length // 16), dtype=np.uint32)
    cpu, gpu = interop.to_tensor(flat), interop.to_tensor(flat, cuda_device)
    K.reset_launch_counts()
    for k in (9, 21, 31):
        assert _same(kmer.kmer_hashes_planar(gpu, length, k), kmer.kmer_hashes_planar(cpu, length, k))
        assert _same(sketch.bottom_k_sketch(gpu, length, k, 1000), sketch.bottom_k_sketch(cpu, length, k, 1000))
        got = sketch.frac_sketch(gpu, length, k, scale=8, cap=1 << 14)
        want = sketch.frac_sketch(cpu, length, k, scale=8, cap=1 << 14)
        assert _same(got[0], want[0]) and int(got[1]) == int(want[1])
    for k, w in ((15, 10), (7, 64), (1, 5)):
        got, want = kmer.minimizers(gpu, length, k, w), kmer.minimizers(cpu, length, k, w)
        assert _same(got[0], want[0]) and _same(got[1], want[1])
        assert _same(kmer.minimizer_bits(gpu, length, k, w), kmer.minimizer_bits(cpu, length, k, w))
    batch = rng.integers(0, 2**32, (9, 37), dtype=np.uint32)
    lengths = rng.integers(0, 37 * 16 + 1, 9).astype(np.int32)
    invalid = rng.random((9, 37 * 16)) < 0.01
    for k in (5, 16, 21):
        got = sketch.bottom_k_sketch_batch(interop.to_tensor(batch, cuda_device), lengths, k, 300,
                                           invalid=interop.to_tensor(invalid, cuda_device))
        assert _same(got, sketch.bottom_k_sketch_batch(interop.to_tensor(batch), lengths, k, 300, invalid=invalid))
    counts = dict(zip((fn.__name__ for fn in K.WRAPPERS), (fn.launches for fn in K.WRAPPERS)))
    # #12: hashes, bottom-s and frac at k = 21 and 31, two batch sketches; #14: two minimizers calls for each
    # of (15, 10) and (7, 64) and (1, 5)
    assert counts["kmer_hashes_planar_pair"] == 3 * 2 + 2 and counts["minimizer_bits_stream"] == 6
    assert counts["kmer_codes_planar"] == 3 + 1


def test_sketch_cli_cuda_matches_torch_tier(cuda_device, tmp_path, capsys):
    from cute_nucleotides_tpu_torch import cli

    rng = np.random.default_rng(14)
    paths = []
    for name in ("a", "b"):
        fq = tmp_path / f"{name}.fq"
        with open(fq, "wb") as f:
            for i in range(300):
                s = rng.choice(np.frombuffer(b"ACGTNacgt", np.uint8), int(rng.integers(0, 400))).tobytes()
                f.write(b"@r%d\n%s\n+\n%s\n" % (i, s, b"I" * len(s)))
        paths.append(str(fq))
    for argv in (["-k", "21"], ["-k", "15", "--scale", "4", "-s", "4096"], ["-k", "31", "--no-canonical", "--batch", "7"]):
        out = {}
        for tier in ("cuda", "torch"):
            assert cli.main(["sketch", *paths, *argv, "--tier", tier]) == 0
            out[tier] = capsys.readouterr()
        assert out["cuda"] == out["torch"], argv


def _every_triplet_words() -> np.ndarray:
    """Every triplet value 0..127 in every slot, with and without bit 63."""
    t = np.arange(128, dtype=np.uint64)
    return np.concatenate([(t << np.uint64(7 * j)) | (np.uint64(b) << np.uint64(63)) for j in range(9) for b in (0, 1)])


@pytest.mark.parametrize("n_words", (1, 2, 127, 128, 129, 40_001))
def test_gc_b5_kernel_matches_plain(cuda_device, n_words):
    """#7 on random words (any triplet, bit 63 on some), and on every triplet
    value in every slot; the seqops route and its count of C and G bytes."""
    from cute_nucleotides_tpu_torch.ops import seqops

    rng = np.random.default_rng(n_words)
    w64 = rng.integers(0, 2**63, n_words, dtype=np.uint64) | (rng.integers(0, 2, n_words, dtype=np.uint64) << np.uint64(63))
    for words in (w64, _every_triplet_words()):
        w = interop.u64_to_tensor(words, cuda_device)
        assert _same(K.gc_b5_stream(w), K.gc_b5_stream_plain(w))
    s = np.random.default_rng(3).choice(ALPHABET_N, 27 * 600 + 5)
    w = interop.u64_to_tensor(native.n_to_bits2(s), cuda_device)
    K.reset_launch_counts()
    assert int(seqops.gc_content_packed_b5(w)) == int(np.isin(s, np.frombuffer(b"CGcg", np.uint8)).sum())
    assert K.gc_b5_stream.launches == 1
    with pytest.raises(ValueError, match="aligned"):
        K.gc_b5_stream(w[2:])


def _sort_cases(n: int) -> dict:
    rng = np.random.default_rng(n)
    asc = np.arange(n, dtype=np.uint32)
    kmer_hi = rng.integers(0, 1 << 10, n, dtype=np.uint64).astype(np.uint32)
    kmer_lo = rng.integers(0, 5000, n, dtype=np.uint64).astype(np.uint32)
    kmer_hi[-n // 5 :] = kmer_lo[-n // 5 :] = 0xFFFFFFFF
    plain_hi = rng.integers(0, 1 << 10, n, dtype=np.uint64).astype(np.uint32)  # digits 6 and 7 are all 0
    return {"k-mer keys, no sentinels": (plain_hi, rng.integers(0, 5000, n, dtype=np.uint64).astype(np.uint32)),
            "random": (rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
                       rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)),
            "all equal": (np.full(n, 7, np.uint32), np.full(n, 3, np.uint32)),
            "descending": (asc[::-1].copy(), asc.copy()),
            "ties on hi": (np.zeros(n, np.uint32), asc[::-1].copy()),
            "sign bit": (rng.integers(2**31 - 4, 2**31 + 4, n, dtype=np.uint64).astype(np.uint32),
                         rng.integers(2**31 - 4, 2**31 + 4, n, dtype=np.uint64).astype(np.uint32)),
            "k-mer keys": (kmer_hi, kmer_lo)}


#: one tile of #18's passes is 4096 keys: one tile, one tile + 1, many
#: tiles, and sizes past the look-back's first few tiles
@pytest.mark.parametrize("n", (2, 4096, 4097, 4133, 16383, 37 * 4096 + 5, (1 << 20) + 1, (1 << 22) + 3))
def test_sort_pairs_bitonic_kernel_matches_plain(cuda_device, n):
    """#18 against its plain version and prefer="lax" on every key shape;
    prefer="bitonic" launches it inside the envelope."""
    from cute_nucleotides_tpu_torch.ops import sort

    for label, (hi, lo) in _sort_cases(n).items():
        th, tl = interop.to_tensor(hi, cuda_device), interop.to_tensor(lo, cuda_device)
        got = K.sort_pairs_bitonic(th, tl)
        for g, p, s in zip(got, K.sort_pairs_bitonic_plain(th, tl), sort.sort_pairs(th, tl)):
            assert _same(g, p) and _same(g, s), (label, n)
        K.reset_launch_counts()
        sort.sort_pairs(th, tl, prefer="bitonic")
        assert K.sort_pairs_bitonic.launches == int(n >= 2049), (label, n)


@pytest.mark.parametrize("n", (4096, 4097))
def test_sort_pairs_radix_refuses_short_status(cuda_device, n):
    """#18's entry point checks the status array against its own tile size:
    one word short of the wrapper's size is cudaErrorInvalidValue (1), with
    nothing launched."""
    import torch

    from cute_nucleotides_tpu_torch.ops import _build

    hi = torch.zeros(n, dtype=torch.int32, device=cuda_device).view(torch.uint32)
    keys = torch.empty(2 * n, dtype=torch.int64, device=cuda_device)
    hist = torch.empty(8 * 256, dtype=torch.int32, device=cuda_device)
    words = (-(-n // K.SORT_TILE) + 1) * 256
    status = torch.empty(words, dtype=torch.int32, device=cuda_device)
    out = torch.empty_like(hi)
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    fn = _build.load().cn_sort_pairs_radix
    args = (hi.data_ptr(), hi.data_ptr(), keys.data_ptr(), hist.data_ptr(), status.data_ptr())
    assert fn(*args, words - 1, out.data_ptr(), out.data_ptr(), n, stream) == 1
    assert fn(*args, words, out.data_ptr(), out.data_ptr(), n, stream) == 0
    torch.cuda.synchronize(cuda_device)


@pytest.mark.parametrize("R", (1, 2, 37, 128))
def test_planar_kernels_match_plain(cuda_device, R):
    """#15 on random rows and all 256 byte values, #16 (padded, compact) and
    #17 on random words and every triplet value in every slot with and
    without bit 63: against their plain versions and the interleaved
    kernels #5 and #6; the pad lanes 'AAAA'."""
    rng = np.random.default_rng(R)
    inputs = [rng.choice(ALPHABET_N, size=(R, K.B5_ROW_NT))]
    if R == 2:
        inputs += [np.arange(256, dtype=np.uint8).repeat(27).reshape(2, -1),
                   np.tile(np.arange(256, dtype=np.uint8), 27).reshape(2, -1)]
    for host in inputs:
        x = interop.to_tensor(host, cuda_device)
        lo, hi = K.encode_b5_planar(x)
        plo, phi = K.encode_b5_planar_plain(x)
        assert _same(lo, plo) and _same(hi, phi)
        assert _same(K._interleave(lo, hi), K.encode_b5_stream(x.view(-1)))
    for w64 in (rng.integers(0, 2**64, R * 128, dtype=np.uint64), _every_triplet_words()):
        pair = w64.view(np.uint32).reshape(-1, 128, 2)
        lo, hi = (interop.to_tensor(np.ascontiguousarray(pair[..., i]), cuda_device) for i in (0, 1))
        want = K.decode_b5_stream(interop.u64_to_tensor(w64, cuda_device))
        assert _same(K.decode_b5_panels(lo, hi), K.decode_b5_panels_plain(lo, hi))
        assert _same(K.decode_b5_panels(lo, hi).view(-1), want)
        for padded in (True, False):
            assert _same(K.decode_b5_nt4_panels(lo, hi, padded=padded),
                         K.decode_b5_nt4_panels_plain(lo, hi, padded=padded))
        lanes = K.decode_b5_nt4_panels(lo, hi).view(torch.int32).view(-1, 8, 112)
        assert _same(lanes[:, :, :108].contiguous().view(torch.uint8).view(-1), want)
        assert bool((lanes[:, :, 108:] == 0x41414141).all())


def test_planar_launch_counts_and_refusals(cuda_device):
    K.reset_launch_counts()
    x = interop.to_tensor(np.random.default_rng(9).choice(ALPHABET_N, size=(3, K.B5_ROW_NT)), cuda_device)
    lo, hi = K.encode_b5_planar(x)
    K.decode_b5_nt4_panels(lo, hi)
    K.decode_b5_nt4_panels(lo, hi, padded=False)
    K.decode_b5_panels(lo, hi)
    K.encode_b5_planar(x[:0])  # no rows: nothing launched
    assert [fn.launches for fn in K.WRAPPERS][-6:] == [1, 2, 1, 0, 0, 0] and sum(fn.launches for fn in K.WRAPPERS) == 4
    with pytest.raises(ValueError, match="aligned"):
        K.encode_b5_planar(torch.zeros(2 * K.B5_ROW_NT, dtype=torch.uint8, device=cuda_device)[4 : 4 + K.B5_ROW_NT]
                           .view(1, -1))
    with pytest.raises(ValueError, match="contiguous"):
        K.decode_b5_panels(lo.t().contiguous().t(), hi)
    with pytest.raises(ValueError, match="inputs on"):
        K.decode_b5_panels(lo, hi.cpu())


def test_bench_table_on_the_card(cuda_device):
    """The bench's rows at a small scale with the real timer: every row above
    0, none failed, and the planar rows launched #15-#17."""
    from cute_nucleotides_tpu_torch import bench

    rows = bench.build_rows(cuda_device, scale=512, full=True)
    results = bench.run_rows(rows, bench.cuda_timer, bench.Results())
    assert not results.failed and len(results.gibs) == 49 and all(v > 0 for v in results.gibs.values())
    calls = 1 + bench.TRIALS * bench.K_CORE + 1  # warm-up, timed runs, latency call
    align_calls = 1 + bench.TRIALS * bench.K_ALIGN + 1
    assert results.launches["edit_distance_m128_n2048"] == {"myers_scan": align_calls}
    # #19's stream form counts as #19 too
    assert results.launches["approx_stream_m21"] == {"myers_scan": align_calls, "myers_stream_best": align_calls}
    assert results.launches["encode_b5_cuda_planar"] == {"encode_b5_planar": calls}
    for row in ("decode_b5_cuda_nt4", "decode_b5_cuda_nt4_padded"):
        assert results.launches[row] == {"decode_b5_nt4_panels": calls}
    assert results.launches["decode_b5_cuda_u8"] == {"decode_b5_panels": calls}
    assert results.launches["memcpy_device"] == {} and results.launches["encode_2bit_torch_mul"] == {}
    assert all(s > 0 for s in results.sol.values())


# --- kernel #19: the Myers scan ---------------------------------------------------

def _myers_inputs(rng, b5: bool, nb: int, R: int = 37, L: int = 24):
    A = 5 if b5 else 4
    peq = torch.from_numpy(rng.integers(0, 2**32, (R, A, nb), dtype=np.uint32))
    ql = torch.from_numpy(rng.integers(0, 32 * nb + 3, R).astype(np.int32))
    words = torch.from_numpy(rng.integers(0, 2**32, R * L, dtype=np.uint32))
    tl = torch.from_numpy(rng.integers(-2, 16 * L + 40, R).astype(np.int32))
    errs = torch.from_numpy(rng.integers(0, 40, R).astype(np.int32))
    errs[0] = 2**31 - 1
    return peq, ql, words, tl, errs


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


#: (nb, rows) reaching every form of #19's launch plan (``K.myers_plan``) at
#: the nb edges of each: the solo forms (1 and 2 blocks in one lane), 4-32
#: lanes of one block, 2-16 lanes of two (once one-block lanes would pass
#: one warp a scheduler, or two in semiglobal mode), and the scratch form
#: past 32 blocks.  A row count (d, e) is the card's lanes of one warp a
#: scheduler over d, plus e: d = pow2(nb) is the first batch whose
#: one-block lanes pass one warp a scheduler (two blocks a lane but in
#: semiglobal mode), d = pow2(nb) / 2 the first past two (in every mode).  37 rows is no multiple of a thread block's pairs, nor are the
#: large counts
MYERS_FORM_CASES = ((1, 37), (2, 37), (3, 37), (3, (4, 1)), (4, 37), (4, (4, 3)), (4, (2, 3)), (5, 37), (8, 37),
                    (8, (8, 7)), (9, 37), (12, 37), (16, 37), (16, (16, 1)), (17, 37), (32, 37), (32, (32, 1)),
                    (32, (16, 1)), (33, 37))


def _wave_lanes(device) -> int:
    """Lanes of one warp on each of the card's schedulers (4 an SM)."""
    return torch.cuda.get_device_properties(device).multi_processor_count * 4 * 32


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


@pytest.mark.parametrize("nb, R", MYERS_FORM_CASES)
@pytest.mark.parametrize("b5", (False, True))
def test_myers_kernel_matches_plain(cuda_device, b5, nb, R):
    """Every form of the launch plan: random Peq planes, lengths past the
    query's blocks and the text rows, every mode, a contiguous and a
    stride-0 Peq, and stream rows with a halo over several rows: the kernel
    bit for bit equal to its plain version."""
    if not isinstance(R, int):
        d, R = R[0], _wave_lanes(cuda_device) // R[0] + R[1]
        for mode in K.MYERS_MODES:  # two blocks a lane where the budget is passed
            two = mode != "semiglobal" or d < _pow2(nb)
            assert (K.myers_plan(nb, R, mode, cuda_device)[1] == 2) == two, (nb, R, mode)
    rng = np.random.default_rng(100 * nb + b5 + R)
    peq, ql, words, tl, errs = _myers_inputs(rng, b5, nb, R)
    for mode in K.MYERS_MODES:
        if mode == "ends" and b5:
            continue
        for p in (peq, peq[:1].expand(*peq.shape)):
            args = dict(mode=mode, b5=b5, max_errors=errs if mode == "ends" else None)
            want = K.myers_scan_plain(p, ql, words, tl, 24, 24, **args)
            cuda_args = {**args, "max_errors": errs.to(cuda_device) if mode == "ends" else None}
            got = K.myers_scan(p.to(cuda_device), ql.to(cuda_device), words.to(cuda_device), tl.to(cuda_device),
                               24, 24, **cuda_args)
            assert all(_same(g, w) for g, w in zip(_as_tuple(got), _as_tuple(want))), (mode, p.stride())
        if mode != "ends":
            R = -(-words.numel() // 8)
            sp = peq[:1].expand(R, *peq.shape[1:])
            sq, st = torch.full((R,), 20, dtype=torch.int32), torch.full((R,), 10**6, dtype=torch.int32)
            want = K.myers_scan_plain(sp, sq, words, st, 8, 8 + 30, mode=mode, b5=b5)
            got = K.myers_scan(sp.to(cuda_device), sq.to(cuda_device), words.to(cuda_device), st.to(cuda_device), 8,
                               8 + 30, mode=mode, b5=b5)
            assert all(_same(g, w) for g, w in zip(_as_tuple(got), _as_tuple(want))), (mode, "stream rows")


@pytest.mark.parametrize("mode", tuple(K.MYERS_MODES))
def test_myers_plan_rules(cuda_device, mode):
    """``cn_myers_plan``, the plan ``csrc/align.cu`` launches with: one lane
    for one or two blocks; else pow2(nb) lanes of one block while the batch's
    lanes fit one warp a scheduler of this card (two in semiglobal mode),
    half as many of two past that; the scratch form only past 32 blocks."""
    wave = _wave_lanes(cuda_device)
    budget = 2 * wave if mode == "semiglobal" else wave
    for nb in range(0, 70):
        for rows in (1, 37, 528, 529, 1000, 2112, 2113, wave // 4, wave // 4 + 1, wave // 2 + 1, wave, 10**6):
            lanes, bpl = K.myers_plan(nb, rows, mode, cuda_device)
            if nb > 32:
                want = (1, 0)
            elif nb <= 2:
                want = (1, max(nb, 1))
            else:
                want = (_pow2(nb), 1) if rows * _pow2(nb) <= budget else (_pow2(nb) // 2, 2)
            assert (lanes, bpl) == want, (nb, rows, wave, mode)


def test_align_cuda_matches_cpu(cuda_device):
    """Every exported scan of both codecs and both stream forms: the card's
    results equal the CPU's (plain version) on the same inputs, and the
    stream form the host Myers scan."""
    from cute_nucleotides_tpu_torch.ops import align

    rng = np.random.default_rng(19)
    qw = torch.from_numpy(rng.integers(0, 2**32, (33, 6), dtype=np.uint32))
    tw = torch.from_numpy(rng.integers(0, 2**32, (33, 20), dtype=np.uint32))
    ql = torch.from_numpy(rng.integers(0, 97, 33).astype(np.int32))
    tl = torch.from_numpy(rng.integers(0, 330, 33).astype(np.int32))
    errs = torch.from_numpy(rng.integers(0, 30, 33).astype(np.int32))
    on = [t.to(cuda_device) for t in (qw, ql, tw, tl, errs)]
    for fn in (align.edit_distance_packed, align.best_match_packed, align.prefix_distance_packed,
               align.edit_distance_packed_b5, align.best_match_packed_b5):
        got, want = fn(*on[:4]), fn(qw, ql, tw, tl)
        assert all(_same(g, w) for g, w in zip(_as_tuple(got), _as_tuple(want))), fn.__name__
    assert _same(align.match_ends_packed(*on), align.match_ends_packed(qw, ql, tw, tl, errs))
    seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), 100_003).tobytes()
    w2 = interop.u64_to_tensor(native.n_to_bits(seq), cuda_device)
    w5 = interop.u64_to_tensor(native.n_to_bits2(seq), cuda_device)
    query = seq[5000:5021]
    assert align.best_match_stream(w2, len(seq), query) == native.best_match(query, seq) == (0, 5021)
    assert align.best_match_stream_b5(w5, len(seq), query) == (0, 5021)
    long_q = seq[:300]  # the scratch form, and a halo over many rows
    assert align.best_match_stream(w2[:40], 600, long_q) == native.best_match(long_q, seq[:600])


def test_myers_launch_counts_and_refusals(cuda_device):
    from cute_nucleotides_tpu_torch.ops import align

    peq, ql, words, tl, errs = _myers_inputs(np.random.default_rng(1), False, 2)
    on = [t.to(cuda_device) for t in (peq, ql, words, tl, errs)]
    K.reset_launch_counts()
    K.myers_scan(*on[:4], 24, 24, mode="semiglobal")
    K.myers_scan(*on[:4], 24, 24, mode="ends", max_errors=on[4])
    K.myers_scan(on[0][:0], on[1][:0], on[2][:0], on[3][:0], 0, 0, mode="global")  # no rows: no launch
    K.myers_scan(peq, ql, words, tl, 24, 24, mode="global")  # the CPU: the plain version
    assert K.myers_scan.launches == 2 and sum(f.launches for f in K.WRAPPERS) == 2
    peq_cli, m = align.peq_from_bytes(b"GATTNCA")
    align.best_match_peq(interop.to_tensor(peq_cli, cuda_device)[None].expand(37, 4, 1), torch.full((37,), m),
                         on[2].view(37, 24), on[3])
    assert K.myers_scan.launches == 3
    with pytest.raises(ValueError, match="Peq planes must be contiguous"):
        K.myers_scan(on[0].transpose(1, 2).contiguous().transpose(1, 2), *on[1:4], 24, 24, mode="global")
    with pytest.raises(ValueError, match="contiguous"):
        K.myers_scan(on[0], on[1], on[2][::2], on[3], 12, 12, mode="global")
    with pytest.raises(ValueError, match="inputs on"):
        K.myers_scan(on[0], ql, *on[2:4], 24, 24, mode="global")
    assert K.myers_scan.launches == 3



# --- #19's stream form (kernels.myers_stream_best) -----------------------------------

#: query lengths of the stream form's cases: 1 to 5 blocks of the solo and
#: lane forms, and 1,100 nt past its 32 blocks (the rows' path)
STREAM_M = (1, 21, 23, 33, 64, 150, 1100)
#: chr1's length (UCSC hg38.chrom.sizes)
CHR1_NT = 248_956_422


def _stream_words(device, n: int, b5: bool, seed: int) -> torch.Tensor:
    """A random stream of ``n`` nt (or a little more) made on the card:
    2-bit words of random bits, or base-5 words of valid triplets."""
    g = torch.Generator(device=device).manual_seed(seed)
    if not b5:
        return torch.randint(-2**31, 2**31, (-(-n // 16),), dtype=torch.int32, device=device,
                             generator=g).view(torch.uint32)
    t = torch.randint(0, 125, (-(-n // 27), 9), dtype=torch.int64, device=device, generator=g)
    return (t << (7 * torch.arange(9, device=device))).sum(1).view(torch.uint32)


def _stream_query(words: torch.Tensor, at: int, m: int, b5: bool, edits: int, seed: int) -> bytes:
    """The stream's ``m`` nt from ``at`` as ASCII, with ``edits``
    substitutions."""
    per, unit = (27, 2) if b5 else (16, 1)
    w0 = at // per * unit
    codes = K.text_codes(words[w0: w0 + unit * (-(-(at % per + m) // per))].cpu()[None], b5)[0]
    q = bytearray(b"ACTGN"[c] for c in codes[at % per: at % per + m].tolist())
    for i in np.random.default_rng(seed).choice(m, min(edits, m), replace=False):
        q[i] = next(c for c in b"ACGT" if c != q[i])
    return bytes(q)


def _stream_keys(words: torch.Tensor, length: int, query: bytes, b5: bool, plain: bool):
    """(the stream form's key, the rows' path's key (#19's batch form and
    the eager reduction it ran before), the plain version's key or None)."""
    from cute_nucleotides_tpu_torch.ops import align

    peq, m = (align.peq_from_bytes_b5 if b5 else align.peq_from_bytes)(query)
    if b5:
        R, prb, Hp = align.stream_rows_plan_b5(words.numel() // 2, m)
        rows = (R, 2 * prb, 2 * (prb + Hp))
    else:
        R, wrb, H = align.stream_rows_plan(words.numel(), m)
        rows = (R, wrb, wrb + H)
    got = K.myers_stream_best(peq, m, words, length, *rows, b5=b5)
    eager = K._stream_key_by_rows(K.myers_scan, peq, m, words, length, *rows, b5)
    want = K.myers_stream_best_plain(peq, m, words.cpu(), length, *rows, b5=b5) if plain else None
    return int(got), int(eager), None if want is None else int(want)


@pytest.mark.parametrize("m", STREAM_M)
@pytest.mark.parametrize("b5", (False, True))
def test_myers_stream_matches_plain_and_the_rows_path(cuda_device, b5, m):
    """The stream form's key equals the plain version's and that of the
    rows' path it replaces (#19's batch form over the same rows, then the
    eager reduction) on short streams of ragged lengths, and the rows'
    path's on a chr1-length stream (the plain version would take minutes
    there), each with a near copy of the query; ``best_match_stream(_b5)``
    reads the same pair."""
    from cute_nucleotides_tpu_torch.ops import align

    call = align.best_match_stream_b5 if b5 else align.best_match_stream
    n = 1500 if m > 1000 else 5000
    words = _stream_words(cuda_device, n, b5, seed=m + b5)
    query = _stream_query(words, (n - m) // 3, m, b5, edits=m // 10, seed=m)
    for length in (n, n - 7, 1):
        got, eager, want = _stream_keys(words, length, query, b5, plain=True)
        assert got == eager == want, (length, got >> 32, eager >> 32, want >> 32)
        assert call(words, length, query) == (got >> 32, got & 0xFFFFFFFF)
    words = _stream_words(cuda_device, CHR1_NT, b5, seed=10 * m + b5)
    query = _stream_query(words, CHR1_NT - 3 * m - 5, m, b5, edits=m // 8, seed=m + 1)
    got, eager, _ = _stream_keys(words, CHR1_NT, query, b5, plain=False)
    assert got == eager and got >> 32 <= m // 8, (got >> 32, eager >> 32)
    assert call(words, CHR1_NT, query) == (got >> 32, got & 0xFFFFFFFF)


def test_myers_stream_launch_counts(cuda_device):
    """On the stream path each call launches #19's stream form once, counted
    in both ``myers_stream_best.launches`` and ``myers_scan.launches``, and
    nothing else; a query past 32 blocks takes the rows' path (the batch
    form, ``myers_scan`` alone); a Peq on the card is refused."""
    from cute_nucleotides_tpu_torch.ops import align

    w2 = _stream_words(cuda_device, 100_000, False, seed=1)
    w5 = _stream_words(cuda_device, 100_000, True, seed=2)
    K.reset_launch_counts()
    for _ in range(3):
        align.best_match_stream(w2, 100_000, b"GATTACAGATTACAGATTNGG")
        align.best_match_stream_b5(w5, 100_000, b"GATTACAGATTACAGATT?GG")
    assert K.myers_stream_best.launches == K.myers_scan.launches == 6
    assert sum(fn.launches for fn in K.WRAPPERS) == 12
    align.best_match_stream(w2[:200], 3200, _stream_query(w2, 0, 1100, False, edits=0, seed=0))
    assert K.myers_stream_best.launches == 6 and K.myers_scan.launches == 7
    peq, m = align.peq_from_bytes(b"GATTACA")
    with pytest.raises(TypeError, match="host memory"):
        K.myers_stream_best(torch.from_numpy(peq).to(cuda_device), m, w2, 1000, 100, 1, 2)
    assert K.myers_stream_best.launches == 6


def test_stream_calls_allocate_nothing_on_the_card(cuda_device):
    """After a thread's first call, ``best_match_stream(_b5)`` reuse its key
    slot: no allocation on the card a call; ``out=`` on the card is the
    same key as a new tensor's, in place."""
    from cute_nucleotides_tpu_torch.ops import align

    w2 = _stream_words(cuda_device, 100_000, False, seed=3)
    w5 = _stream_words(cuda_device, 100_000, True, seed=4)
    q2, q5 = _stream_query(w2, 5_000, 23, False, 2, seed=5), _stream_query(w5, 7_000, 23, True, 2, seed=6)
    first = align.best_match_stream(w2, 100_000, q2), align.best_match_stream_b5(w5, 100_000, q5)
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats(cuda_device)["allocation.all.allocated"]
    for _ in range(5):
        assert (align.best_match_stream(w2, 100_000, q2), align.best_match_stream_b5(w5, 100_000, q5)) == first
    assert torch.cuda.memory_stats(cuda_device)["allocation.all.allocated"] == before
    peq, m = align.peq_from_bytes(q2)
    R, wrb, H = align.stream_rows_plan(w2.numel(), m)
    out = torch.empty((), dtype=torch.int64, device=cuda_device)
    assert K.myers_stream_best(peq, m, w2, 100_000, R, wrb, wrb + H, out=out) is out
    assert int(out) == int(K.myers_stream_best(peq, m, w2, 100_000, R, wrb, wrb + H))
    assert (int(out) >> 32, int(out) & 0xFFFFFFFF) == first[0]


# --- the base-5 Peq build -----------------------------------------------------------

def _peq_b5_inputs(rng, wq: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(qwords, qlens) on the CPU: each length at the block and word seams,
    at the words' rows, past them and negative, over packed ACGTN queries,
    then the same with a triplet 125-127 in every row, then rows of random
    bits."""
    have = 27 * wq // 2
    lens = [0, 1, 26, 27, 31, 32, 33, 53, 54, have, have + 5, -3]
    clean = np.zeros((len(lens), wq), np.uint32)
    for i in range(len(lens)):
        clean[i] = np.ascontiguousarray(native.n_to_bits2(rng.choice(ACGTN, have).tobytes())).view(np.uint32)
    bad = clean.copy()
    pairs = bad.view(np.uint64)
    for r in range(len(bad)):
        pairs[r, int(rng.integers(0, wq // 2))] |= np.uint64(int(rng.integers(125, 128)) << (7 * int(rng.integers(0, 9))))
    q = np.concatenate([clean, bad, rng.integers(0, 2**32, (9, wq), dtype=np.uint32)])
    ql = np.array(lens * 2 + rng.integers(-2, have + 8, 9).tolist(), np.int32)
    return torch.from_numpy(q), torch.from_numpy(ql)


@pytest.mark.parametrize("wq", (2, 4, 6, 20))
def test_peq_b5_kernel_matches_plain(cuda_device, wq):
    """The Peq build bit for bit equal to its plain version: the seams of the
    query lengths, corrupt triplets, random words; contiguous, row-sliced
    (an offset start and every other row), a stride-0 query, and a start 4
    bytes off an 8-byte boundary (each of the kernel's load widths)."""
    q, ql = _peq_b5_inputs(np.random.default_rng(200 + wq), wq)
    n = len(q)
    flat = torch.zeros(n * wq + 1, dtype=torch.uint32)
    flat[1:] = q.reshape(-1)
    views = {"contiguous": (q, ql), "from row 1": (q[1:], ql[1:]), "every other row": (q[::2], ql[::2]),
             "stride 0": (q[5:6].expand(n, wq), ql), "4 bytes off": (flat[1:].view(n, wq), ql)}
    for what, (v, lens) in views.items():
        on = flat.to(cuda_device)[1:].view(n, wq) if what == "4 bytes off" else q.to(cuda_device)
        v_on = {"contiguous": on, "from row 1": on[1:], "every other row": on[::2], "stride 0": on[5:6].expand(n, wq),
                "4 bytes off": on}[what]
        got = K.peq_b5(v_on, lens.to(cuda_device))
        assert _same(got, K.peq_b5_plain(v, lens)), what
        assert got.shape == (len(lens), 5, max(1, -(-27 * wq // 2 // 32))), what


def test_peq_b5_kernel_at_the_cell_shape(cuda_device):
    """The adapter scan's shape: 1,048,576 queries of 4 u32 (random words,
    corrupt triplets where they fall, bit 63 set in half), lengths -2..60."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(1_048_576)
    R = 1 << 20
    q = torch.randint(-(2**31), 2**31, (R, 4), dtype=torch.int32, device=cuda_device, generator=g).view(torch.uint32)
    ql = torch.randint(-2, 61, (R,), dtype=torch.int32, device=cuda_device, generator=g)
    assert _same(K.peq_b5(q, ql), K.peq_b5_plain(q, ql))


def test_peq_b5_launches_once_a_call_and_never_runs_plain(cuda_device, monkeypatch):
    """Each ``best_match_packed_b5`` and ``edit_distance_packed_b5`` call on
    the card launches the Peq build once and #19 once, and never reaches the
    plain version; the results equal the CPU's.  Refusals."""
    from cute_nucleotides_tpu_torch.ops import align

    rng = np.random.default_rng(22)
    q, ql = _peq_b5_inputs(rng, 4)
    tw = torch.from_numpy(rng.integers(0, 2**32, (len(q), 12), dtype=np.uint32))
    tl = torch.from_numpy(rng.integers(0, 163, len(q)).astype(np.int32))
    want = (align.best_match_packed_b5(q, ql, tw, tl), align.edit_distance_packed_b5(q, ql, tw, tl))

    def refuse(*args):
        raise AssertionError("a CUDA tensor reached the plain Peq build")

    monkeypatch.setattr(K, "peq_b5_plain", refuse)
    on = [t.to(cuda_device) for t in (q, ql, tw, tl)]
    K.reset_launch_counts()
    best = align.best_match_packed_b5(*on)
    assert K.peq_b5.launches == 1 and K.myers_scan.launches == 1
    dist = align.edit_distance_packed_b5(*on)
    assert K.peq_b5.launches == 2 and K.myers_scan.launches == 2
    assert all(_same(g, w) for g, w in zip(best + (dist,), want[0] + (want[1],)))
    assert sum(fn.launches for fn in K.WRAPPERS) == 4
    with pytest.raises(ValueError, match="contiguous within a row"):
        K.peq_b5(on[0][:, ::2], on[1])
    with pytest.raises(ValueError, match="inputs on"):
        K.peq_b5(on[0], ql)
    with pytest.raises(ValueError, match="even u32 count"):
        K.peq_b5(on[0][:, :3], on[1])
    with pytest.raises(TypeError, match="qlens"):
        K.peq_b5(on[0], on[1][1:])
    K.peq_b5(on[0][:0], on[1][:0])  # no rows: no launch
    assert K.peq_b5.launches == 2


def test_b5_packed_takes_column_strided_queries(cuda_device):
    """``best_match_packed_b5`` and ``edit_distance_packed_b5`` take query
    words that are not contiguous within a row (every other column of a
    wider array, a transposed array) as the CPU does, one Peq build a call."""
    from cute_nucleotides_tpu_torch.ops import align

    rng = np.random.default_rng(23)
    q, ql = _peq_b5_inputs(rng, 4)
    tw = torch.from_numpy(rng.integers(0, 2**32, (len(q), 12), dtype=np.uint32))
    tl = torch.from_numpy(rng.integers(0, 163, len(q)).astype(np.int32))
    want = align.best_match_packed_b5(q, ql, tw, tl) + (align.edit_distance_packed_b5(q, ql, tw, tl),)
    wide = torch.zeros((len(q), 8), dtype=torch.uint32)
    wide[:, ::2] = q
    on = [t.to(cuda_device) for t in (ql, tw, tl)]
    views = {"every other column": wide.to(cuda_device)[:, ::2], "transposed": q.T.contiguous().to(cuda_device).T}
    for what, v in views.items():
        assert v.stride(1) != 1, what
        K.reset_launch_counts()
        got = align.best_match_packed_b5(v, *on) + (align.edit_distance_packed_b5(v, *on),)
        assert all(_same(g, w) for g, w in zip(got, want)), what
        assert K.peq_b5.launches == 2 and K.myers_scan.launches == 2, what


def test_approx_cli_on_the_card(cuda_device, tmp_path, capsys):
    """``approx --both --cigar`` on the card: each line equals the host Myers
    scan's best strand, and each CIGAR spans its window."""
    from cute_nucleotides_tpu_torch import cli

    rng = np.random.default_rng(5)
    seqs = [rng.choice(np.frombuffer(b"ACGT", np.uint8), n).tobytes() for n in (0, 15, 150, 150, 300, 1000)]
    nup = str(tmp_path / "r.nup")
    cli.write_nup(nup, [b"r%d" % i for i in range(len(seqs))], [native.n_to_bits(s) for s in seqs],
                  [len(s) for s in seqs], "2bit")
    assert cli.main(["approx", nup, "GATTACAGATTNCA", "--both", "--cigar", "--batch", "4"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    rc = search.revcomp_query(b"GATTACAGATTNCA")
    for line, s in zip(lines, seqs):
        f, r = native.best_match(b"GATTACAGATTNCA", s), native.best_match(rc, s)
        assert (line["dist"], line["end"], line["strand"]) == ((*r, "-") if r[0] < f[0] else (*f, "+"))
        assert line["end"] == 0 or 0 <= line["start"] <= line["end"]


# --- the streaming runtime on the card ---------------------------------------------

def _stream_fastq(path, n: int, length: int, seed: int, alphabet=ALPHABET) -> np.ndarray:
    seqs = np.random.default_rng(seed).choice(alphabet, size=(n, length))
    with open(path, "wb") as f:
        f.write(bench.fastq_bytes(seqs))
    return seqs


@pytest.mark.parametrize("codec,validate", (("2bit", False), ("2bit", True), ("base5", True)))
def test_stream_pipeline_matches_a_synchronous_encode(cuda_device, tmp_path, codec, validate):
    """The three-stream encoder gives, batch for batch, the words of a
    synchronous encode of the same reads on the default stream; the decoder
    gives the reads back; each batch launched exactly one codec kernel."""
    from cute_nucleotides_tpu_torch.parallel import ShardedCodec, runtime
    from cute_nucleotides_tpu_torch.utils import io as io_lib

    fq = tmp_path / "r.fq"
    seqs = _stream_fastq(fq, 5000, 333, 1, ALPHABET if codec == "2bit" else ALPHABET_N)
    block = 32 if codec == "2bit" else 27
    enc = runtime.StreamingEncoder(batch_size=512, max_len=333, codec=codec, validate=validate)
    sc = enc.sharded
    assert sc.tier == "cuda" and len({sc.upload, sc.compute, sc.download, torch.cuda.current_stream()}) == 4
    sunk = []
    K.reset_launch_counts()
    agg = enc.run_batches(io_lib.fastq_batches(str(fq), 512, 333, block=block), lambda w, b: sunk.append((w, b)))
    kernel = {("2bit", False): K.encode_2bit_nt4, ("2bit", True): K.encode_2bit_nt4_checked,
              ("base5", True): K.encode_b5_stream}[codec, validate]
    assert agg["batches"] == len(sunk) == 10 and kernel.launches == 10
    assert sum(fn.launches for fn in K.WRAPPERS) == 10
    model = models.TwoBitCodec(device=cuda_device) if codec == "2bit" else models.Base5Codec(device=cuda_device)
    for w, b in sunk:
        want = model.encode(torch.from_numpy(b.reads).to(cuda_device))
        assert np.array_equal(w, interop.to_numpy(want))
    per = block
    entries = [(b"r%d" % int(b.indices[i]), int(b.lengths[i]), w.view("<u8")[i, : -(-int(b.lengths[i]) // per)])
               for w, b in sunk for i in range(b.count)]
    got = []
    runtime.StreamingDecoder(batch_size=512, codec=codec, verify=codec == "base5").run(
        entries, lambda name, s: got.append(s))
    upper = seqs & 0xDF
    upper[upper == ord("U")] = ord("T")
    assert b"".join(got) == upper.tobytes()
    assert isinstance(sc, ShardedCodec)


def test_stream_sunk_arrays_stay_valid_after_later_batches(cuda_device, tmp_path):
    """A sink that keeps every batch's words (32 batches, one in flight at a
    time behind it) finds each unchanged after the run."""
    from cute_nucleotides_tpu_torch.parallel import runtime
    from cute_nucleotides_tpu_torch.utils import io as io_lib

    fq = tmp_path / "r.fq"
    _stream_fastq(fq, 8192, 2048, 2)
    kept = []
    runtime.StreamingEncoder(batch_size=256, max_len=2048, readback_depth=1).run_batches(
        io_lib.fastq_batches(str(fq), 256, 2048), lambda w, b: kept.append((w, w.copy())))
    assert len(kept) == 32 and all(np.array_equal(w, copy) for w, copy in kept)
    assert len({w.ctypes.data for w, _ in kept}) == 32  # every batch its own host buffer


def test_stream_sink_exception_drains_without_a_cuda_error(cuda_device, tmp_path):
    """A sink that raises on its third batch while later uploads, kernels and
    downloads are in flight: the error reaches the caller, the streams are
    drained, and the next stream on the card runs and is right."""
    from cute_nucleotides_tpu_torch.parallel import runtime
    from cute_nucleotides_tpu_torch.utils import io as io_lib

    fq = tmp_path / "r.fq"
    _stream_fastq(fq, 4096, 2048, 3)

    class Boom(Exception):
        pass

    calls = [0]

    def sink(w, b):
        calls[0] += 1
        if calls[0] == 3:
            raise Boom()

    enc = runtime.StreamingEncoder(batch_size=256, max_len=2048, prefetch_depth=4, readback_depth=4)
    with pytest.raises(Boom):
        enc.run_batches(io_lib.fastq_batches(str(fq), 256, 2048), sink)
    assert all(s.query() for s in (enc.sharded.upload, enc.sharded.compute, enc.sharded.download))
    torch.cuda.synchronize()  # raises if the drain left a CUDA error
    sunk = []
    agg = runtime.StreamingEncoder(batch_size=256, max_len=2048).run_batches(
        io_lib.fastq_batches(str(fq), 256, 2048), lambda w, b: sunk.append((w, b)))
    assert agg["batches"] == 16
    w, b = sunk[-1]
    want = models.TwoBitCodec(device=cuda_device).encode(torch.from_numpy(b.reads).to(cuda_device))
    assert np.array_equal(w, interop.to_numpy(want))


_NCCL_RANK = r"""
import datetime, sys
import torch

rank, coord = int(sys.argv[1]), sys.argv[2]
torch.cuda.set_device(0)
torch.distributed.init_process_group("nccl", init_method="tcp://" + coord, world_size=2, rank=rank,
                                     timeout=datetime.timedelta(seconds=60))
t = torch.ones(4, device="cuda")
torch.distributed.all_reduce(t)
torch.cuda.synchronize()
print("SUM", t.tolist())
"""


def test_nccl_takes_one_rank_a_card(cuda_device):
    """Two NCCL ranks on one card: NCCL refuses them when it makes the
    communicator (at the first collective), so two ranks on one card join a
    gloo group (``chip_smoke.py`` phase 9), and a process mesh over NCCL
    takes one card a rank (``runtime.initialize``)."""
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("localhost", 0))
        coord = f"localhost:{s.getsockname()[1]}"
    procs = [subprocess.Popen([sys.executable, "-c", _NCCL_RANK, str(r), coord], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode != 0 for p in procs), outs
    assert any("Duplicate GPU detected" in out + err for out, err in outs), [err[-1500:] for _, err in outs]
