"""The port's parallel layer (``cute_nucleotides_tpu_torch/parallel``: the
mesh, the data-parallel forms and the long-sequence mode) against the JAX
package's, on the CPU (tolerance 0).

Each test of ``tests/test_parallel.py`` has its mirror here at the same
sizes: the JAX function runs on the conftest's 8 virtual devices, as the
reference's own tests run it (``tier="xla"`` where a tier is asked for), and
the port on a mesh of 8 logical CPU shards (``devices=[cpu] * 8``) of the
same shape, on the same numpy-seeded inputs; both results go through
``np.asarray``.  The port's own cases follow: stream lengths at the word
seams times the shard count and below one word a shard, one-shard meshes,
hits planted across every seam, the error messages, the mesh without CUDA,
and the long-sequence host plan at 2^33 nt.  Where a test asks for the
``cuda`` tier, the kernel wrappers run their plain versions (CPU tensors).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cute_nucleotides_tpu import parallel as ref_parallel
from cute_nucleotides_tpu.ops import oracle, spec
from cute_nucleotides_tpu.parallel import longseq as ref_longseq, mesh as ref_mesh
from cute_nucleotides_tpu_torch import models, parallel
from cute_nucleotides_tpu_torch.ops import align as port_align, search as port_search
from cute_nucleotides_tpu_torch.parallel import longseq, mesh as mesh_lib

ALPHABET = np.frombuffer(b"ACGTUacgtu", dtype=np.uint8)
ALPHABET_N = np.frombuffer(b"ACGTUNacgtun", dtype=np.uint8)
CPU8 = [torch.device("cpu")] * 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mesh(data=None, seq=1, n=8):
    return parallel.make_mesh(data, seq, devices=CPU8[:n])


def _same(got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def _upper_t(batch: np.ndarray) -> np.ndarray:
    return np.frombuffer(batch.tobytes().upper().replace(b"U", b"T"), dtype=np.uint8).reshape(batch.shape)


@pytest.fixture
def cuda_tier_on_cpu(monkeypatch):
    """The cuda tier on CPU devices: its kernel wrappers run their plain
    versions on CPU tensors."""
    monkeypatch.setattr(models, "resolve_device", lambda tier, device=None: torch.device(device or "cpu"))


# --- mirrors of tests/test_parallel.py ----------------------------------------

def test_eight_cpu_shards():
    assert len(jax.devices()) == 8
    m = _mesh()
    assert m.size == 8 and m.axis_devices(mesh_lib.DATA_AXIS) == tuple(CPU8)


def test_make_mesh_shapes():
    for kw in ({}, {"seq": 4}, {"data": 1, "seq": 8}, {"data": 2, "seq": 2}):
        m, r = _mesh(**kw), ref_parallel.make_mesh(**kw)
        for axis in (mesh_lib.DATA_AXIS, mesh_lib.SEQ_AXIS):
            assert m.shape[axis] == r.shape[ref_mesh.DATA_AXIS if axis == "data" else ref_mesh.SEQ_AXIS]
    assert m.axis_names == tuple(r.axis_names)
    for kw in ({"seq": 3}, {"data": 3, "seq": 4}):
        with pytest.raises(ValueError) as want:
            ref_parallel.make_mesh(**kw)
        with pytest.raises(ValueError) as got:
            _mesh(**kw)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("gather", [False, True])
def test_data_parallel_encode_matches_oracle(rng, gather):
    B, L = 16, 96
    batch = rng.choice(ALPHABET, size=(B, L))
    got = parallel.data_parallel_encode(batch, mesh=_mesh(), gather=gather)
    want = ref_parallel.data_parallel_encode(jnp.asarray(batch), gather=gather, tier="xla")
    _same(got, want)
    assert got.replicated == gather and len(got.shards) == 8
    assert all(s.shape == ((B, L // 16) if gather else (B // 8, L // 16)) for s in got.shards)
    out = np.asarray(got)
    for b in range(B):
        assert np.array_equal(spec.u32_pairs_to_u64(out[b]), oracle.n_to_bits_lut(batch[b]))


@pytest.mark.parametrize("checked", [False, True])
def test_data_parallel_encode_mxu_variant(rng, cuda_tier_on_cpu, checked):
    """The "mxu" variant (the pext slot, kernel #4 and its checked form) in
    the data-parallel forms."""
    batch = rng.choice(ALPHABET, size=(16, 2048))
    mesh = _mesh()
    if checked:
        got, nbad = parallel.data_parallel.data_parallel_encode_checked(batch, mesh=mesh, tier="cuda", variant="mxu")
        assert int(np.asarray(nbad)) == 0
    else:
        got = parallel.data_parallel_encode(batch, mesh=mesh, tier="cuda", variant="mxu")
    _same(got, ref_parallel.data_parallel_encode(jnp.asarray(batch), tier="xla"))
    out = np.asarray(got)
    for b in range(16):
        assert np.array_equal(spec.u32_pairs_to_u64(out[b]), oracle.n_to_bits_lut(batch[b]))


def test_kmer_spectrum_sharded_matches_single_device(rng):
    from cute_nucleotides_tpu.ops import kmer
    from cute_nucleotides_tpu_torch.ops import kmer as port_kmer

    B, L, k = 16, 96, 6
    reads = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(B, L))
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    for b in range(B):
        reads[b, lengths[b]:] = ord("A")
    words = np.stack([spec.u64_to_u32_pairs(oracle.n_to_bits_lut(reads[b])).reshape(-1) for b in range(B)])
    for canonical in (False, True):
        got = parallel.kmer_spectrum(words, lengths, k, mesh=_mesh(), canonical=canonical)
        assert got.replicated and got.shape == (4**k,)
        _same(got, ref_parallel.kmer_spectrum(jnp.asarray(words), jnp.asarray(lengths), k, canonical=canonical))
        _same(got, kmer.kmer_histogram_batch(jnp.asarray(words), jnp.asarray(lengths), k, canonical=canonical))
        _same(got, port_kmer.kmer_histogram_batch(torch.from_numpy(words), lengths, k, canonical=canonical))
    assert int(np.asarray(got).sum()) == int(np.maximum(lengths - k + 1, 0).sum())


def test_data_parallel_decode_roundtrip(rng):
    B, L = 8, 64
    batch = rng.choice(ALPHABET, size=(B, L))
    words = parallel.data_parallel_encode(batch, mesh=_mesh())
    back = parallel.data_parallel_decode(words, mesh=_mesh())
    rwords = ref_parallel.data_parallel_encode(jnp.asarray(batch), tier="xla")
    _same(back, ref_parallel.data_parallel_decode(rwords, tier="xla"))
    _same(back, _upper_t(batch))


def test_data_parallel_b5(rng):
    B, L = 8, 108
    batch = rng.choice(ALPHABET_N, size=(B, L))
    got = parallel.data_parallel_encode(batch, mesh=_mesh(), codec="base5")
    _same(got, ref_parallel.data_parallel_encode(jnp.asarray(batch), codec="base5", tier="xla"))
    out = np.asarray(got)
    for b in range(B):
        assert np.array_equal(spec.u32_pairs_to_u64(out[b]), oracle.n_to_bits2_lut(batch[b]))
    back = parallel.data_parallel_decode(got, mesh=_mesh(), codec="base5", gather=True)
    _same(back, _upper_t(batch))


def test_sharded_codec_object(rng):
    sc = parallel.ShardedCodec(mesh=_mesh())
    B, L = 16, 32
    batch = rng.choice(ALPHABET, size=(B, L))
    x = sc.shard(batch)
    assert len(x.shards) == 8 and x.shards[0].shape == (2, L)
    words = sc.encode(x)
    back = sc.decode(words, gather=True)
    ref = ref_parallel.ShardedCodec(tier="xla")
    _same(words, ref.encode(ref.shard(batch)))
    _same(back, _upper_t(batch))
    with pytest.raises(ValueError, match="not both"):
        parallel.ShardedCodec(mesh=_mesh(), device="cpu")


@pytest.mark.parametrize("n", [1, 31, 32, 1000, 40000, 40001])
def test_long_2bit_bit_exact(rng, n):
    s = rng.choice(ALPHABET, size=n)
    got = longseq.encode_long_2bit(s, mesh=_mesh(1, 8))
    _same(got, ref_longseq.encode_long_2bit(s))
    _same(got, oracle.n_to_bits_lut(s))


@pytest.mark.parametrize("n", [1, 26, 27, 1000, 40000, 40013])
def test_long_b5_bit_exact(rng, n):
    s = rng.choice(ALPHABET_N, size=n)
    got = longseq.encode_long_b5(s, mesh=_mesh(1, 8))
    _same(got, ref_longseq.encode_long_b5(s))
    _same(got, oracle.n_to_bits2_lut(s))


def test_long_decode_roundtrip(rng):
    n = 12345
    s = rng.choice(ALPHABET, size=n)
    bits = oracle.n_to_bits_lut(s)
    got = longseq.decode_long_2bit(bits, n, mesh=_mesh(1, 8))
    _same(got, ref_longseq.decode_long_2bit(bits, n))
    _same(got, oracle.bits_to_n_lut(bits, n))
    s5 = rng.choice(ALPHABET_N, size=n)
    bits5 = oracle.n_to_bits2_lut(s5)
    got5 = longseq.decode_long_b5(bits5, n, mesh=_mesh(1, 8))
    _same(got5, ref_longseq.decode_long_b5(bits5, n))
    _same(got5, oracle.bits_to_n2_lut(bits5, n))


def test_shard_points_alignment():
    for length in (0, 1, 31, 32, 40000, 40013):
        for shards in (1, 3, 8):
            assert longseq.shard_points_2bit(length, shards) == ref_longseq.shard_points_2bit(length, shards)
            assert longseq.shard_points_b5(length, shards) == ref_longseq.shard_points_b5(length, shards)
    pts = longseq.shard_points_2bit(40000, 8)
    assert pts[0] == 0 and pts[-1] == 40000 and all(p % 32 == 0 for p in pts[1:-1])
    assert all(p % 27 == 0 for p in longseq.shard_points_b5(40000, 8)[1:-1])


def test_data_parallel_pallas_tier(rng, cuda_tier_on_cpu):
    """The kernels' tier (``cuda``; the reference's ``pallas``) inside the
    data-parallel forms: #1 and #2 (plain versions here)."""
    B, L = 8, 64
    batch = rng.choice(ALPHABET, size=(B, L))
    out = parallel.data_parallel_encode(batch, mesh=_mesh(), tier="cuda")
    rout = ref_parallel.data_parallel_encode(jnp.asarray(batch), tier="xla")
    _same(out, rout)
    back = parallel.data_parallel_decode(np.asarray(out), mesh=_mesh(), tier="cuda")
    _same(back, ref_parallel.data_parallel_decode(rout, tier="xla"))
    _same(back, _upper_t(batch))


@pytest.mark.parametrize("tier", ["torch", "cuda"])
def test_checked_encode_in_shard_map(rng, cuda_tier_on_cpu, tier):
    """The checked encode per shard (#3 on the cuda tier), its flags merged
    into one count by a psum; the base-5 checked encode (#5) and decode
    (#6) likewise."""
    B, L = 16, 512
    batch = rng.choice(ALPHABET, size=(B, L))
    batch[5, 100] = ord("X")
    words, nbad = parallel.data_parallel.data_parallel_encode_checked(batch, mesh=_mesh(), tier=tier, gather=True)
    rwords, rbad = ref_parallel.data_parallel.data_parallel_encode_checked(jnp.asarray(batch), tier="xla",
                                                                            gather=True)
    _same(words, rwords)
    _same(nbad, rbad)
    assert int(np.asarray(nbad)) == 1 and nbad.replicated
    want5 = np.where(batch == ord("X"), ord("A"), batch)
    out = np.asarray(words)
    for b in range(B):
        assert np.array_equal(spec.u32_pairs_to_u64(out[b]), oracle.n_to_bits_lut(want5[b]))
    b5 = rng.choice(ALPHABET_N, size=(16, 135))
    b5[3, 7] = b5[12, 0] = ord("X")
    w5, n5 = parallel.data_parallel.data_parallel_encode_checked(b5, mesh=_mesh(), codec="base5", tier=tier)
    rw5, rn5 = ref_parallel.data_parallel.data_parallel_encode_checked(jnp.asarray(b5), codec="base5", tier="xla")
    _same(w5, rw5)
    _same(n5, rn5)
    assert int(np.asarray(n5)) == 2
    bad = np.asarray(w5).copy()
    bad[9, 1] |= np.uint32(1 << 31)  # bit 63 of row 9's first word
    dec, nd = parallel.data_parallel.data_parallel_decode_checked(bad, mesh=_mesh(), tier=tier)
    rdec, rnd = ref_parallel.data_parallel.data_parallel_decode_checked(jnp.asarray(bad), tier="xla")
    _same(nd, rnd)
    assert int(np.asarray(nd)) == 1
    keep = np.arange(16) != 9  # a corrupt word decodes per the native oracle (ROADMAP §3)
    assert np.array_equal(np.asarray(dec)[keep], np.asarray(rdec)[keep])


def test_match_long_sharded_boundaries(rng):
    from cute_nucleotides_tpu.ops import search

    L = 50_000
    s = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=L)
    W = spec.num_words_2bit(L) * 2
    w_eq = -(-W // 8)
    q = b"GATTACA"
    planted = []
    for k in range(1, 8):
        p = 16 * (k * w_eq) - 3  # spans the boundary between shards k-1, k
        s[p : p + len(q)] = np.frombuffer(q, np.uint8)
        planted.append(p)
    bits = oracle.n_to_bits_lut(s)
    got = longseq.match_long(bits, L, q, mesh=_mesh(1, 8))
    _same(got, ref_longseq.match_long(bits, L, q))
    _same(got, search.match_positions(jnp.asarray(spec.u64_to_u32_pairs(bits).reshape(-1)), L, q))
    assert set(planted) <= set(got.tolist())
    s2 = np.full(1000, ord("C"), np.uint8)
    s2[-3:] = [ord("A"), ord("G"), ord("A")]
    bits2 = oracle.n_to_bits_lut(s2)
    got2 = longseq.match_long(bits2, 1000, b"ANA", mesh=_mesh(1, 8))
    _same(got2, ref_longseq.match_long(bits2, 1000, b"ANA", mesh=ref_parallel.make_mesh(data=1, seq=8)))
    assert got2.tolist() == [997]


def test_match_long_b5_sharded(rng):
    from cute_nucleotides_tpu.ops import search

    L = 54_000
    s = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=L)
    weq = -(-spec.num_words_b5(L) // 8)
    q = b"GAT?ACN"
    planted = []
    for k in range(1, 8):
        p = 27 * (k * weq) - 3
        if p + len(q) <= L:
            s[p : p + len(q)] = np.frombuffer(b"GATCACN", np.uint8)
            planted.append(p)
    bits = oracle.n_to_bits2_lut(s)
    got = longseq.match_long_b5(bits, L, q, mesh=_mesh(1, 8))
    _same(got, ref_longseq.match_long_b5(bits, L, q))
    _same(got, search.match_positions_b5(jnp.asarray(spec.u64_to_u32_pairs(bits.reshape(1, -1)).reshape(-1)), L, q))
    assert set(planted) <= set(got.tolist())
    s2 = np.full(1000, ord("C"), np.uint8)
    s2[-3:] = [ord("A"), ord("N"), ord("A")]
    got2 = longseq.match_long_b5(oracle.n_to_bits2_lut(s2), 1000, b"ANA", mesh=_mesh(1, 8))
    assert got2.tolist() == [997]
    long_q = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), 1025))
    with pytest.raises(ValueError, match="caps queries") as want:
        ref_longseq.match_long_b5(bits, L, long_q)
    with pytest.raises(ValueError, match="caps queries") as got:
        longseq.match_long_b5(bits, L, long_q, mesh=_mesh(1, 8))
    assert str(got.value) == str(want.value)


def test_best_match_long_sharded(rng):
    from cute_nucleotides_tpu.ops import align

    L = 20_000
    s = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=L)
    q = b"GATTACAGATTACAGATTACA"
    w_eq = -(-spec.num_words_2bit(L) * 2 // 8)
    mut = bytearray(q)
    mut[10] = ord("C")
    p = 16 * (3 * w_eq) - 5  # straddles the shard-2/3 boundary
    s[p : p + len(q)] = np.frombuffer(bytes(mut), np.uint8)
    bits = oracle.n_to_bits_lut(s)
    got = longseq.best_match_long(bits, L, q, mesh=_mesh(1, 8))
    assert got == ref_longseq.best_match_long(bits, L, q) == align.best_match_reference(q, bytes(s))
    assert got == (1, p + len(q))
    s2 = oracle.n_to_bits_lut(np.full(1000, ord("C"), np.uint8))
    assert longseq.best_match_long(s2, 1000, b"AAAAA", mesh=_mesh(1, 4, n=4)) == (5, 0)


def test_edit_distances_data_parallel(rng):
    from cute_nucleotides_tpu.ops import align

    B, m, n = 16, 40, 70
    qs = [rng.choice(np.frombuffer(b"ACGT", np.uint8), size=m) for _ in range(B)]
    ts = [rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=n) for _ in range(B)]

    def rows(seqs, enc):
        return np.stack([spec.u64_to_u32_pairs(enc(s)).reshape(-1) for s in seqs])

    qw, tw = rows(qs, oracle.n_to_bits_lut), rows(ts, oracle.n_to_bits_lut)
    got = parallel.edit_distances(qw, m, tw, n, mesh=_mesh())
    _same(got, ref_parallel.edit_distances(qw, m, tw, n))
    _same(got, align.edit_distance_packed(qw, np.full(B, m, np.int32), tw, np.full(B, n, np.int32)))
    qw5, tw5 = rows(qs, oracle.n_to_bits2_lut), rows(ts, oracle.n_to_bits2_lut)
    got5 = parallel.edit_distances(qw5, m, tw5, n, mesh=_mesh(), codec="base5")
    _same(got5, ref_parallel.edit_distances(qw5, m, tw5, n, codec="base5"))
    assert np.asarray(got5).tolist() == [align.edit_distance_reference_b5(bytes(q), bytes(t)) for q, t in zip(qs, ts)]


def test_best_match_long_b5_sharded(rng):
    from cute_nucleotides_tpu.ops import align

    L = 27 * 500
    s = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=L)
    q = b"GATTACANGATTACANGATTA"
    p_eq = -(-spec.num_words_b5(L) // 8)
    mut = bytearray(q)
    mut[2] = ord("C")
    p = 27 * (3 * p_eq) - 5
    s[p : p + len(q)] = np.frombuffer(bytes(mut), np.uint8)
    bits = oracle.n_to_bits2_lut(s)
    got = longseq.best_match_long_b5(bits, L, q, mesh=_mesh(1, 8))
    assert got == ref_longseq.best_match_long_b5(bits, L, q) == align.best_match_reference_b5(q, bytes(s))
    assert got == (1, p + len(q))
    m4 = _mesh(1, 4, n=4)
    s2 = oracle.n_to_bits2_lut(np.full(1000, ord("C"), np.uint8))
    assert longseq.best_match_long_b5(s2, 1000, b"NNNNN", mesh=m4) == (5, 0)
    assert longseq.best_match_long_b5(s2, 1000, b"??C??", mesh=m4) == (0, 5)


# --- the port's own cases -------------------------------------------------------

#: stream lengths at the word seams times the shard count, and below one word
#: a shard (so that some shards own no words)
SEAM_LENGTHS_2BIT = (31 * 8, 32 * 8, 33 * 8, 5, 100, 255)
SEAM_LENGTHS_B5 = (26 * 8, 27 * 8, 28 * 8, 5, 100, 215)


@pytest.mark.parametrize("n", SEAM_LENGTHS_2BIT)
def test_long_2bit_at_the_seams(rng, n):
    s = rng.choice(ALPHABET_N, size=n)
    s[np.arange(0, n, 37)] = ord("G")  # every hit of the query below is exact
    bits = oracle.n_to_bits_lut(s)
    mesh = _mesh(1, 8)
    _same(longseq.encode_long_2bit(s, mesh=mesh), bits)
    _same(longseq.decode_long_2bit(bits, n, mesh=mesh), oracle.bits_to_n_lut(bits, n))
    w32 = torch.from_numpy(spec.u64_to_u32_pairs(bits).reshape(-1))
    for q in (b"G", b"GNA", b"ACGTNACGTNACGTNACGTNACGTNACGTNACG"[: min(n, 33)]):
        got = longseq.match_long(bits, n, q, mesh=mesh)
        _same(got, port_search.match_positions(w32, n, q))
        _same(longseq.match_long(w32, n, q, mesh=mesh), got)  # the device form of the stream
    query = bytes(s[n // 3 : n // 3 + 4]) + b"N" + bytes(s[n // 3 + 5 : n // 3 + 9])
    want = port_align.best_match_reference(query, bytes(s))
    assert longseq.best_match_long(bits, n, query, mesh=mesh) == want
    assert longseq.best_match_long(w32, n, query, mesh=mesh) == want


@pytest.mark.parametrize("n", SEAM_LENGTHS_B5)
def test_long_b5_at_the_seams(rng, n):
    s = rng.choice(ALPHABET_N, size=n)
    bits = oracle.n_to_bits2_lut(s)
    mesh = _mesh(1, 8)
    _same(longseq.encode_long_b5(s, mesh=mesh), bits)
    _same(longseq.decode_long_b5(bits, n, mesh=mesh), oracle.bits_to_n2_lut(bits, n))
    w32 = torch.from_numpy(spec.u64_to_u32_pairs(bits).reshape(-1))
    for q in (b"N", b"A?C", bytes(s[n // 2 : n // 2 + 5]).upper().replace(b"U", b"T")):
        got = longseq.match_long_b5(bits, n, q, mesh=mesh)
        _same(got, port_search.match_positions_b5(w32, n, q))
        _same(longseq.match_long_b5(w32, n, q, mesh=mesh), got)
    query = b"ACNT" + bytes(s[n // 4 : n // 4 + 3]).upper().replace(b"U", b"T")
    want = port_align.best_match_reference_b5(query, bytes(s))
    assert longseq.best_match_long_b5(bits, n, query, mesh=mesh) == want
    wild = b"A?" + query  # the DP oracle knows no wildcard: hold it to the one-device scan
    assert longseq.best_match_long_b5(w32, n, wild, mesh=mesh) == port_align.best_match_stream_b5(w32, n, wild)


@pytest.mark.parametrize("b5", [False, True])
def test_hits_planted_across_every_seam(rng, b5):
    """A query planted across each of the 7 seams of an 8-shard split, on a
    2 x 4 mesh too (its 4 seq shards), against the JAX scans."""
    per, L = (27, 27 * 411 + 13) if b5 else (16, 16 * 733 + 5)
    s = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=L)
    enc = oracle.n_to_bits2_lut if b5 else oracle.n_to_bits_lut
    q = b"GATTACAGATTACA"
    units = spec.num_words_b5(L) if b5 else 2 * spec.num_words_2bit(L)
    for shards in (8, 4):
        w_eq = -(-units // shards)
        for k in range(1, shards):
            p = per * k * w_eq - 6
            s[p : p + len(q)] = np.frombuffer(q, np.uint8)
    bits = enc(s)
    want = [i for i in range(L - len(q) + 1) if bytes(s[i : i + len(q)]) == q]
    scan, ref_scan = (longseq.match_long_b5, ref_longseq.match_long_b5) if b5 else (longseq.match_long,
                                                                                       ref_longseq.match_long)
    for mesh, ref_mesh_ in ((_mesh(1, 8), ref_parallel.make_mesh(data=1, seq=8)),
                            (_mesh(2, 4), ref_parallel.make_mesh(data=2, seq=4))):
        got = scan(bits, L, q, mesh=mesh)
        assert got.tolist() == want
        _same(got, ref_scan(bits, L, q, mesh=ref_mesh_))
    best = longseq.best_match_long_b5 if b5 else longseq.best_match_long
    mut = bytearray(q)
    mut[7] = ord("T") if mut[7] != ord("T") else ord("C")
    d, e = best(bits, L, bytes(mut), mesh=_mesh(2, 4))
    assert d == 1 and e - len(q) in want


def test_one_shard_meshes(rng):
    """Every form on a one-device mesh, against the JAX functions on a
    one-device mesh; sharded and gathered results are the one shard itself."""
    one, ref_one = _mesh(1, 1, n=1), ref_parallel.make_mesh(data=1, seq=1, devices=jax.devices()[:1])
    batch = rng.choice(ALPHABET, size=(8, 64))
    x = torch.from_numpy(batch)
    words = parallel.data_parallel_encode(x, mesh=one)
    gathered = parallel.data_parallel_encode(x, mesh=one, gather=True)
    _same(words, ref_parallel.data_parallel_encode(jnp.asarray(batch), mesh=ref_one, tier="xla"))
    assert words.shards[0].data_ptr() != gathered.shards[0].data_ptr()  # two encodes
    back = parallel.data_parallel_decode(words, mesh=one, gather=True)
    assert len(back.shards) == 1 and back.shards[0].shape == (8, 64)
    _same(back, _upper_t(batch))
    lengths = rng.integers(0, 65, 8).astype(np.int32)
    w = np.asarray(words)
    _same(parallel.kmer_spectrum(w, lengths, 4, mesh=one), ref_parallel.kmer_spectrum(jnp.asarray(w),
                                                                                      jnp.asarray(lengths), 4,
                                                                                      mesh=ref_one))
    _same(parallel.match_counts(w, lengths, b"ACG", mesh=one),
          ref_parallel.match_counts(jnp.asarray(w), jnp.asarray(lengths), b"ACG", mesh=ref_one))
    s = rng.choice(ALPHABET_N, size=3001)
    _same(longseq.encode_long_b5(s, mesh=one), ref_longseq.encode_long_b5(s, mesh=ref_one))
    bits = oracle.n_to_bits_lut(s)
    _same(longseq.match_long(bits, 3001, b"GANT", mesh=one), ref_longseq.match_long(bits, 3001, b"GANT",
                                                                                     mesh=ref_one))
    q = bytes(s[100:120]).upper().replace(b"U", b"T")
    assert longseq.best_match_long(bits, 3001, q, mesh=one) == ref_longseq.best_match_long(bits, 3001, q,
                                                                                            mesh=ref_one)


def test_one_device_mesh_costs_no_copy(rng):
    """On a one-device mesh the shard is the batch itself (a view) and the
    gather the shard itself."""
    x = torch.from_numpy(rng.choice(ALPHABET, size=(8, 64)))
    shards = mesh_lib.shard_rows(x, (torch.device("cpu"),))
    assert shards[0].data_ptr() == x.data_ptr()
    words = parallel.data_parallel_encode(x, mesh=_mesh(1, 1, n=1), gather=True)
    w = words.shards[0]
    assert mesh_lib.all_gather([w], (w.device,)).shards[0] is w


def test_a_mesh_makes_its_axes_and_codecs_once(rng):
    """A mesh's axis views and the forms' batch codecs are made at the
    first call and reused by every later one on that mesh (one codec a
    distinct device); another mesh makes its own; a wrong setting still
    raises at every call."""
    from cute_nucleotides_tpu_torch.parallel import data_parallel as dp

    m, other = _mesh(4, 2), _mesh(4, 2)
    assert m.axis(mesh_lib.DATA_AXIS) is m.axis(mesh_lib.DATA_AXIS) is not other.axis(mesh_lib.DATA_AXIS)
    assert m.axis(mesh_lib.SEQ_AXIS) is m.axis(mesh_lib.SEQ_AXIS)
    for _ in range(2):
        with pytest.raises(ValueError, match="unknown mesh axis"):
            m.axis("rows")
    axis, codecs = dp._codecs(m, "base5", "auto")
    again = dp._codecs(m, "base5", "auto")
    assert again[0] is axis and all(a is b for a, b in zip(again[1], codecs)) and len(codecs) == 4
    assert not set(map(id, dp._codecs(other, "base5", "auto")[1])) & set(map(id, codecs))
    assert dp._codecs(m, "2bit", "auto")[1][0] is not codecs[0]
    x = torch.from_numpy(rng.choice(ALPHABET_N, size=(8, 54)))
    first = np.asarray(parallel.data_parallel_encode(x, mesh=m, codec="base5", gather=True))
    _same(parallel.data_parallel_encode(x, mesh=m, codec="base5", gather=True), first)
    _same(first, ref_parallel.data_parallel_encode(jnp.asarray(x.numpy()), codec="base5", tier="xla"))
    for _ in range(2):
        with pytest.raises(ValueError, match="unknown codec"):
            parallel.data_parallel_encode(x, mesh=m, codec="base4")
        with pytest.raises(ValueError, match="unknown tier"):
            parallel.data_parallel_encode(x, mesh=m, codec="base5", tier="tpu")


def test_data_parallel_on_a_2x4_mesh(rng):
    """The data forms shard over the data axis only (2 shards), as the
    reference's replicate over seq; match_counts and sketch_sharded too."""
    batch = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(8, 160))
    mesh, ref_m = _mesh(2, 4), ref_parallel.make_mesh(seq=4)
    words = parallel.data_parallel_encode(batch, mesh=mesh)
    assert len(words.shards) == 2
    rwords = ref_parallel.data_parallel_encode(jnp.asarray(batch), mesh=ref_m, tier="xla")
    _same(words, rwords)
    w = np.asarray(words)
    lengths = np.array([160, 0, 5, 31, 32, 33, 100, 159], np.int32)
    for codec, ww, q in (("2bit", w, b"GANA"),):
        _same(parallel.match_counts(ww, lengths, q, mesh=mesh, codec=codec),
              ref_parallel.match_counts(jnp.asarray(ww), jnp.asarray(lengths), q, mesh=ref_m, codec=codec))
    w5 = np.asarray(parallel.data_parallel_encode(batch[:, :135], mesh=mesh, codec="base5"))
    l5 = np.minimum(lengths, 135)
    _same(parallel.match_counts(w5, l5, b"A?N", mesh=mesh, codec="base5"),
          ref_parallel.match_counts(jnp.asarray(w5), jnp.asarray(l5), b"A?N", mesh=ref_m, codec="base5"))
    for k, canonical in ((21, True), (9, False)):
        got = parallel.sketch_sharded(w, lengths, k, 16, mesh=mesh, canonical=canonical)
        assert got.replicated and got.shape == (16,)
        _same(got, ref_parallel.sketch_sharded(jnp.asarray(w), jnp.asarray(lengths), k, 16, mesh=ref_m,
                                               canonical=canonical))


def test_error_messages(rng):
    bits = oracle.n_to_bits_lut(rng.choice(ALPHABET, size=100))
    bits5 = oracle.n_to_bits2_lut(rng.choice(ALPHABET, size=100))
    mesh = _mesh(1, 8)
    cases = (
        (longseq.match_long, ref_longseq.match_long, (bits, 129, b"ACG")),  # capacity
        (longseq.match_long, ref_longseq.match_long, (bits, 3, b"ACGT")),  # shorter than query
        (longseq.match_long_b5, ref_longseq.match_long_b5, (bits5, 109, b"ACG")),
        (longseq.match_long_b5, ref_longseq.match_long_b5, (bits5, 2, b"ACG")),
        (longseq.best_match_long, ref_longseq.best_match_long, (bits, 129, b"ACG")),
        (longseq.best_match_long_b5, ref_longseq.best_match_long_b5, (bits5, 109, b"ACG")),
        (longseq.decode_long_2bit, ref_longseq.decode_long_2bit, (bits, 129)),
        (longseq.decode_long_b5, ref_longseq.decode_long_b5, (bits5, 109)),
        (longseq.match_long, ref_longseq.match_long, (bits, 100, b"")),  # empty query
    )
    for port_fn, ref_fn, args in cases:
        with pytest.raises(ValueError) as want:
            ref_fn(*args)
        with pytest.raises(ValueError) as got:
            port_fn(*args, mesh=mesh)
        assert str(got.value) == str(want.value), port_fn.__name__
    with pytest.raises(ValueError, match="data axis of size 8"):
        parallel.data_parallel_encode(rng.choice(ALPHABET, size=(12, 32)), mesh=_mesh())
    with pytest.raises(ValueError, match="data axis of size 2"):
        parallel.kmer_spectrum(np.zeros((3, 4), np.uint32), 64, 4, mesh=_mesh(2, 4))
    with pytest.raises(ValueError, match="data axis of size 8"):
        parallel.edit_distances(np.zeros((4, 2), np.uint32), 32, np.zeros((4, 2), np.uint32), 32, mesh=_mesh())
    with pytest.raises(ValueError, match="base-5 only"):
        parallel.ShardedCodec(mesh=_mesh()).decode_checked(np.zeros((8, 2), np.uint32))


def test_make_mesh_without_cuda_raises():
    """make_mesh() takes every local card; with none it raises RuntimeError
    (run in a child with the cards hidden, so this holds on a GPU host)."""
    code = (
        "import torch\n"
        "from cute_nucleotides_tpu_torch import parallel\n"
        "from cute_nucleotides_tpu_torch.parallel import longseq\n"
        "for fn in (parallel.make_mesh, parallel.default_mesh, lambda: longseq.encode_long_2bit(b'ACGT'),\n"
        "           lambda: parallel.data_parallel_encode(torch.zeros((1, 32), dtype=torch.uint8))):\n"
        "    try:\n"
        "        fn()\n"
        "    except RuntimeError as e:\n"
        "        assert 'CUDA' in str(e), e\n"
        "    else:\n"
        "        raise SystemExit('no RuntimeError')\n"
        "print('RAISED')\n"
    )
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "RAISED" in proc.stdout, proc.stderr


@pytest.mark.parametrize("shards", [8, 16, 64])
@pytest.mark.parametrize("b5", [False, True])
def test_halo_plan_past_2_31_nt(shards, b5):
    """The host plan of best_match_long(_b5) for a 2^33-nt stream, with no
    data: w_eq, H, the per-shard valid nt and each shard's base offset are
    the reference's expressions (longseq.py:453-460 and 468-477; 541-547
    for base-5), computed in int64; every shard-local value fits int32 and
    the ends pass 2^31."""
    length, m = 2**33, 21
    per = 27 if b5 else 16
    n_u32 = 2 * spec.num_words_b5(length) if b5 else -(-length // 16)
    plan = longseq.halo_plan(length, n_u32, m, shards, b5=b5, best=True)
    if b5:
        Hp = max(1, -(-(2 * m - 2) // spec.NT_PER_WORD_B5))
        w_eq = max(-(-(n_u32 // 2) // shards), Hp)
        H = Hp
    else:
        from cute_nucleotides_tpu.ops import align as ref_align

        H = ref_align.halo_words(m)
        w_eq = max(-(-n_u32 // shards), H)
    valid = np.clip(np.int64(length) - per * np.int64(w_eq) * np.arange(shards, dtype=np.int64), 0,
                    per * (w_eq + H)).astype(np.int32)
    assert (plan.w_eq, plan.H) == (w_eq, H)
    assert plan.valid.dtype == np.int32 and np.array_equal(plan.valid, valid)
    ends = [per * w_eq * i + 7 for i in range(shards)]  # the reference's end assembly, Python ints
    assert (plan.base + 7).tolist() == ends and ends[-1] > 2**31
    assert int(plan.valid.sum()) >= length
    with pytest.raises(ValueError, match="more seq shards"):
        longseq.halo_plan(length, n_u32, m, 2, b5=b5, best=True)


def test_the_function_best_match_stream_names_exists():
    """best_match_stream refuses streams of 2^31 nt or more and names
    parallel.longseq.best_match_long, which exists."""
    from cute_nucleotides_tpu_torch.parallel.longseq import best_match_long  # noqa: F401

    with pytest.raises(ValueError, match=r"parallel\.longseq\.best_match_long"):
        port_align.best_match_stream(torch.zeros(1, dtype=torch.uint32).expand(2**27), 2**31, b"ACGT")


def test_exports_match_the_reference():
    import cute_nucleotides_tpu.parallel as ref

    names = {n for n in vars(ref) if not n.startswith("_") and callable(getattr(ref, n))}
    assert names <= set(vars(parallel)), names - set(vars(parallel))
    for n in ("match_long", "match_long_b5", "best_match_long", "best_match_long_b5", "shard_points_2bit",
              "shard_points_b5"):
        assert callable(getattr(longseq, n))
    assert mesh_lib.make_mesh is parallel.make_mesh and callable(mesh_lib.default_mesh)
