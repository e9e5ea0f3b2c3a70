"""Kernel #19's schedule on the CPU.  The card's kernel cannot run here, so
a numpy emulation of the order it runs in -- the wavefront of
``csrc/align.cu`` -- is held to the plain version (``myers_scan_plain``)
and to the JAX package's scans at tolerance 0.

The emulation runs a pair's blocks over L lanes, BPL blocks a lane: lane b
takes text char s - D b at step s (D = 2 for 2-bit text, 3 for base-5),
reads that char from its own lag-shifted text word (a funnel shift of two
words, or the 64-bit base-5 word shifted by whole triplets), takes the
carry and the Ph and Mh bits its lower neighbour sent D steps earlier (a
pair's first lane: the row-0 input and zero carries), and leaves its state
unchanged outside [0, jend).  Word steps where every lane of a warp lies
inside its row skip that test, as the kernel's do.  The score is read by
the lane of block (m - 1) // 32: per char through the multiplier that moves
its bit to bit 31, or, in global mode, from the last column's popcounts.
The cases put nb 1-5, 8, 16, 17 and 32 through every form the launch
plan can pick, every mode, both alphabets, ragged text lengths (0,
negative, mid-word, past the capacity), a stride-0 Peq, stream rows with
a halo, and base-5 triplets 125..127.  Inputs come from numpy seeds."""

import numpy as np
import pytest
import torch

from cute_nucleotides_tpu.ops import align as ref
from cute_nucleotides_tpu_torch.ops import align, kernels as K

M32 = np.uint64(0xFFFFFFFF)
M63 = np.uint64(0x7FFFFFFFFFFFFFFF)
WARP = 32
INT32_MAX = 2**31 - 1


def _u(x) -> np.uint64:
    return np.uint64(x)


def _text_rows(words: np.ndarray, R: int, stride: int, length: int) -> np.ndarray:
    """Row r: ``length`` u32 from ``r * stride`` of the flat stream, zeros past it (uint64 lanes)."""
    flat = np.zeros(max(R * stride + length, words.size), np.uint64)
    flat[: words.size] = words
    return flat[np.arange(R)[:, None] * stride + np.arange(length)]


def _popcount(x: np.ndarray) -> np.ndarray:
    return np.bitwise_count(x).astype(np.int64)


def wavefront(peq, qlens, words, tlens, row_stride, row_len, mode, b5, max_errors, lanes, bpl):
    """The kernel's schedule in numpy: returns what ``myers_scan`` returns."""
    peq = np.asarray(peq).astype(np.uint64)
    R, A, nb = peq.shape
    D, U = (3, 27) if b5 else (2, 16)
    L, NBL = lanes, lanes * bpl
    assert L & (L - 1) == 0 and NBL >= nb and bpl in (1, 2)
    phin0 = 0 if mode in ("semiglobal", "ends") else 1
    planes = np.zeros((R, 6 if b5 else 4, NBL), np.uint64)  # the warp's shared table
    planes[:, :A, :nb] = peq
    if b5:
        planes[:, 5] = planes[:, 0]  # digit 5 (a corrupt triplet) reads plane 0
    rows = np.arange(R)[:, None]
    lb = np.arange(L)[None, :]
    ql = np.asarray(qlens).astype(np.int64)
    cap = (row_len // 2) * 27 if b5 else 16 * row_len
    jend = np.clip(np.asarray(tlens).astype(np.int64), 0, cap)
    m1 = np.maximum(ql, 1) - 1
    hb = m1 >> 5
    has = hb < nb
    slane = np.where(has[:, None], lb == (hb // bpl)[:, None], lb == 0)  # the lane owning the score
    smul = np.zeros((R, L, bpl), np.uint64)
    for i in range(bpl):
        on = has[:, None] & slane & ((hb % bpl) == i)[:, None]
        smul[..., i] = np.where(on, (1 << (31 - (m1 & 31)))[:, None], 0).astype(np.uint64)
    mult = np.where(lb > 0, 2, 0).astype(np.uint64)
    first = np.where(lb > 0, 1, 0).astype(np.uint64)
    padd = np.where(lb > 0, 0, phin0).astype(np.uint64)
    pv = np.full((R, L, bpl), M32, np.uint64)
    mv = np.zeros((R, L, bpl), np.uint64)
    ring = np.zeros((D, 3, R, L), np.uint64)
    score = np.repeat(ql[:, None], L, 1)
    best, best_end = score.copy(), np.zeros((R, L), np.int64)
    ends = np.zeros((R, 16 * row_len), bool)
    errs = np.asarray(max_errors).astype(np.int64) if mode == "ends" else None
    # the warp's word steps: [0, ga) fill, [ga, gb) no char test, then the drain to gc
    ppw = WARP // L
    jw = np.zeros(-(-R // ppw) * ppw, np.int64)
    jw[:R] = jend
    jw = jw.reshape(-1, ppw)
    fill = D * (L - 1)
    ga = -(-fill // U)
    gb = np.repeat(jw.min(1) // U, ppw)[:R]
    gc = np.repeat(-(-(jw.max(1) + fill) // U), ppw)[:R]
    text = _text_rows(np.asarray(words).astype(np.uint64), R, row_stride, row_len)
    avail = np.clip(np.asarray(words).size - np.arange(R) * row_stride, 0, row_len)

    def word(w):  # (R, L) u32 indices into each row; zero outside [0, avail)
        ok = (w >= 0) & (w < avail[:, None])
        return np.where(ok, text[rows, np.clip(w, 0, row_len - 1)], 0).astype(np.uint64)

    for w in range(int(gc.max()) if R else 0):
        unchecked = (ga <= w) & (w < gb)
        if b5:  # the 64-bit word shifted up by the lane's lag in triplets
            q, sh = lb // 9, (7 * (lb % 9)).astype(np.uint64)
            cur = word(2 * (w - q)) | (word(2 * (w - q) + 1) << _u(32))
            prev = (word(2 * (w - q - 1)) | (word(2 * (w - q - 1) + 1) << _u(32))) & M63
            v = (cur << sh) | ((prev >> _u(1)) >> (_u(62) - sh))
            trip = [(v >> _u(7 * t)) & _u(0x7F) for t in range(9)]
            codes = []
            for t in trip:
                q5, q25 = (t * _u(205)) >> _u(10), (t * _u(41)) >> _u(10)
                codes += [t - _u(5) * q5, q5 - _u(5) * q25, q25]
        else:  # a funnel shift of words w - q - 1 and w - q by the lane's lag in bits
            lag_bits = 2 * D * lb
            q, rb = lag_bits >> 5, (lag_bits & 31).astype(np.uint64)
            cur, prev = word(w - q), word(w - q - 1)
            v = np.where(rb > 0, ((cur << rb) | (prev >> (_u(32) - rb))) & M32, cur)
            codes = [(v >> _u(2 * k)) & _u(3) for k in range(16)]
        for k in range(U):
            c = np.broadcast_to(w * U + k - D * lb, (R, L))  # each lane's char
            valid = (c >= 0) & (c < jend[:, None])
            upd = np.where(unchecked[:, None], True, valid)
            rx = ring[k % D]
            pin = ((rx[0] * mult) >> _u(32)) + padd
            nin = (rx[1] * mult) >> _u(32)
            cin = rx[2] * first
            e = [planes[rows, codes[k].astype(np.int64), lb * bpl + i] for i in range(bpl)]
            p, m = [pv[..., i] for i in range(bpl)], [mv[..., i] for i in range(bpl)]
            a = [e[i] & p[i] for i in range(bpl)]
            if bpl == 1:
                s = [(a[0] + p[0] + cin) & M32]
            else:  # one 64-bit add carries block 0 into block 1
                t = ((a[1] << _u(32)) | a[0]) + ((p[1] << _u(32)) | p[0]) + cin
                s = [t & M32, t >> _u(32)]
            co = (a[-1] | (p[-1] & ~s[-1] & M32)) >> _u(31)
            xh = [(s[i] ^ p[i]) | e[i] for i in range(bpl)]
            ph = [(m[i] | ~(xh[i] | p[i])) & M32 for i in range(bpl)]
            mh = [p[i] & xh[i] for i in range(bpl)]
            ps, ms = [((ph[0] << _u(1)) + pin) & M32], [((mh[0] << _u(1)) + nin) & M32]
            if bpl == 2:  # funnel shifts carry block 0's top bits into block 1
                ps.append(((ph[1] << _u(1)) | (ph[0] >> _u(31))) & M32)
                ms.append(((mh[1] << _u(1)) | (mh[0] >> _u(31))) & M32)
            for i in range(bpl):
                xv = e[i] | m[i]
                pv[..., i] = np.where(upd, (ms[i] | ~(xv | ps[i])) & M32, p[i])
                mv[..., i] = np.where(upd, ps[i] & xv, m[i])
            sent = np.stack([ph[-1], mh[-1], co])  # __shfl_up_sync(.., 1, L): a first lane gets its own
            ring[k % D] = np.concatenate([sent[..., :1], sent[..., :-1]], -1)
            if mode != "global":
                x = sum(ph[i] * smul[..., i] for i in range(bpl)) & M32
                y = sum(mh[i] * smul[..., i] for i in range(bpl)) & M32
                score = np.where(upd, score + (x >> _u(31)).astype(np.int64) - (y >> _u(31)).astype(np.int64), score)
                if mode == "ends":
                    at = upd & slane & (c >= 0) & (c < 16 * row_len)
                    r_at, l_at = np.nonzero(at)
                    ends[r_at, c[r_at, l_at]] = score[r_at, l_at] <= errs[r_at]
                else:
                    better = upd & (score < best)
                    best = np.where(better, score, best)
                    best_end = np.where(better, c + 1, best_end)
    if mode == "global":
        top = ((2 << (m1 & 31)) - 1).astype(np.uint64)[:, None, None]  # rows 0..m1 % 32 of the score block
        blk = lb[..., None] * bpl + np.arange(bpl)  # (1, L, BPL)
        below, at = blk < hb[:, None, None], blk == hb[:, None, None]
        mask = np.where(below, M32, np.where(at, top, _u(0)))
        part = (_popcount(pv & mask) - _popcount(mv & mask)).sum((1, 2))
        out = np.where(has, ql + jend + part - (m1 + 1), ql)
        return torch.from_numpy(out.astype(np.int64).astype(np.int32))
    if mode == "ends":
        return torch.from_numpy(ends)
    own = np.argmax(slane, 1)
    return (torch.from_numpy(best[np.arange(R), own].astype(np.int32)),
            torch.from_numpy(best_end[np.arange(R), own].astype(np.int32)))


def _same(got, want) -> bool:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return len(got) == len(want) and all(np.array_equal(np.asarray(g), np.asarray(w)) for g, w in zip(got, want))


def _pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _forms(nb: int) -> list[tuple[int, int]]:
    """Every (lanes, blocks a lane) the plan can pick for nb blocks."""
    if nb <= 2:
        return [(1, nb)]
    return [(_pow2(nb) // 2, 2), (_pow2(nb), 1)]


def _inputs(rng, b5: bool, nb: int, R: int, L: int):
    """Random Peq planes and words, query lengths around the blocks' ends, and
    text lengths that stop mid-word in the first warps (so whole words run
    with no char test) and are 0, negative, short or past the capacity in the
    last."""
    A = 5 if b5 else 4
    peq = rng.integers(0, 2**32, (R, A, nb), dtype=np.uint32)
    ql = rng.integers(0, 32 * nb + 3, R).astype(np.int32)
    ql[:3] = (32 * nb, 32 * nb - 31, 0)
    words = rng.integers(0, 2**32, R * L, dtype=np.uint32)
    cap = (L // 2) * 27 if b5 else 16 * L
    tl = (cap - rng.integers(0, 7, R)).astype(np.int32)
    tl[-5:] = (0, -2, 5, cap + 40, cap // 2 + 1)
    errs = rng.integers(0, 40, R).astype(np.int32)
    errs[0] = INT32_MAX
    return peq, ql, words, tl, errs


@pytest.mark.parametrize("b5", (False, True), ids=("2bit", "b5"))
@pytest.mark.parametrize("nb", (1, 2, 3, 4, 5, 8, 16, 17, 32))
def test_wavefront_matches_plain(nb, b5):
    """Every form for nb blocks, every mode, a contiguous and a stride-0 Peq,
    and stream rows whose halo spans several rows: the emulated schedule bit
    for bit equal to the plain version."""
    rng = np.random.default_rng(1000 * nb + b5)
    L = 10 if nb > 8 else 24
    R = 70
    peq, ql, words, tl, errs = _inputs(rng, b5, nb, R, L)
    modes = ("global", "semiglobal", "prefix") + (() if b5 else ("ends",))
    for lanes, bpl in _forms(nb):
        for mode in modes:
            for p in (peq, np.broadcast_to(peq[:1], peq.shape)):
                e = errs if mode == "ends" else None
                want = K.myers_scan_plain(torch.from_numpy(np.ascontiguousarray(p)), torch.from_numpy(ql),
                                          torch.from_numpy(words), torch.from_numpy(tl), L, L, mode=mode, b5=b5,
                                          max_errors=None if e is None else torch.from_numpy(e))
                got = wavefront(p, ql, words, tl, L, L, mode, b5, e, lanes, bpl)
                assert _same(got, want), (lanes, bpl, mode, p.strides)
        if not b5 or nb < 8:  # stream rows: 8 u32 each, a halo of 30 over the next rows
            n = words.size // 3
            Rs = -(-n // 8)
            sp = np.broadcast_to(peq[:1], (Rs,) + peq.shape[1:])
            sq, st = np.full(Rs, 32 * nb - 12, np.int32), np.full(Rs, 10**6, np.int32)
            for mode in ("global", "semiglobal"):
                want = K.myers_scan_plain(torch.from_numpy(np.ascontiguousarray(sp)), torch.from_numpy(sq),
                                          torch.from_numpy(words[:n]), torch.from_numpy(st), 8, 8 + 30, mode=mode,
                                          b5=b5)
                assert _same(wavefront(sp, sq, words[:n], st, 8, 38, mode, b5, None, lanes, bpl), want), mode


def _packed_batch(rng, b5: bool, wq: int, wt: int, B: int):
    qw = rng.integers(0, 2**32, (B, wq), dtype=np.uint32)
    tw = rng.integers(0, 2**32, (B, wt), dtype=np.uint32)
    if not b5:  # a near copy of each query in its text
        for i in range(0, B, 2):
            tw[i, 1 : 1 + min(wq, wt - 1)] = qw[i, : min(wq, wt - 1)]
    cap_q = 27 * (wq // 2) if b5 else 16 * wq
    cap_t = 27 * (wt // 2) if b5 else 16 * wt
    ql = rng.integers(0, cap_q + 1, B).astype(np.int32)
    ql[:4] = (cap_q, 1, 0, 33)
    tl = rng.integers(0, cap_t + 1, B).astype(np.int32)
    tl[:4] = (cap_t, 0, 17, cap_t - 1)
    return qw, ql, tw, tl


@pytest.mark.parametrize("b5", (False, True), ids=("2bit", "b5"))
def test_wavefront_matches_reference(b5):
    """The emulated schedule in every form for its nb against the JAX
    package's packed scans (edit distance, best match, and for 2-bit the
    prefix distance and every end within a threshold); the reference is
    kept to 2 blocks (XLA-CPU compiles its scan for minutes at 4)."""
    rng = np.random.default_rng(7 + b5)
    wq, wt = (4, 8) if b5 else (4, 6)
    qw, ql, tw, tl = _packed_batch(rng, b5, wq, wt, 40)
    if b5:
        peq = align._peq_b5(torch.from_numpy(qw), torch.from_numpy(ql)).numpy()
    else:
        peq = align.peq_from_packed(torch.from_numpy(qw), torch.from_numpy(ql)).numpy()
    nb = peq.shape[2]
    assert nb == 2
    empty = ql == 0
    flat = tw.reshape(-1)
    for lanes, bpl in _forms(nb):
        run = lambda mode, e=None: wavefront(peq, ql, flat, tl, wt, wt, mode, b5, e, lanes, bpl)
        dist = np.where(empty, tl, run("global").numpy())
        best, end = (np.where(empty, 0, x.numpy()) for x in run("semiglobal"))
        if b5:
            assert np.array_equal(dist, np.asarray(ref.edit_distance_packed_b5(qw, ql, tw, tl)))
            want = ref.best_match_packed_b5(qw, ql, tw, tl)
        else:
            assert np.array_equal(dist, np.asarray(ref.edit_distance_packed(qw, ql, tw, tl)))
            want = ref.best_match_packed(qw, ql, tw, tl)
            pbest, pend = (np.where(empty, 0, x.numpy()) for x in run("prefix"))
            pwant = ref.prefix_distance_packed(qw, ql, tw, tl)
            assert np.array_equal(pbest, np.asarray(pwant[0])) and np.array_equal(pend, np.asarray(pwant[1]))
            errs = np.array([(0, 2, INT32_MAX)[i % 3] for i in range(len(ql))], np.int32)
            assert np.array_equal(run("ends", errs).numpy(), np.asarray(ref.match_ends_packed(qw, ql, tw, tl, errs)))
        assert np.array_equal(best, np.asarray(want[0])) and np.array_equal(end, np.asarray(want[1])), (lanes, bpl)
