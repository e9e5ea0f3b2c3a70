"""The plain reference on small cases checked by hand and by a plain DP."""

import numpy as np
import pytest
import torch

from nucbench import generate
from nucbench.drivers import adapter_scan, guide_search
from nucbench.reference import b5, myers


def _u8(s: bytes) -> torch.Tensor:
    return torch.tensor([list(s)], dtype=torch.uint8)


def _u64(words: torch.Tensor) -> list[int]:
    return [int(v) for v in words.view(torch.int32).view(torch.int64)[0]]


def test_b5_pack_by_hand():
    assert _u64(b5.pack(b5.digits(_u8(b"A" * 27)))) == [0]
    assert _u64(b5.pack(b5.digits(_u8(b"C" + b"A" * 26)))) == [1]
    assert _u64(b5.pack(b5.digits(_u8(b"AAC" + b"A" * 24)))) == [25]
    assert _u64(b5.pack(b5.digits(_u8(b"AAACAA" + b"A" * 21)))) == [1 << 7]
    assert _u64(b5.pack(b5.digits(_u8(b"GTN" + b"A" * 24)))) == [3 + 5 * 2 + 25 * 4]
    assert _u64(b5.pack(b5.digits(_u8(b"N" * 27)))) == [sum(124 << (7 * k) for k in range(9))]


def test_b5_pack_matches_the_crates_golden_vector():
    # n_to_bits2_lut(b"ATCGN" * 7) == [0x36a45d1f46d48ba3, 0x5d1f4] in the crate's tests
    assert _u64(b5.pack(b5.digits(_u8(b"ATCGN" * 7 + b"A" * 19)))) == [0x36A45D1F46D48BA3, 0x5D1F4]


def test_b5_lowercase_u_and_invalid_bytes():
    d = b5.digits(_u8(b"acgtunACGTUN.X"))[0].tolist()
    assert d == [0, 1, 3, 2, 2, 4, 0, 1, 3, 2, 2, 4, 4, 0]
    assert not b5.has_invalid(_u8(b"acgtunACGTUN"))
    assert b5.has_invalid(_u8(b"ACGT."))
    assert bytes(b5.chars(b5.digits(_u8(b"acgun")))[0].tolist()) == b"ACGTN"


def test_b5_unpack_inverts_pack():
    x = generate.reads(torch.device("cpu"), 4, "u", 64, 150, 162, 0.05)
    d = b5.digits(x)
    assert torch.equal(b5.unpack(b5.pack(d)), d)
    assert b5.mismatches(b5.pack(d), b5.pack(d)) == 0


def _dp(q, t, wild):
    """Semiglobal DP: (least D[m][j], first j), (m, 0) where nothing beats m."""
    m = len(q)
    prev = list(range(m + 1))
    best, end = m, 0
    for j, c in enumerate(t):
        cur = [0] * (m + 1)
        for i in range(1, m + 1):
            sub = prev[i - 1] + (0 if (q[i - 1] == c or wild[i - 1]) else 1)
            cur[i] = min(sub, prev[i] + 1, cur[i - 1] + 1)
        prev = cur
        if cur[m] < best:
            best, end = cur[m], j + 1
    return best, end


@pytest.mark.parametrize("m", [1, 5, 23, 33, 40])
def test_scan_agrees_with_a_plain_dp(m):
    rng = np.random.default_rng(m)
    lanes, n = 40, 90
    q = rng.integers(0, 4, m)
    text = rng.integers(0, 4, (lanes, n))
    text[:10, 20:20 + m] = q  # exact occurrences
    row_len = rng.integers(0, n + 1, lanes)
    table = [sum(1 << i for i in range(m) if q[i] == c) for c in range(4)]
    codes = torch.from_numpy(text.T.copy())
    best, end = myers.scan(lambda s0, s1: codes[s0:s1], n, [table], torch.zeros(lanes, dtype=torch.int64), m,
                           torch.from_numpy(row_len))
    for lane in range(lanes):
        want = _dp(list(q), list(text[lane, : row_len[lane]]), [False] * m)
        assert (int(best[lane]), int(end[lane])) == want


def test_first_best_reduces_groups():
    best = torch.tensor([3, 2, 2, 5, 5])
    end = torch.tensor([10, 40, 30, 7, 9])
    d, e = myers.first_best(best, end, torch.tensor([0, 0, 0, 1, 1]), 2, 5)
    assert d.tolist() == [2, 5] and e.tolist() == [30, 0]


def test_guide_reference_agrees_with_a_plain_dp_on_both_strands():
    lengths = [2000, 1500]
    words, off = generate.genome_2bit(torch.device("cpu"), 5, lengths)
    texts = [generate.genome_codes(words, off, np.array([c]), np.array([0]), n)[0] for c, n in enumerate(lengths)]
    guide = bytes(b"ACTG"[v] for v in texts[1][700:720]) + b"NGG"
    queries = [guide, generate.revcomp(guide)]
    d, e = guide_search.reference(words, off, lengths, queries)
    for s, q in enumerate(queries):
        codes = [guide_search.CODE2.get(b, 0) for b in q]
        wild = [b == ord("N") for b in q]
        for c in range(2):
            assert (int(d[s, c]), int(e[s, c])) == _dp(codes, list(texts[c]), wild)
    assert d[0, 1] == 0 or texts[1][721:723].tolist() != [3, 3]


def test_adapter_reference_agrees_with_a_plain_dp():
    adapter = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
    x = generate.reads(torch.device("cpu"), 8, "a", 30, 150, 162, 0.02)
    x[3, 120:150] = torch.tensor(list(adapter[:30]), dtype=torch.uint8)
    d = b5.digits(x)[:, :150].contiguous()
    dist, end = adapter_scan.reference(d, adapter)
    q = [adapter_scan.CODE5[b] for b in adapter]
    for r in range(30):
        assert (int(dist[r]), int(end[r])) == _dp(q, d[r].tolist(), [False] * len(q))
    assert int(dist[3]) == 3 and int(end[3]) == 150
