"""Semiglobal edit distance by Myers' bit-parallel recurrence, in plain
PyTorch over many lanes at once.

A lane is one (query, text row) pair.  Query row ``i`` is bit ``i`` of the
lane's vertical delta vectors; the text is read one character a step, all
lanes together.  Semiglobal: the text's prefix is free (row 0 of the DP is
0), so the horizontal delta entering row 0 is 0.  Each lane keeps the least
``D[m][j]`` over its ends ``j`` and the first ``j`` (1-based) that reaches
it; a lane that never beats the empty alignment reads ``(m, 0)``.

The recurrence (Hyyro's form of Myers 1999), each vector cut to ``m`` bits:

    Xv = Eq | Mv;  Xh = (((Eq & Pv) + Pv) ^ Pv) | Eq
    Ph = Mv | ~(Xh | Pv);  Mh = Pv & Xh;  score += Ph[m-1] - Mh[m-1]
    Ph <<= 1;  Mh <<= 1;  Pv = Mh | ~(Xv | Ph);  Mv = Ph & Xv
"""

from __future__ import annotations

import torch

#: text steps whose Eq rows are gathered at once
CHUNK = 32


def peq(query: bytes, code_of: dict, alphabet: int, wildcard: bytes = b"") -> list[int]:
    """Bitmask of each code: bit ``i`` set where query byte ``i`` matches it
    (every code for a wildcard byte)."""
    masks = [0] * alphabet
    for i, b in enumerate(query):
        codes = range(alphabet) if b in wildcard else (code_of[b],)
        for c in codes:
            masks[c] |= 1 << i
    return masks


def scan(codes, steps: int, tables: list[list[int]], lane_query: torch.Tensor, m: int,
         row_len: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Run every lane over ``steps`` text characters.

    ``codes(s0, s1)`` gives the text codes of steps ``s0 <= s < s1`` as
    int64 ``[s1 - s0, lanes]``; ``tables[q]`` is query ``q``'s bitmask per
    code, all of length ``m``; ``lane_query`` int64[lanes] names each lane's
    query; ``row_len`` int64[lanes] is how many steps of each lane are text
    (later steps are read but never counted).  Returns ``(best, end)``
    int64[lanes]."""
    dev = lane_query.device
    alphabet = len(tables[0])
    dtype = torch.int32 if m <= 30 else torch.int64
    flat = torch.tensor([v for t in tables for v in t], dtype=dtype, device=dev)
    offset = lane_query * alphabet
    lanes = lane_query.shape[0]
    mask, top = (1 << m) - 1, m - 1
    pv = torch.full((lanes,), mask, dtype=dtype, device=dev)
    mv = torch.zeros_like(pv)
    score = torch.full((lanes,), m, dtype=dtype, device=dev)
    best = score.clone()
    end = torch.zeros(lanes, dtype=torch.int64, device=dev)
    for s0 in range(0, steps, CHUNK):
        s1 = min(steps, s0 + CHUNK)
        eq_rows = flat[codes(s0, s1) + offset]
        for k in range(s1 - s0):
            eq = eq_rows[k]
            xv = eq | mv
            xh = (((eq & pv) + pv) ^ pv) | eq
            ph = (mv | ~(xh | pv)) & mask
            mh = pv & xh
            score += (ph >> top) - (mh >> top)
            ph = (ph << 1) & mask
            mh = (mh << 1) & mask
            pv = (mh | ~(xv | ph)) & mask
            mv = ph & xv
            pos = s0 + k + 1
            better = (score < best) & (row_len >= pos)
            best = torch.where(better, score, best)
            end = torch.where(better, pos, end)
    return best.to(torch.int64), end


def first_best(best: torch.Tensor, end: torch.Tensor, group: torch.Tensor, groups: int,
               m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per group of lanes (``group`` int64[lanes], absolute ``end``s): the
    least distance and the first end reaching it, ``(m, 0)`` where nothing
    beats the empty alignment."""
    big = torch.iinfo(torch.int64).max
    dmin = torch.full((groups,), m, dtype=torch.int64, device=best.device)
    dmin.scatter_reduce_(0, group, best, "amin", include_self=True)
    at = torch.where(best == dmin[group], end, big)
    emin = torch.full((groups,), big, dtype=torch.int64, device=best.device)
    emin.scatter_reduce_(0, group, at, "amin", include_self=True)
    return dmin, torch.where(dmin >= m, 0, emin)
