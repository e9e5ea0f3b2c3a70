"""The inputs of every cell, made from the seed: one general generator that
the traffic files' parameters drive.

Large tensors are drawn on the run's device with a ``torch.Generator`` in a
few large calls; small host-side choices (sites, guides, planted adapters)
come from a NumPy generator.  Each stream of draws has its own seed, derived
from ``--seed`` and a tag, so the same seed gives the same inputs whatever
else a run draws.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

#: 2-bit codes, as the crate packs them: A 0, C 1, T 2, G 3
BASES_2BIT = b"ACTG"
COMPLEMENT = bytes.maketrans(b"ACGTN", b"TGCAN")
#: rows drawn a call, so that the int32 draws stay a few hundred MB
ROWS_A_CALL = 1 << 18


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for one stream of draws."""
    h = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def torch_gen(device, seed: int, *tags) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, *tags))
    return g


def np_rng(seed: int, *tags) -> np.random.Generator:
    return np.random.default_rng(derive(seed, *tags))


def reads(device, seed: int, tag, n: int, read_nt: int, pad_nt: int, n_share: float) -> torch.Tensor:
    """``n`` reads of ``read_nt`` bases i.i.d. uniform over ACGT, each base
    an N with probability ``n_share``, padded with 'A' to ``pad_nt``:
    u8[n, pad_nt] on ``device``."""
    g = torch_gen(device, seed, "reads", tag)
    out = torch.full((n, pad_nt), ord("A"), dtype=torch.uint8, device=device)
    n_below = round(n_share * (1 << 18))
    for r0 in range(0, n, ROWS_A_CALL):
        r1 = min(n, r0 + ROWS_A_CALL)
        r = torch.randint(0, 1 << 20, (r1 - r0, read_nt), generator=g, device=device, dtype=torch.int32)
        c = r & 3
        b = 65 + 2 * (c == 1) + 6 * (c == 3) + 19 * (c == 2)
        out[r0:r1, :read_nt] = torch.where((r >> 2) < n_below, 78, b).to(torch.uint8)
    return out


def edited_tails(rng: np.random.Generator, n: int, adapter: bytes, len_lo: int, len_hi: int,
                 edits_hi: int) -> tuple[np.ndarray, np.ndarray]:
    """``n`` adapter prefixes of ``len_lo..len_hi`` nt, each with
    ``0..edits_hi`` random edits (a substitution, an insertion or a deletion
    at a random place): ``(bytes u8[n, W], lengths int64[n])``, the first
    ``lengths[i]`` bytes of row ``i`` being its tail."""
    width = len_hi + edits_hi
    alpha = np.frombuffer(b"ACGT", np.uint8)
    code = np.zeros(256, np.int64)
    code[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    t = np.zeros((n, width), np.uint8)
    t[:, : len(adapter)] = np.frombuffer(adapter, np.uint8)
    lens = rng.integers(len_lo, len_hi + 1, n)
    edits = rng.integers(0, edits_hi + 1, n)
    rows, j = np.arange(n), np.arange(width)[None, :]
    for k in range(edits_hi):
        act = edits > k
        pos = np.minimum((rng.random(n) * lens).astype(np.int64), lens - 1)
        kind = rng.integers(0, 3, n)
        base = alpha[rng.integers(0, 4, n)]
        shift = rng.integers(1, 4, n)
        cur = code[t[rows, pos]]
        sub = t.copy()
        sub[rows, pos] = alpha[(cur + shift) % 4]
        ins = t[rows[:, None], np.where(j < pos[:, None], j, np.maximum(j - 1, 0))]
        ins[rows, pos] = base
        dele = t[rows[:, None], np.where(j < pos[:, None], j, np.minimum(j + 1, width - 1))]
        pick = (act & (kind == 0))[:, None], (act & (kind == 1))[:, None], (act & (kind == 2))[:, None]
        t = np.where(pick[0], sub, np.where(pick[1], ins, np.where(pick[2], dele, t)))
        lens = lens + (act & (kind == 1)) - (act & (kind == 2))
        lens = np.clip(lens, 1, width)
    return t, lens


def plant_tails(batch: torch.Tensor, rows: np.ndarray, tails: np.ndarray, lens: np.ndarray, read_nt: int) -> None:
    """Write each tail over the 3' end of its read (the last ``lens[i]`` of
    the first ``read_nt`` bytes of row ``rows[i]``)."""
    width = tails.shape[1]
    j = np.arange(width)[None, :]
    # right-align each tail in a window that ends at read_nt
    src = j - (width - lens[:, None])
    aligned = np.where(src >= 0, np.take_along_axis(tails, np.clip(src, 0, width - 1), 1), 0)
    dev = batch.device
    idx = torch.from_numpy(rows).to(dev)
    window = batch[idx, read_nt - width: read_nt]
    keep = torch.from_numpy(src < 0).to(dev)
    batch[idx, read_nt - width: read_nt] = torch.where(keep, window, torch.from_numpy(aligned).to(dev))


def genome_2bit(device, seed: int, lengths: list[int]) -> tuple[torch.Tensor, list[int]]:
    """A genome of the given chromosome lengths, bases i.i.d. uniform over
    ACGT, packed 2 bits a base (16 a u32, LSB first) in one buffer:
    ``(words u32[W], word offsets)``, each chromosome starting on a 16-byte
    boundary.  The words past a chromosome's end are random too."""
    offsets, at = [], 0
    for n in lengths:
        offsets.append(at)
        at += 4 * -(-n // 64)
    g = torch_gen(device, seed, "genome")
    words = torch.empty(at, dtype=torch.int32, device=device)
    step = 1 << 24
    for w0 in range(0, at, step):
        w1 = min(at, w0 + step)
        x = torch.empty(w1 - w0, dtype=torch.int64, device=device).random_(0, 1 << 32, generator=g)
        words[w0:w1] = x.view(torch.int32)[0::2]
    return words.view(torch.uint32), offsets


def genome_codes(words: torch.Tensor, offsets: list[int], chrom: np.ndarray, pos: np.ndarray, width: int) -> np.ndarray:
    """The 2-bit codes of ``width`` bases from each ``(chrom, pos)``:
    int64[n, width] on the host."""
    dev = words.device
    w = words.view(torch.int32)
    start = torch.from_numpy(np.asarray(offsets, np.int64)[chrom] * 16 + pos).to(dev)
    g = start[:, None] + torch.arange(width, device=dev)
    return ((w[g >> 4] >> ((g & 15) * 2).to(torch.int32)) & 3).cpu().numpy().astype(np.int64)


def revcomp(q: bytes) -> bytes:
    return q.translate(COMPLEMENT)[::-1]


def guides(rng: np.random.Generator, words: torch.Tensor, offsets: list[int], lengths: list[int], n: int,
           spacer_nt: int, pam: bytes, from_genome: float) -> list[bytes]:
    """``n`` guides (spacer then PAM), a share ``from_genome`` of them with
    spacers read from the genome at sites followed by the PAM's fixed bases
    (the 'GG' of 'NGG'), the rest drawn uniformly; in a shuffled order."""
    n_gen = round(n * from_genome)
    lens = np.asarray(lengths, np.int64)
    width = spacer_nt + len(pam)
    fixed = [(i, BASES_2BIT.index(b)) for i, b in enumerate(pam) if b != ord("N")]
    found: list[np.ndarray] = []
    while sum(len(f) for f in found) < n_gen:
        k = 32 * max(n_gen, 1)
        chrom = rng.choice(len(lens), k, p=lens / lens.sum())
        pos = (rng.random(k) * (lens[chrom] - width)).astype(np.int64)
        codes = genome_codes(words, offsets, chrom, pos, width)
        ok = np.ones(k, bool)
        for i, c in fixed:
            ok &= codes[:, spacer_nt + i] == c
        found.append(codes[ok, :spacer_nt])
    spacers = np.concatenate(found)[:n_gen] if n_gen else np.zeros((0, spacer_nt), np.int64)
    spacers = np.concatenate([spacers, rng.integers(0, 4, (n - n_gen, spacer_nt))])
    spacers = spacers[rng.permutation(n)]
    alpha = np.frombuffer(BASES_2BIT, np.uint8)
    return [alpha[s].tobytes() + pam for s in spacers]
