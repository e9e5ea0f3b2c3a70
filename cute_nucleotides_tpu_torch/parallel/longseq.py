"""Block-sharded long-sequence mode: one sequence split over the mesh's
``"seq"`` axis.

The port's counterpart of ``cute_nucleotides_tpu/parallel/longseq.py``,
with its names, arguments, checks, messages and results.  ONE sequence is
split at word-aligned boundaries and each shard runs the single-device
function on its block; the packed words concatenate bit-exactly because
both codecs are stateless per word:

* 2-bit: words cover disjoint 32-nt spans, so any 32-aligned split point is
  safe (shards use 16-nt u32 words; split points are 32-aligned so u32
  pairs stay in order);
* base-5: words cover disjoint 27-nt spans and a triplet never crosses a
  word, so 27-aligned splits are safe.

The halo scans (:func:`match_long`, :func:`match_long_b5`,
:func:`best_match_long`, :func:`best_match_long_b5`) give each shard its
block plus the successor shard's first ``H`` words (the reference's ring
``ppermute``), so a hit that crosses a shard boundary is seen by the shard
that owns its start word.  The last shard's ring halo would be shard 0's
head, which no valid window reads, so it is not sent.  Where a shard sits
on the stream's device its block and halo are one slice of the stream;
elsewhere they are copied to its device.  Each shard runs kernel #8, #9 or
#19 (on a CPU tensor its plain version); global positions and ends are
assembled on the host in int64, so a stream may pass 2^31 nt while every
shard-local value stays int32 (:func:`halo_plan`).  Every shard's kernel is
launched before any shard's result is read, so shards on different cards
run at once.

Inputs are the reference's (a u8 sequence as bytes or an array; u64 word
streams) or tensors: a u8 tensor to encode, a flat u32 word stream (the
device form: the little-endian halves of the u64 words) to decode or scan.
Results are host numpy arrays and ints, as the reference's.

On a seq axis across processes (:mod:`.mesh`) every rank holds the whole
input, so a rank's blocks and halos are slices of it and nothing is sent
before the scan; each rank runs its own shards' kernels, and the results
are gathered over the group in shard order: the encoded and decoded pieces,
the match positions (int64), each shard's (dist, first end) before the host
merge.  Every rank returns the whole result.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import align as align_ops, kernels, search as search_ops, spec
from . import data_parallel, mesh as mesh_lib


def shard_points_2bit(length: int, n_shards: int) -> list[int]:
    """Word-aligned split offsets for a 2-bit encode over ``n_shards``.

    Each interior boundary is a multiple of 32 nt so every shard owns whole
    u64 words; shards are balanced to within one word.
    """
    words = spec.num_words_2bit(length)
    return [min(32 * ((words * k) // n_shards), length) for k in range(n_shards + 1)]


def shard_points_b5(length: int, n_shards: int) -> list[int]:
    """27-aligned split offsets for a base-5 encode over ``n_shards``."""
    words = spec.num_words_b5(length)
    return [min(27 * ((words * k) // n_shards), length) for k in range(n_shards + 1)]


class HaloPlan(NamedTuple):
    """A halo scan's host plan over S shards.  Units are u32 words (2-bit)
    or u64 words (base-5, two u32 each): shard ``i``'s block is ``w_eq``
    units from unit ``i * w_eq``, its halo the next ``H``; ``base[i]`` is
    its first nt (int64); ``valid[i]`` (int32) is how many positions it
    claims: its match starts, or its text nt for a best match."""

    w_eq: int
    H: int
    valid: np.ndarray
    base: np.ndarray


def halo_plan(length: int, n_u32: int, m: int, n_shards: int, *, b5: bool = False, best: bool = False) -> HaloPlan:
    """The plan of :func:`match_long` (``best=False``) or
    :func:`best_match_long` (``best=True``), ``_b5`` with ``b5``, for a
    stream of ``n_u32`` u32 holding ``length`` nt and an ``m``-nt query.

    The halo covers the overhang of any window a shard claims: ``m`` nt for
    a match, ``2m - 2`` for a best match (any occurrence better than the
    trivial distance ``m``).  Everything is computed in int64; a best match
    clamps each shard's text to its block and halo, so a global stream may
    pass 2^31 nt while ``valid`` fits int32.  Raises ``ValueError`` where a
    shard's own positions would not (use more seq shards)."""
    per, units = (spec.NT_PER_WORD_B5, n_u32 // 2) if b5 else (spec.NT_PER_U32_2BIT, n_u32)
    if best:
        H = max(1, -(-(2 * m - 2) // per)) if b5 else align_ops.halo_words(m)
    else:
        H = -(-(m - 1) // per) + 1 if b5 else -(-m // per) + 1
    w_eq = max(-(-units // n_shards), H)  # one successor halo must cover the overhang
    base = per * np.int64(w_eq) * np.arange(n_shards, dtype=np.int64)
    span = per * (w_eq + H if best else w_eq)
    if span >= 2**31:
        raise ValueError(f"shard-local positions are int32: {n_shards} shards of {span} nt; use more seq shards")
    limit = np.int64(length) - (0 if best else m - 1)
    return HaloPlan(w_eq, H, np.clip(limit - base, 0, span).astype(np.int32), base)


def _seq_axis(mesh: mesh_lib.Mesh | None):
    """The seq axis as this process sees it; without a mesh, that of the
    reference's default (1, every device) mesh: every device of the group in
    an initialized process group, else every local card."""
    if mesh is None:
        mesh = mesh_lib.Mesh([mesh_lib._default_devices()])
    return mesh.axis(mesh_lib.SEQ_AXIS)


def _on_one(t: torch.Tensor, devices) -> torch.Tensor:
    """The whole stream on the shards' device where they share one (one
    copy, then every shard is a view), else where it is."""
    return t.to(devices[0]) if len(set(devices)) == 1 else t


def _seq_tensor(seq) -> torch.Tensor:
    if isinstance(seq, torch.Tensor):
        if seq.dtype != torch.uint8:
            raise TypeError(f"expected a u8 sequence, got {seq.dtype}")
        return seq.reshape(-1)
    if isinstance(seq, (bytes, bytearray)):
        seq = np.frombuffer(bytes(seq), dtype=np.uint8)
    return torch.from_numpy(np.ascontiguousarray(seq, dtype=np.uint8).reshape(-1))


def _word_stream(bits, *, pairs: bool) -> torch.Tensor:
    """The flat u32 stream of ``bits``: a u64 word array (the reference's
    form) as its little-endian halves, or a u32 tensor as it is (whole u64
    words where ``pairs``)."""
    if isinstance(bits, torch.Tensor):
        if bits.dtype != torch.uint32:
            raise TypeError(f"expected a u32 word stream, got {bits.dtype}")
        w32 = bits.reshape(-1)
        if pairs and w32.numel() % 2:
            raise ValueError("the stream must hold whole u64 words (an even u32 count)")
        return w32
    return torch.from_numpy(spec.u64_to_u32_pairs(np.ascontiguousarray(bits, dtype=np.uint64)).reshape(-1))


def _encode_long(seq, codec: str, mesh: mesh_lib.Mesh | None) -> np.ndarray:
    axis = _seq_axis(mesh)
    S = len(axis.entries)
    x = _on_one(_seq_tensor(seq), axis.devices)
    length = x.numel()
    if codec == "2bit":
        points = shard_points_2bit(length, S)
        block, words_for = spec.NT_PER_WORD_2BIT, spec.num_words_2bit
    else:
        points = shard_points_b5(length, S)
        block, words_for = spec.NT_PER_WORD_B5, spec.num_words_b5
    sizes = [2 * -(-(points[k + 1] - points[k]) // block) for k in range(S)]  # each shard's u32
    codecs = mesh_lib.per_device(axis.devices, lambda d: data_parallel._codec_on(d, codec))
    pieces = []  # every shard's kernel is launched before any result is read
    for k, dev, c in zip(axis.mine, axis.devices, codecs):
        piece = x[points[k] : points[k + 1]].to(dev)
        if not piece.numel():
            pieces.append(torch.empty(0, dtype=torch.uint32, device=dev))
            continue
        pad = -piece.numel() % block  # 'A' (code 0) leaves the last word's unused bits zero
        if pad:
            piece = torch.cat([piece, piece.new_full((pad,), ord("A"))])
        pieces.append(c.encode(mesh_lib.for_kernel(piece).view(1, -1)).view(-1))
    out = np.empty(2 * words_for(length), dtype=np.uint32)
    host = torch.from_numpy(out)
    for k, words in enumerate(mesh_lib._every_block(pieces, axis, sizes)):  # gathered in shard order
        host[2 * (points[k] // block) :][: words.numel()].copy_(words)
    return spec.u32_pairs_to_u64(out)


def encode_long_2bit(seq, *, mesh: mesh_lib.Mesh | None = None) -> np.ndarray:
    """Encode one long sequence 2-bit, sharded over the mesh's seq axis.

    Returns the same u64 word stream as the single-device encoder -- shard
    outputs concatenate bit-exactly thanks to 32-aligned boundaries.
    """
    return _encode_long(seq, "2bit", mesh)


def encode_long_b5(seq, *, mesh: mesh_lib.Mesh | None = None) -> np.ndarray:
    """Encode one long sequence base-5, sharded at 27-aligned boundaries."""
    return _encode_long(seq, "base5", mesh)


def _decode_long(bits, length: int, codec: str, mesh: mesh_lib.Mesh | None) -> np.ndarray:
    axis = _seq_axis(mesh)
    S = len(axis.entries)
    w32 = _word_stream(bits, pairs=True)
    n_words = w32.numel() // 2
    per_word = spec.NT_PER_WORD_2BIT if codec == "2bit" else spec.NT_PER_WORD_B5
    if length > n_words * per_word:
        raise ValueError(f"length {length} exceeds capacity {n_words * per_word}")
    w32 = _on_one(w32, axis.devices)
    points = [(n_words * k) // S for k in range(S + 1)]  # a balanced word split
    spans = [(per_word * points[k], min(per_word * points[k + 1], length)) for k in range(S)]
    codecs = mesh_lib.per_device(axis.devices, lambda d: data_parallel._codec_on(d, codec))
    pieces = []  # every shard's kernel is launched before any result is read
    for k, dev, c in zip(axis.mine, axis.devices, codecs):
        lo, hi = spans[k]
        if hi <= lo:
            pieces.append(torch.empty(0, dtype=torch.uint8, device=dev))
            continue
        piece = mesh_lib.for_kernel(w32[2 * points[k] : 2 * points[k + 1]].to(dev))
        pieces.append(c.decode(piece.view(1, -1)).view(-1)[: hi - lo])
    out = np.empty(length, dtype=np.uint8)
    host = torch.from_numpy(out)
    every = mesh_lib._every_block(pieces, axis, [max(hi - lo, 0) for lo, hi in spans])  # gathered in shard order
    for (lo, hi), nt in zip(spans, every):
        host[lo:hi].copy_(nt)
    return out


def decode_long_2bit(bits, length: int, *, mesh: mesh_lib.Mesh | None = None) -> np.ndarray:
    """Decode a long 2-bit word stream, words sharded over the seq axis."""
    return _decode_long(bits, length, "2bit", mesh)


def decode_long_b5(bits, length: int, *, mesh: mesh_lib.Mesh | None = None) -> np.ndarray:
    """Decode a long base-5 word stream, words sharded over the seq axis."""
    return _decode_long(bits, length, "base5", mesh)


def _halo_blocks(w32: torch.Tensor, axis, plan: HaloPlan, unit: int) -> list[torch.Tensor]:
    """Shard ``i``'s block and halo, ``unit`` u32 a plan unit, cut where the
    stream ends, on its device, for each shard ``i`` of this process; the
    last shard gets no halo (its ring halo, shard 0's head, is never read: a
    valid window ends inside the stream).  One slice of the stream where it
    lies on the shard's device: across processes every rank holds the whole
    stream, so no halo is sent."""
    w32 = _on_one(w32, axis.devices)
    W, S = w32.numel(), len(axis.entries)
    out = []
    for i, dev in zip(axis.mine, axis.devices):
        lo = min(unit * i * plan.w_eq, W)
        hi = min(unit * ((i + 1) * plan.w_eq + (plan.H if i + 1 < S else 0)), W)
        out.append(w32[lo:hi].to(dev))
    return out


def _positions(scan, blocks, plan: HaloPlan, per_word: int, axis) -> np.ndarray:
    """Sorted global match positions: each shard's bits (``scan(ext,
    n_starts)``, starts past its claim cleared), every shard launched before
    any is read, offset by its base, gathered in shard order."""
    valid, base = plan.valid.tolist(), plan.base.tolist()
    bits = [scan(mesh_lib.for_kernel(ext), valid[i]) if valid[i] else None for i, ext in zip(axis.mine, blocks)]
    pos = [torch.from_numpy(search_ops._bit_positions(b, per_word) + base[i] if b is not None
                            else np.zeros(0, dtype=np.int64)) for i, b in zip(axis.mine, bits)]
    return np.concatenate([p.cpu().numpy() for p in mesh_lib._every_block(pos, axis)])


def match_long(bits, length: int, query: bytes, *, mesh: mesh_lib.Mesh | None = None) -> np.ndarray:
    """Find every occurrence of ``query`` in ONE long 2-bit stream, the word
    stream block-sharded over the mesh's seq axis (``ops.search``
    semantics: ``N`` in the query is a wildcard).  Returns sorted global
    positions.

    Each shard scans its own words (kernel #8); windows crossing a shard
    boundary read the successor shard's head words (the halo), so no hit is
    lost at boundaries and no position is double-counted (a position
    belongs to the shard owning its start word).
    """
    axis = _seq_axis(mesh)
    q, care, m = search_ops.compile_query(query)
    if length - m + 1 <= 0:
        raise ValueError(f"stream length {length} shorter than query ({m})")
    w32 = _word_stream(bits, pairs=False)
    if length > w32.numel() * spec.NT_PER_U32_2BIT:
        raise ValueError("length exceeds stream capacity")
    plan = halo_plan(length, w32.numel(), m, len(axis.entries))
    blocks = _halo_blocks(w32, axis, plan, 1)
    return _positions(lambda ext, n: kernels.match_bits_stream(ext, q, care, n), blocks, plan,
                      spec.NT_PER_U32_2BIT, axis)


def match_long_b5(bits, length: int, query: bytes, *, mesh: mesh_lib.Mesh | None = None) -> np.ndarray:
    """Find every occurrence of ``query`` in ONE long base-5 stream, the
    word stream block-sharded over the mesh's seq axis (``ops.search``
    base-5 semantics: ``N`` literal, ``?`` wildcard).  Returns sorted
    global positions.

    The 27-nt mirror of :func:`match_long`: each shard owns whole u64 words
    and runs the base-5 search kernel (#9) on its block extended by the
    successor's head words, so hits crossing shard boundaries are seen
    exactly once (a position belongs to the shard owning its start word).
    """
    axis = _seq_axis(mesh)
    m = len(query)
    if m > search_ops._B5_SEARCH_MAX_QUERY:
        # the kernel's lookahead bounds the query; refuse rather than miss
        # hits that cross a block
        raise ValueError(
            f"kernel scan caps queries at {search_ops._B5_SEARCH_MAX_QUERY} nt (got {m}); use "
            "match_mask_b5 on gathered words for longer queries"
        )
    qc = search_ops.compile_query_b5(query)
    if length - m + 1 <= 0:
        raise ValueError(f"stream length {length} shorter than query ({m})")
    w32 = _word_stream(bits, pairs=True)
    if length > (w32.numel() // 2) * spec.NT_PER_WORD_B5:
        raise ValueError("length exceeds stream capacity")
    plan = halo_plan(length, w32.numel(), m, len(axis.entries), b5=True)
    blocks = _halo_blocks(w32, axis, plan, 2)
    return _positions(lambda ext, n: kernels.match_b5_bits_stream(ext, qc, n), blocks, plan,
                      spec.NT_PER_WORD_B5, axis)


def _best_of_shards(run, blocks, plan: HaloPlan, m: int, axis) -> tuple[int, int]:
    """Every shard's (dist, first global end) from ``run(ext, valid)``,
    launched before any is read (a shard that claims no text gives the
    trivial ``(m, 0)``), gathered in shard order and merged on the host in
    int64: the least distance and, among shards that reach it below ``m``,
    the first global end."""
    valid, base = plan.valid.tolist(), plan.base.tolist()
    found = []
    for i, ext in zip(axis.mine, blocks):
        d, e = run(ext, valid[i]) if valid[i] else (m, 0)
        found.append(torch.stack([torch.as_tensor(d, dtype=torch.int64, device=ext.device),
                                  torch.as_tensor(e, dtype=torch.int64, device=ext.device) + base[i]]).view(1, 2))
    best = (m, 0)
    for pair in mesh_lib._every_block(found, axis, [1] * len(axis.entries)):
        d, end = pair.view(-1).tolist()
        if d < best[0] or (d == best[0] < m and end < best[1]):
            best = (d, end)
    return best


def best_match_long(bits, length: int, query: bytes, *, mesh: mesh_lib.Mesh | None = None) -> tuple[int, int]:
    """Best approximate occurrence of ``query`` in ONE long 2-bit stream,
    the word stream block-sharded over the mesh's seq axis (Myers
    bit-parallel semiglobal, ``ops.align`` semantics: ``N`` in the query
    matches any base).  Returns ``(dist, end)`` -- the minimum edit
    distance of the full query against any substring, and the first end
    position achieving it (``(m, 0)`` when nothing beats the trivial
    empty-substring alignment).

    Each shard scans its own words plus the successor shard's head (2m - 2
    nt: the span bound for any occurrence beating distance m), split into
    overlapping rows (:func:`..ops.align.best_match_stream`'s plan) for
    kernel #19, so the strictly text-sequential DP runs shard- AND
    lane-parallel.  Duplicated sightings across shards are harmless: the
    global result is the lexicographic min of per-shard bests.  Unlike the
    one-device scan, the stream may pass 2^31 nt.
    """
    axis = _seq_axis(mesh)
    peq, m = align_ops.peq_from_bytes(query)
    w32 = _word_stream(bits, pairs=False)
    if length > w32.numel() * spec.NT_PER_U32_2BIT:
        raise ValueError("length exceeds stream capacity")
    plan = halo_plan(length, w32.numel(), m, len(axis.entries), best=True)
    rows = align_ops.stream_rows_plan(plan.w_eq + plan.H, m)
    blocks = _halo_blocks(w32, axis, plan, 1)
    return _best_of_shards(lambda ext, v: align_ops._best_match_stream_impl(peq, ext, v, m, rows), blocks, plan, m,
                           axis)


def best_match_long_b5(bits, length: int, query: bytes, *, mesh: mesh_lib.Mesh | None = None) -> tuple[int, int]:
    """Base-5 mirror of :func:`best_match_long`: approximate search over
    ONE long base-5 stream, pair-aligned shards on the seq axis (``N``
    literal, ``?`` wildcard)."""
    axis = _seq_axis(mesh)
    peq, m = align_ops.peq_from_bytes_b5(query)
    w32 = _word_stream(bits, pairs=True)
    if length > (w32.numel() // 2) * spec.NT_PER_WORD_B5:
        raise ValueError("length exceeds stream capacity")
    plan = halo_plan(length, w32.numel(), m, len(axis.entries), b5=True, best=True)
    rows = align_ops.stream_rows_plan_b5(plan.w_eq + plan.H, m)
    blocks = _halo_blocks(w32, axis, plan, 2)
    return _best_of_shards(lambda ext, v: align_ops._best_match_stream_impl_b5(peq, ext, v, m, rows), blocks, plan,
                           m, axis)
