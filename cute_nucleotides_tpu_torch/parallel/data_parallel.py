"""Data-parallel batch codec and analyses over a device mesh.

The port's counterpart of ``cute_nucleotides_tpu/parallel/data_parallel.py``,
with its names, arguments, messages and results.  Reads are independent, so
data parallelism is pure sharding: the batch axis is split over the mesh's
``"data"`` axis, each device runs the single-device function on its shard,
and no collective runs unless the result is replicated (gathered, summed).
A result is a :class:`.mesh.ShardedTensor`: sharded, each shard on its own
device, or replicated on every device of the axis; ``np.asarray`` of it is
the reference's array.  On a mesh of one device a shard is the whole batch
(a view, no copy) and a gather is the identity.  On a mesh across processes
(:mod:`.mesh`) every rank passes the same whole batch, runs the kernels of
its own shards alone, and the gathers and sums are one collective each over
the group; a sharded result then holds the rank's own shards.

Two entry styles:

* the functional forms :func:`data_parallel_encode` / ``_decode`` (and
  their checked forms, one ``psum`` of per-shard flags), and the analyses
  :func:`kmer_spectrum` (``psum``), :func:`match_counts` and
  :func:`edit_distances` (``all_gather``) and :func:`sketch_sharded`
  (``all_gather`` + ``ops.sketch.merge_many``);
* :class:`ShardedCodec`, the object API: over a mesh (``mesh=``) it calls
  the functional forms; bound to one device (``device=``, the streaming
  runtime's form) it keeps three CUDA streams, so that the copies of one
  batch overlap the kernels and copies of its neighbours:

  - **upload**: :meth:`ShardedCodec.shard` copies a host batch into pinned
    memory and from there, non-blocking, onto the card;
  - **compute**: it waits on the upload (an event), and the codec's kernels
    launch on it (the kernel wrappers launch on the current stream);
  - **download**: :meth:`ShardedCodec.fetch` waits on the compute stream,
    copies the results into fresh pinned host tensors and records a done
    event.

A tensor made on one stream and read on another is marked with
``record_stream``, so the caching allocator cannot hand its block to a later
batch while a copy or kernel still reads it.  Pinned staging buffers come
from PyTorch's caching host allocator, which records the copy's event on the
block: a freed buffer is not handed out again until its copy has finished.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .. import models
from ..ops import align as align_ops, kmer as kmer_ops, search as search_ops, sketch as sketch_ops
from . import mesh as mesh_lib
from .mesh import ShardedTensor

CODECS = ("2bit", "base5")


def _check_codec(codec: str) -> None:
    if codec not in CODECS:
        raise ValueError(f"unknown codec {codec!r}; expected one of {CODECS}")


def resolve_stream_device(tier: str, device=None) -> torch.device:
    """The device a stream runs on.  ``None`` means the card, unless the tier
    is ``torch`` (the CPU, as for the codecs); the CPU runs only where the
    caller asks for it (``device="cpu"`` or ``tier="torch"``).  Raises
    ``RuntimeError`` where the card is asked for and CUDA is not available."""
    if device is None and tier != "torch":
        device = "cuda"
    return models.resolve_device(tier, device)


def _codec_on(device: torch.device, codec: str, tier: str = "auto", variant=None, decode_variant=None):
    """A batch codec on ``device``: ``None`` variants take the tier's
    default, as the reference's take its tier's champion; the base-5 codec
    has none."""
    if codec == "2bit":
        return models.TwoBitCodec(tier=tier, encode_variant=variant, decode_variant=decode_variant, device=device)
    return models.Base5Codec(tier=tier, device=device)


def _codecs(mesh: mesh_lib.Mesh, codec: str, tier: str, variant=None, decode_variant=None) -> tuple:
    """The data axis (this process's view), and a batch codec on each of
    its devices (one per distinct device)."""
    _check_codec(codec)
    axis = mesh.axis(mesh_lib.DATA_AXIS)
    return axis, mesh_lib.per_device(axis.devices, lambda d: _codec_on(d, codec, tier, variant, decode_variant))


def _out(shards: list, axis, gather: bool) -> ShardedTensor:
    return mesh_lib.all_gather(shards, axis) if gather else ShardedTensor(shards, axis=axis)


def _flags(flags: list, axis) -> ShardedTensor:
    """The replicated int32 count of flagged shards (a ``psum``)."""
    return mesh_lib.psum([f.any().to(torch.int32) for f in flags], axis)


def data_parallel_encode(
    reads,
    *,
    mesh: mesh_lib.Mesh | None = None,
    codec: str = "2bit",
    variant: str | None = None,
    tier: str = "auto",
    gather: bool = False,
) -> ShardedTensor:
    """Encode u8[B, L] with B sharded over the mesh's data axis.

    ``gather=True`` all-gathers the packed words so the result is
    replicated (otherwise it stays sharded, the right form for a streaming
    sink).  B must divide by the data-axis size; L by 16 (2bit) / 27
    (base5).  ``variant=None`` resolves to the tier's default.
    """
    mesh = mesh if mesh is not None else mesh_lib.default_mesh()
    axis, codecs = _codecs(mesh, codec, tier, variant)
    shards = mesh_lib.shard_rows(reads, axis)
    return _out([c.encode(x) for c, x in zip(codecs, shards)], axis, gather)


def data_parallel_decode(
    words,
    *,
    mesh: mesh_lib.Mesh | None = None,
    codec: str = "2bit",
    variant: str | None = None,
    tier: str = "auto",
    gather: bool = False,
) -> ShardedTensor:
    """Decode packed u32[B, W] with B sharded over the mesh's data axis."""
    mesh = mesh if mesh is not None else mesh_lib.default_mesh()
    axis, codecs = _codecs(mesh, codec, tier, decode_variant=variant)
    shards = mesh_lib.shard_rows(words, axis)
    return _out([c.decode(w) for c, w in zip(codecs, shards)], axis, gather)


def data_parallel_encode_checked(
    reads,
    *,
    mesh: mesh_lib.Mesh | None = None,
    codec: str = "2bit",
    variant: str | None = None,
    tier: str = "auto",
    gather: bool = False,
) -> tuple[ShardedTensor, ShardedTensor]:
    """Encode + input-validity flag over the data axis: u8[B, L] ->
    (packed words sharded, replicated i32 flagged-shard count).

    The per-shard check rides the encode kernel's one read of the input on
    the cuda tier (#3, or #4's checked form for ``variant="mxu"``, for
    2-bit; #5 for base-5) and is a validity pass on the torch tier; one
    ``psum`` merges the flags (0 iff every byte on every device is in the
    codec's alphabet, either case).
    """
    mesh = mesh if mesh is not None else mesh_lib.default_mesh()
    axis, codecs = _codecs(mesh, codec, tier, variant)
    done = [c.encode_checked(x) for c, x in zip(codecs, mesh_lib.shard_rows(reads, axis))]
    return _out([w for w, _ in done], axis, gather), _flags([f for _, f in done], axis)


def data_parallel_decode_checked(
    words,
    *,
    mesh: mesh_lib.Mesh | None = None,
    tier: str = "auto",
) -> tuple[ShardedTensor, ShardedTensor]:
    """Base-5 decode + stream-integrity flag over the data axis: u32[B, 2W]
    -> (u8[B, 27W] sharded, replicated i32 flagged-shard count).

    The per-shard check is fused into the decode kernel (#6) on the cuda
    tier and is the standalone scan on the torch tier; one ``psum`` merges
    the flags.  Base-5 only -- every 2-bit pattern decodes, there is
    nothing to check.
    """
    mesh = mesh if mesh is not None else mesh_lib.default_mesh()
    axis, codecs = _codecs(mesh, "base5", tier)
    done = [c.decode_checked(w) for c, w in zip(codecs, mesh_lib.shard_rows(words, axis))]
    return ShardedTensor([d for d, _ in done], axis=axis), _flags([f for _, f in done], axis)


def _lengths(lengths, B: int) -> torch.Tensor:
    """Per-read lengths (a scalar or one a read) as int32[B] (contiguous:
    the kernels read them in place)."""
    return torch.as_tensor(lengths).to(torch.int32).reshape(-1).broadcast_to((B,)).contiguous()


def _rows_and_lengths(mesh, x, lengths) -> tuple:
    """The data axis (this process's view), ``x``'s row shards and each
    shard's lengths (int32, on its device)."""
    axis = (mesh if mesh is not None else mesh_lib.default_mesh()).axis(mesh_lib.DATA_AXIS)
    shards = mesh_lib.shard_rows(x, axis)
    return axis, shards, _split_like(_lengths(lengths, len(axis.entries) * shards[0].shape[0]), shards, axis)


def _split_like(v: torch.Tensor, shards: list, axis) -> list[torch.Tensor]:
    """``v`` cut into one equal block a position of the axis, and the
    blocks of this process's shards returned, each on its shard's
    device."""
    b = v.shape[0] // len(axis.entries)
    return [v[i * b : (i + 1) * b].to(s.device) for i, s in zip(axis.mine, shards)]


def kmer_spectrum(
    words,
    lengths,
    k: int,
    *,
    mesh: mesh_lib.Mesh | None = None,
    canonical: bool = False,
) -> ShardedTensor:
    """Global k-mer spectrum of a packed read batch over the mesh:
    u32[B, W] + lengths -> replicated i32[4**k].

    The batch axis shards over the data axis, each device runs the
    planar-extraction + histogram pass on its shard
    (:func:`..ops.kmer.kmer_histogram_batch`: #10 and #13 for k <= 8;
    windows never span reads, padding masked via ``lengths``), and one
    ``psum`` merges the 4**k-bin spectra.  B must divide by the data-axis
    size; k <= 12 (dense bins).
    """
    axis, shards, lens = _rows_and_lengths(mesh, words, lengths)
    hists = [kmer_ops.kmer_histogram_batch(w, n, k, canonical=canonical) for w, n in zip(shards, lens)]
    return mesh_lib.psum(hists, axis)


def match_counts(
    words,
    lengths,
    query: bytes,
    *,
    mesh: mesh_lib.Mesh | None = None,
    codec: str = "2bit",
) -> ShardedTensor:
    """Distributed grep over a packed read batch: per-read occurrence
    counts of ``query``, batch sharded over the data axis, all-gathered to
    a replicated i32[B].  ``codec="base5"`` scans interleaved base-5 rows
    (``N`` literal, ``?`` wildcard); B must divide by the data-axis size."""
    if isinstance(query, str):
        query = query.encode()
    axis, shards, lens = _rows_and_lengths(mesh, words, lengths)
    counts = [search_ops.match_counts_batch(w, n, bytes(query), codec=codec) for w, n in zip(shards, lens)]
    return mesh_lib.all_gather(counts, axis)


def sketch_sharded(
    words,
    lengths,
    k: int,
    s: int,
    *,
    mesh: mesh_lib.Mesh | None = None,
    canonical: bool = True,
) -> ShardedTensor:
    """Mesh-wide bottom-``s`` MinHash sketch of a packed read batch:
    u32[B, W] + lengths -> replicated sorted u32[s].

    Each device sketches its read shard (:func:`..ops.sketch.
    bottom_k_sketch_batch`; the hashes are #12 for k >= 16), and because
    sketches union-merge associatively, one ``all_gather`` of the D tiny
    ``u32[s]`` summaries + one distinct pass
    (:func:`..ops.sketch.merge_many`) replaces any pairwise reduction tree.
    B must divide by the data-axis size.
    """
    axis, shards, lens = _rows_and_lengths(mesh, words, lengths)
    sketches = [sketch_ops.bottom_k_sketch_batch(w, n, k, s, canonical=canonical).view(1, -1)
                for w, n in zip(shards, lens)]
    every = mesh_lib.all_gather(sketches, axis)  # u32[D, s] on every device
    merged = {}
    for dev, whole in zip(axis.devices, every.shards):
        if dev not in merged:
            merged[dev] = sketch_ops.merge_many(whole)
    return ShardedTensor([merged[d] for d in axis.devices], replicated=True, axis=axis)


def edit_distances(
    qwords,
    qlens,
    twords,
    tlens,
    *,
    mesh: mesh_lib.Mesh | None = None,
    codec: str = "2bit",
) -> ShardedTensor:
    """Distributed batched edit distance: pair rows sharded over the data
    axis (pairs are independent -- pure data parallelism), global
    Levenshtein per pair (#19) all-gathered to a replicated i32[B].
    ``codec="base5"`` runs the digit-alphabet scan (``N`` literal).  B must
    divide by the data-axis size."""
    fn = align_ops.edit_distance_packed_b5 if codec == "base5" else align_ops.edit_distance_packed
    axis, qs, qls = _rows_and_lengths(mesh, qwords, qlens)
    ts = mesh_lib.shard_rows(twords, axis)
    tls = _split_like(_lengths(tlens, len(axis.entries) * ts[0].shape[0]), ts, axis)
    return mesh_lib.all_gather([fn(q, ql, t, tl) for q, ql, t, tl in zip(qs, qls, ts, tls)], axis)


class ShardedCodec:
    """A batch codec bound to a mesh or to one device: host batch in, device
    words out.

    Over a mesh (``mesh=``) it shards the batch axis over the data axis and
    returns :class:`.mesh.ShardedTensor` results from the functional forms
    above.  Bound to one device (``device=``, or neither: the card) it
    returns device tensors (u32 words, or u8 ASCII) and runs on three CUDA
    streams; ``gather=True`` is then the identity (the one shard already
    holds the whole batch).  ``encode_checked``/``decode_checked`` add an
    int32 count of flagged shards (0 iff the batch is clean: the reference's
    ``psum``).
    """

    def __init__(
        self,
        codec: str = "2bit",
        *,
        mesh: mesh_lib.Mesh | None = None,
        device=None,
        variant: str | None = None,
        decode_variant: str | None = None,
        tier: str = "auto",
    ):
        _check_codec(codec)
        if mesh is not None and device is not None:
            raise ValueError("ShardedCodec takes mesh= or device=, not both")
        self.codec, self.mesh = codec, mesh
        self.upload = self.compute = self.download = None
        if mesh is not None:  # the functional forms resolve tier and variants per device
            self.device, self.model, self.tier = None, None, tier
            self.variant, self.decode_variant = variant, decode_variant
            return
        self.device = resolve_stream_device(tier, device)
        self.tier = models.resolve_tier(tier, self.device)
        if codec == "2bit":
            self.model = models.TwoBitCodec(tier=self.tier, encode_variant=variant,
                                            decode_variant=decode_variant, device=self.device)
            self.variant, self.decode_variant = self.model.encode_variant, self.model.decode_variant
        else:  # the base-5 codec has no variants; the reference ignores them too
            self.model = models.Base5Codec(tier=self.tier, device=self.device)
            self.variant = self.decode_variant = None
        if self.device.type == "cuda":
            self.upload, self.compute, self.download = (torch.cuda.Stream(self.device) for _ in range(3))

    def _computing(self):
        return torch.cuda.stream(self.compute) if self.compute is not None else contextlib.nullcontext()

    def _forms(self) -> dict:
        return {"mesh": self.mesh, "codec": self.codec, "tier": self.tier}

    def shard(self, host_batch):
        """Place a host batch (u8[B, L] reads or u32[B, 2W] words): over the
        mesh's data axis, or on the device -- on the card a pinned,
        non-blocking copy on the upload stream, which the compute stream
        waits on."""
        if self.mesh is not None:
            axis = self.mesh.axis(mesh_lib.DATA_AXIS)
            return ShardedTensor(mesh_lib.shard_rows(host_batch, axis), axis=axis)
        t = torch.from_numpy(np.ascontiguousarray(host_batch))
        if self.upload is None:
            return t.to(self.device)
        pinned = t.pin_memory()
        with torch.cuda.stream(self.upload):
            x = pinned.to(self.device, non_blocking=True)
        self.compute.wait_stream(self.upload)
        x.record_stream(self.compute)
        return x

    def encode(self, reads, gather: bool = False):
        if self.mesh is not None:
            return data_parallel_encode(reads, variant=self.variant, gather=gather, **self._forms())
        with self._computing():
            return self.model.encode(reads)

    def decode(self, words, gather: bool = False):
        if self.mesh is not None:
            return data_parallel_decode(words, variant=self.decode_variant, gather=gather, **self._forms())
        with self._computing():
            return self.model.decode(words)

    def encode_checked(self, reads, gather: bool = False):
        """Encode + input-validity flag: (words, int32 count of flagged
        shards).  The check rides the encode kernel's one read of the input
        on the cuda tier (#3 or the checked #4 for 2-bit, #5 for base-5)."""
        if self.mesh is not None:
            return data_parallel_encode_checked(reads, variant=self.variant, gather=gather, **self._forms())
        with self._computing():
            words, bad = self.model.encode_checked(reads)
            return words, bad.any().to(torch.int32)

    def decode_checked(self, words):
        """Decode + stream-integrity flag (base-5 only): (ASCII, int32 count
        of flagged shards).  Fused into the decode kernel (#6) on the cuda
        tier."""
        if self.codec != "base5":
            raise ValueError(
                "decode_checked is base-5 only: every 2-bit pattern decodes, "
                "there is no invalid state to detect"
            )
        if self.mesh is not None:
            return data_parallel_decode_checked(words, mesh=self.mesh, tier=self.tier)
        with self._computing():
            dec, bad = self.model.decode_checked(words)
            return dec, bad.to(torch.int32)

    def fetch(self, *tensors: torch.Tensor) -> tuple[tuple[torch.Tensor, ...], torch.cuda.Event | None]:
        """Copy device results to the host: fresh pinned tensors, filled on
        the download stream after the compute stream's work, and the event
        that marks their end (None off the card and over a mesh, where
        nothing is copied).
        Each call's host tensors are its own until the caller drops them."""
        if self.download is None:
            return tensors, None
        self.download.wait_stream(self.compute)
        with torch.cuda.stream(self.download):
            host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
                         for t in tensors)
            done = torch.cuda.Event()
            done.record()
        for t in tensors:
            t.record_stream(self.download)
        return host, done

    def synchronize(self) -> None:
        """Wait for every copy and kernel the codec's streams hold."""
        for s in (self.upload, self.compute, self.download):
            if s is not None:
                s.synchronize()
