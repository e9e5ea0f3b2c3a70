"""Data-parallel batch codec, on one device.

The port's counterpart of ``cute_nucleotides_tpu/parallel/data_parallel.py``
(``ShardedCodec``), for one ``torch.device``.  Reads are independent, so the
reference's data parallelism is pure sharding of the batch axis; on one
device a shard is the whole batch, and its ``psum`` of per-shard flags is the
batch's own flag.  The functional ``data_parallel_*`` forms and the
collectives across devices come with the multi-device layer.

On a CUDA device the codec keeps three streams, so that the copies of one
batch overlap the kernels and copies of its neighbours:

* **upload**: :meth:`ShardedCodec.shard` copies a host batch into pinned
  memory and from there, non-blocking, onto the card;
* **compute**: it waits on the upload (an event), and the codec's kernels
  launch on it (the kernel wrappers launch on the current stream);
* **download**: :meth:`ShardedCodec.fetch` waits on the compute stream,
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

CODECS = ("2bit", "base5")


def resolve_stream_device(tier: str, device=None) -> torch.device:
    """The device a stream runs on.  ``None`` means the card, unless the tier
    is ``torch`` (the CPU, as for the codecs); the CPU runs only where the
    caller asks for it (``device="cpu"`` or ``tier="torch"``).  Raises
    ``RuntimeError`` where the card is asked for and CUDA is not available."""
    if device is None and tier != "torch":
        device = "cuda"
    return models.resolve_device(tier, device)


class ShardedCodec:
    """A batch codec bound to one device: host batch in, device words out.

    ``encode``/``decode`` return device tensors (u32 words, or u8 ASCII);
    ``encode_checked``/``decode_checked`` add an int32 scalar tensor, the
    count of flagged shards (0 iff the batch is clean: the reference's
    ``psum`` over one shard).  ``gather=True`` is the identity on one device:
    the one shard already holds the whole batch.
    """

    def __init__(
        self,
        codec: str = "2bit",
        *,
        device=None,
        variant: str | None = None,
        decode_variant: str | None = None,
        tier: str = "auto",
    ):
        if codec not in CODECS:
            raise ValueError(f"unknown codec {codec!r}; expected one of {CODECS}")
        self.codec = codec
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
        else:
            self.upload = self.compute = self.download = None

    def _computing(self):
        return torch.cuda.stream(self.compute) if self.compute is not None else contextlib.nullcontext()

    def shard(self, host_batch) -> torch.Tensor:
        """Place a host batch (u8[B, L] reads or u32[B, 2W] words) on the
        device.  On the card: a pinned, non-blocking copy on the upload
        stream, which the compute stream waits on."""
        t = torch.from_numpy(np.ascontiguousarray(host_batch))
        if self.upload is None:
            return t.to(self.device)
        pinned = t.pin_memory()
        with torch.cuda.stream(self.upload):
            x = pinned.to(self.device, non_blocking=True)
        self.compute.wait_stream(self.upload)
        x.record_stream(self.compute)
        return x

    def encode(self, reads: torch.Tensor, gather: bool = False) -> torch.Tensor:
        with self._computing():
            return self.model.encode(reads)

    def decode(self, words: torch.Tensor, gather: bool = False) -> torch.Tensor:
        with self._computing():
            return self.model.decode(words)

    def encode_checked(self, reads: torch.Tensor, gather: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        """Encode + input-validity flag: (words, int32 count of flagged
        shards).  The check rides the encode kernel's one read of the input
        on the cuda tier (#3 or the checked #4 for 2-bit, #5 for base-5)."""
        with self._computing():
            words, bad = self.model.encode_checked(reads)
            return words, bad.any().to(torch.int32)

    def decode_checked(self, words: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Decode + stream-integrity flag (base-5 only): (ASCII, int32 count
        of flagged shards).  Fused into the decode kernel (#6) on the cuda
        tier."""
        if self.codec != "base5":
            raise ValueError(
                "decode_checked is base-5 only: every 2-bit pattern decodes, "
                "there is no invalid state to detect"
            )
        with self._computing():
            dec, bad = self.model.decode_checked(words)
            return dec, bad.to(torch.int32)

    def fetch(self, *tensors: torch.Tensor) -> tuple[tuple[torch.Tensor, ...], torch.cuda.Event | None]:
        """Copy device results to the host: fresh pinned tensors, filled on
        the download stream after the compute stream's work, and the event
        that marks their end (None off the card, where nothing is copied).
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
