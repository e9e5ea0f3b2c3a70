"""The streaming runtime: host-sharded record streams through the batch
codecs, with a resumable manifest.

The port's counterpart of ``cute_nucleotides_tpu/parallel/runtime.py``, with
its names, arguments, delivery semantics, stage timers, error types and
messages:

* :func:`initialize` joins a ``torch.distributed`` group across processes
  (one card a rank) and reports the topology; a no-op for one process.
* :class:`StreamingEncoder` is the production loop: host-sharded record
  stream -> fixed-shape padded batches -> pinned H2D copy -> codec kernel ->
  D2H copy -> sink callback, with per-batch metrics and a resumable
  stream-position manifest.  Because the codec is stateless, failure
  recovery is re-dispatching batches from the manifest position: there is no
  model state to restore.
* :class:`StreamingDecoder` is its mirror: packed entries -> decode kernel ->
  exact-length bytes -> sink.

On the card each batch's upload, kernel and download run on three streams of
:class:`.data_parallel.ShardedCodec`, so the D2H of batch N overlaps the H2D
of batch N+1 and the kernels; the main thread only enqueues, and a worker
thread waits on each batch's done event (``readback_s``), checks its flag,
sinks it and advances the manifest.  The CPU runs a stream only where the
caller asks for it (``device="cpu"`` or ``tier="torch"``); without CUDA the
default device raises.

Delivery semantics: **at-least-once**.  The sink runs *before* the manifest
advances (a manifest must never claim un-sunk work), so a crash in the window
between a successful sink and the manifest write re-delivers that batch on
resume.  Sinks must therefore be idempotent per ``batch.index`` (e.g. write
to a per-batch path, or upsert keyed on the batch index); no batch is ever
lost or skipped.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from ..ops import native, seqops, spec
from ..utils import checkpoint as ckpt_lib
from ..utils import io as io_lib
from ..utils import metrics as metrics_lib
from . import data_parallel


def _host_topology() -> tuple[int, int]:
    """(host id, host count): the rank and world size of an initialized
    ``torch.distributed`` process group, else (0, 1), so every rank of a
    user's group consumes its own shard of the stream."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank(), torch.distributed.get_world_size()
    return 0, 1


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> dict:
    """Initialize the multi-process runtime; a no-op for a single process.

    With a coordinator address (``host:port``) or more than one process,
    join a ``torch.distributed`` group: NCCL where CUDA is available, gloo
    where it is not.  The address gives ``tcp://<address>``; without one
    the group comes from the environment (``env://``, as ``torchrun`` sets
    ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``), and so
    do the process count and id where they are omitted (so under
    ``torchrun`` a call without arguments joins).  A coordinator
    address alone never reports a one-process topology: it joins a group or
    raises.  On the card, the process's local rank picks its card
    (``LOCAL_RANK``, else ``process_id % device_count``), so each rank's
    streams run on their own card and consume their own residue class of
    records.  A group the caller initialized is used as it is (so a caller
    may run gloo on the card, as two ranks on one card must).  The report
    counts devices as the default mesh does (:func:`.mesh.devices`): in a
    group, one a rank (its card, or the CPU), ``process_count`` in all;
    outside one, every local card.
    """
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is not None or (num_processes is not None and num_processes > 1):
        if not torch.distributed.is_initialized():
            torch.distributed.init_process_group(
                "nccl" if torch.cuda.is_available() else "gloo",
                init_method=f"tcp://{coordinator_address}" if coordinator_address is not None else "env://",
                world_size=num_processes if num_processes is not None else -1,
                rank=process_id if process_id is not None else -1,
            )
    in_group = torch.distributed.is_available() and torch.distributed.is_initialized()
    if in_group and torch.cuda.is_available():
        local = os.environ.get("LOCAL_RANK")
        rank = torch.distributed.get_rank()
        torch.cuda.set_device(int(local) if local is not None else rank % torch.cuda.device_count())
    host_id, num_hosts = _host_topology()
    # in a group one entry a rank, as mesh.devices() and default_mesh() count them
    local = 1 if in_group else torch.cuda.device_count() if torch.cuda.is_available() else 1
    return {
        "process_index": host_id,
        "process_count": num_hosts,
        "local_devices": local,
        "global_devices": local * num_hosts,
    }


def _prefetch(
    iterable: Iterable, depth: int = 1, stages: dict | None = None
) -> Iterator:
    """Run ``iterable`` in a background thread, ``depth`` items ahead.

    The host-side batch prep (record padding/packing) is NumPy and C++ that
    release the GIL in their hot copies, so the prefetch overlaps prep of
    batch N+depth with the device work of batch N.  Exceptions from the
    producer re-raise at the consumption point; the queue depth bounds host
    memory to ``depth + 1`` in-flight batches.  When ``stages`` is given,
    time the consumer spends *blocked* on the producer accumulates into
    ``stages["prep_wait_s"]``: nonzero means host parse/assembly is not
    hidden by the pipeline.
    """
    q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
    sentinel = object()
    failure: list[BaseException] = []
    stop = threading.Event()

    def _put(item) -> bool:
        # a bounded put that gives up once the consumer abandoned the
        # generator, so an aborted pipeline does not pin the thread and
        # its open input stream
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterable:
                if not _put(item):
                    return
        except BaseException as e:  # re-raised on the consumer side
            failure.append(e)
        finally:
            _put(sentinel)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            t0 = time.perf_counter()
            item = q.get()
            if stages is not None:
                stages["prep_wait_s"] += time.perf_counter() - t0
            if item is sentinel:
                if failure:
                    raise failure[0]
                return
            yield item
    finally:
        stop.set()


def _pipelined(
    items: Iterator,
    dispatch: Callable,
    finish: Callable,
    *,
    readback_depth: int,
    stages: dict,
) -> None:
    """Drive the dispatch/finish halves of a streaming pipeline with the
    finish half on its own thread.

    ``dispatch(item)`` enqueues the device work (H2D, kernel, D2H, all
    asynchronous) and returns a pending token; ``finish(pending)`` waits for
    the readback and runs sink/accounting.  Running finish on a worker
    thread keeps the main thread enqueueing while earlier batches drain.  A
    single worker preserves batch order (the manifest's at-least-once
    contract needs in-order advancement); the bounded queue holds
    ``readback_depth`` batches of device output alive.  Worker exceptions
    re-raise here after an orderly drain; a failed finish never lets later
    batches sink (the worker discards them).
    """
    fq: queue.Queue = queue.Queue(maxsize=max(readback_depth, 1))
    sentinel = object()
    failure: list[BaseException] = []

    def worker():
        while True:
            item = fq.get()
            if item is sentinel:
                return
            if failure:
                continue  # drain without sinking past a failure
            try:
                t0 = time.perf_counter()
                finish(item)
                stages["finish_s"] += time.perf_counter() - t0
            except BaseException as e:
                failure.append(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        for item in items:
            if failure:
                break
            t0 = time.perf_counter()
            pending = dispatch(item)
            stages["dispatch_s"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            fq.put(pending)
            stages["backpressure_s"] += time.perf_counter() - t0
    finally:
        fq.put(sentinel)
        t.join()
        # close the (usually _prefetch) generator explicitly: an abort's
        # traceback can keep it referenced, and its producer thread would
        # run on
        close = getattr(items, "close", None)
        if close is not None:
            close()
    if failure:
        raise failure[0]


def _new_stages() -> dict:
    """Per-stage wall-second accumulators for the pipeline attribution.

    ``prep_wait_s``: main thread blocked on host parse/assembly;
    ``dispatch_s``: main thread inside the pinned staging copy and the
    enqueueing of H2D, kernel and D2H; ``backpressure_s``: main thread
    blocked because the readback worker is behind (D2H + sink are the
    bottleneck); ``finish_s``/``readback_s``/``sink_s``/``manifest_s``:
    worker-thread time (overlapped with dispatch, so these bound but do not
    sum into the wall; ``readback_s`` is the wait on each batch's done
    event).  ``prep_wait + dispatch + backpressure ~ wall`` attributes the
    critical path.
    """
    return {
        "prep_wait_s": 0.0,
        "dispatch_s": 0.0,
        "backpressure_s": 0.0,
        "finish_s": 0.0,
        "readback_s": 0.0,
        "sink_s": 0.0,
        "manifest_s": 0.0,
    }


@dataclasses.dataclass
class StreamConfig:
    batch_size: int = 1024
    max_len: int = 2048
    codec: str = "2bit"
    #: "auto" (the kernels on the card), "cuda" or "torch" (eager PyTorch)
    tier: str = "auto"
    variant: str | None = None  # None -> the tier's default
    #: the identity on one device (the one shard holds the whole batch)
    gather: bool = False
    manifest_path: str | None = None
    log_every: int = 0
    allow_truncate: bool = False
    #: decode-side stream-integrity verification (base-5 only): the check
    #: is fused into the decode kernel's own read; a corrupt batch raises
    #: before anything is sunk or the manifest advances
    verify: bool = False
    #: encode-side input validation (both codecs): the check is fused into
    #: the encode kernel's one read; a batch containing a byte outside the
    #: codec's alphabet raises before anything is sunk
    validate: bool = False
    #: host-prep batches assembled ahead of the device (pipeline stage 1)
    prefetch_depth: int = 2
    #: device-output batches the readback worker may hold in flight
    #: (pipeline stage 3)
    readback_depth: int = 2
    #: None: the card (the CPU only with tier="torch"); or a torch device
    device: str | torch.device | None = None


def _aggregate(logger, host_id: int, num_hosts: int, stages: dict) -> dict:
    agg = logger.aggregate()
    agg["host_id"] = host_id
    agg["num_hosts"] = num_hosts
    agg["stages"] = {k: round(v, 4) for k, v in stages.items()}
    return agg


def _readback(stages: dict, done, host: tuple, *, keep: bool) -> list[np.ndarray]:
    """Wait for a batch's download (timed as ``readback_s``) and return its
    host tensors as numpy arrays.  With ``keep`` (the arrays go to a sink,
    which may keep them) they are copied out of the pinned buffers, so the
    buffers return to the allocator's cache and pinned memory stays bounded
    by the batches in flight; else they are views."""
    t0 = time.perf_counter()
    if done is not None:
        done.synchronize()
    arrays = [t.numpy().copy() if keep else t.numpy() for t in host]
    stages["readback_s"] += time.perf_counter() - t0
    return arrays


class StreamingEncoder:
    """Streaming encode pipeline over this host's shard of a record stream."""

    def __init__(self, config: StreamConfig | None = None, **overrides):
        if config is None:
            config = StreamConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        self.config = config
        self.host_id, self.num_hosts = _host_topology()
        self.sharded = data_parallel.ShardedCodec(
            config.codec,
            device=config.device,
            variant=config.variant,
            tier=config.tier,
        )
        block = 32 if config.codec == "2bit" else 27
        self.block = block
        self.logger = metrics_lib.ThroughputLogger(
            name=f"stream-encode-h{self.host_id}", log_every=config.log_every
        )
        self.manifest = (
            ckpt_lib.Manifest(config.manifest_path)
            if config.manifest_path
            else None
        )

    def run(
        self,
        records: Iterable[io_lib.Record],
        sink: Callable[[np.ndarray, io_lib.Batch], None] | None = None,
    ) -> dict:
        """Consume this host's shard of ``records``; return aggregate metrics.

        ``sink(packed_words, batch)`` receives each encoded batch (host
        NumPy u32 words and the batch metadata including true lengths); the
        words are the sink's own and stay valid after it returns.  Resumes from the manifest
        position when one is configured.
        """
        cfg = self.config
        skip = self.manifest.batches_done(self.host_id) if self.manifest else 0
        sharded_records = io_lib.shard_records(
            records, self.host_id, self.num_hosts
        )
        stream = io_lib.BatchStream(
            sharded_records,
            cfg.batch_size,
            cfg.max_len,
            block=self.block,
            truncate=cfg.allow_truncate,
            skip=skip,
        )
        return self.run_batches(stream, sink, _skip_applied=True)

    def run_batches(
        self,
        batches: Iterable[io_lib.Batch],
        sink: Callable[[np.ndarray, io_lib.Batch], None] | None = None,
        *,
        _skip_applied: bool = False,
    ) -> dict:
        """Drive the pipeline from pre-assembled :class:`io.Batch` objects
        (e.g. :func:`utils.io.fastq_batches`, the parser with no per-record
        objects).

        Same delivery semantics as :meth:`run`; when a manifest is
        configured and the caller has not already applied its skip count,
        resume skipping happens here.
        """
        cfg = self.config
        if self.manifest and not _skip_applied:
            skip = self.manifest.batches_done(self.host_id)
            batches = (b for i, b in enumerate(batches) if i >= skip)
        self.logger.start()
        stages = _new_stages()

        def finish(pending):
            """Read back, validate, sink, account; then (and only then)
            advance the manifest, preserving the at-least-once contract."""
            batch, done, host = pending
            words_np, *bad = _readback(stages, done, host, keep=True)
            if bad and int(bad[0]):
                # an invalid input byte somewhere in the batch: diagnose on
                # the host (the rare path) and raise BEFORE sinking
                allow_n = cfg.codec == "base5"
                for row in range(batch.count):
                    seq = bytes(batch.reads[row, : int(batch.lengths[row])])
                    pos = native.find_invalid(seq, allow_n=allow_n)
                    if pos >= 0:
                        raise ValueError(
                            f"invalid byte {seq[pos:pos + 1]!r} at position "
                            f"{pos} of record index {int(batch.indices[row])}"
                        )
                raise ValueError(
                    "fused validity check flagged the batch but the host "
                    "scan found no invalid byte (kernel/oracle drift)"
                )
            if sink is not None:
                t0 = time.perf_counter()
                sink(words_np, batch)
                stages["sink_s"] += time.perf_counter() - t0
            self.logger.batch_done(
                nt=int(batch.lengths.sum()), reads=batch.count
            )
            if self.manifest:
                t0 = time.perf_counter()
                self.manifest.advance(self.host_id, 1, batch.count)
                self.manifest.save()
                stages["manifest_s"] += time.perf_counter() - t0

        def dispatch(batch):
            # only enqueues: the flag travels back beside the words, so
            # reading it here would block the main thread
            x = self.sharded.shard(batch.reads)
            if cfg.validate:
                out = self.sharded.encode_checked(x, gather=cfg.gather)
            else:
                out = (self.sharded.encode(x, gather=cfg.gather),)
            host, done = self.sharded.fetch(*out)
            return batch, done, host

        # four-stage software pipeline: the prefetch thread preps batches
        # ahead, the main thread enqueues upload, kernel and download, and
        # the readback worker waits for each batch and sinks it, so host
        # prep, H2D, kernel, D2H and sink all overlap
        t_run = time.perf_counter()
        try:
            _pipelined(
                _prefetch(batches, depth=cfg.prefetch_depth, stages=stages),
                dispatch,
                finish,
                readback_depth=cfg.readback_depth,
                stages=stages,
            )
        finally:
            self.sharded.synchronize()  # no copy outlives the run, failed or not
        stages["wall_s"] = time.perf_counter() - t_run
        return _aggregate(self.logger, self.host_id, self.num_hosts, stages)


class StreamingDecoder:
    """Streaming decode pipeline: packed entries -> ASCII reads.

    The mirror of :class:`StreamingEncoder` for the read-back direction:
    consumes an iterable of ``(name, length, words)`` entries (the `.nup`
    container's record format: u64 packed words plus the explicit nucleotide
    count the reference's decoders require), batches them into fixed shapes
    (:func:`..utils.io.pack_words_batch`: the word width bucketed to a power
    of two; the kernels take any width), decodes them on the device, and
    hands each record's exact-length bytes to ``sink``.

    Delivery is at-least-once with a manifest, exactly as for the encoder
    (sinks must be idempotent per record name).
    """

    def __init__(self, config: StreamConfig | None = None, **overrides):
        if config is None:
            config = StreamConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        self.config = config
        if config.verify and config.codec != "base5":
            raise ValueError(
                "verify=True is base-5 only: every 2-bit pattern decodes, "
                "there is no invalid state to detect"
            )
        self.host_id, self.num_hosts = _host_topology()
        # the decoder's variant knob selects a DECODE variant
        self.sharded = data_parallel.ShardedCodec(
            config.codec,
            device=config.device,
            decode_variant=config.variant,
            tier=config.tier,
        )
        self.per_word = 32 if config.codec == "2bit" else 27
        self.logger = metrics_lib.ThroughputLogger(
            name=f"stream-decode-h{self.host_id}", log_every=config.log_every
        )
        self.manifest = (
            ckpt_lib.Manifest(config.manifest_path)
            if config.manifest_path
            else None
        )

    def run(
        self,
        entries: Iterable[tuple[bytes, int, np.ndarray]],
        sink: Callable[[bytes, bytes], None],
    ) -> dict:
        """Decode this host's shard of ``entries``; ``sink(name, seq)`` gets
        each record's exact-length ASCII bytes.  Returns aggregate metrics."""
        cfg = self.config
        skip = self.manifest.batches_done(self.host_id) if self.manifest else 0
        mine = (
            e for i, e in enumerate(entries) if i % self.num_hosts == self.host_id
        )
        self.logger.start()

        def chunks():
            chunk: list[tuple[bytes, int, np.ndarray]] = []
            for entry in mine:
                chunk.append(entry)
                if len(chunk) == cfg.batch_size:
                    yield chunk
                    chunk = []
            if chunk:
                yield chunk

        def prepped():
            for i, chunk in enumerate(chunks()):
                if i < skip:
                    continue
                yield chunk, io_lib.pack_words_batch(chunk, cfg.batch_size)

        stages = _new_stages()

        def finish(pending):
            """Read back, verify, sink, account; then (and only then)
            advance the manifest, preserving the at-least-once contract."""
            chunk, done, host = pending
            dec_np, *bad = _readback(stages, done, host, keep=False)
            if bad and int(bad[0]):
                # corrupt stream: diagnose on the host (the rare path) and
                # raise BEFORE anything is sunk or the manifest advances
                for name, _, words in chunk:
                    v = spec.u64_to_u32_pairs(np.ascontiguousarray(words)).reshape(-1)
                    w = int(seqops.first_invalid_word_b5(torch.from_numpy(v)))
                    if w >= 0:
                        raise ValueError(
                            f"corrupt base-5 word {w} in record "
                            f"{name.decode(errors='replace')!s}"
                        )
                raise ValueError(
                    "fused integrity check flagged the batch but the host "
                    "scan found no corrupt word (check/scan divergence)"
                )
            t0 = time.perf_counter()
            for i, (name, length, _) in enumerate(chunk):
                sink(name, bytes(dec_np[i, :length]))
            stages["sink_s"] += time.perf_counter() - t0
            self.logger.batch_done(
                nt=sum(e[1] for e in chunk), reads=len(chunk)
            )
            if self.manifest:
                t0 = time.perf_counter()
                self.manifest.advance(self.host_id, 1, len(chunk))
                self.manifest.save()
                stages["manifest_s"] += time.perf_counter() - t0

        def dispatch(item):
            chunk, w32 = item
            x = self.sharded.shard(w32)
            if cfg.verify:
                out = self.sharded.decode_checked(x)
            else:
                out = (self.sharded.decode(x),)
            host, done = self.sharded.fetch(*out)
            return chunk, done, host

        # four-stage software pipeline, mirroring the encoder: prefetch
        # packs words ahead, the main thread enqueues upload, kernel and
        # download, the readback worker waits for each batch and sinks it
        t_run = time.perf_counter()
        try:
            _pipelined(
                _prefetch(prepped(), depth=cfg.prefetch_depth, stages=stages),
                dispatch,
                finish,
                readback_depth=cfg.readback_depth,
                stages=stages,
            )
        finally:
            self.sharded.synchronize()  # no copy outlives the run, failed or not
        stages["wall_s"] = time.perf_counter() - t_run
        return _aggregate(self.logger, self.host_id, self.num_hosts, stages)
