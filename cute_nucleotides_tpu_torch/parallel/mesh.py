"""Device meshes: a (data, seq) grid of devices, the arrays a mesh axis
holds, and the collectives over an axis.

The port's counterpart of ``cute_nucleotides_tpu/parallel/mesh.py``, with
its axis names, :func:`make_mesh` and :func:`default_mesh` and their
errors.  A codec has one meaningful parallel axis -- reads are independent
-- so the default mesh is 1-D over every device, named ``"data"``; the
``"seq"`` axis shards one long sequence (:mod:`.longseq`).

A mesh is of one of two kinds:

* **One controller**: a grid of torch devices (``make_mesh(devices=[...])``,
  and ``make_mesh()`` outside a process group, over every local card).  One
  process drives every device and holds no process group; its collectives
  are host-driven -- :func:`all_gather` concatenates, :func:`psum` adds, and
  the long-sequence mode's ring halo is a slice of the successor's block.
  Each is a device-to-device copy only where two shards sit on different
  devices; on one device it is a view or a slice.  A mesh may name one
  device more than once: each entry is one logical shard, so 8 shards run
  on the CPU, or 4 on one card.
* **Across processes**: a grid of :class:`Device` entries, each a rank and
  its device (``make_mesh()`` in an initialized ``torch.distributed`` group,
  over :func:`devices`: one card a rank, the CPU where there is none).
  Every rank calls a form with the same whole input and computes only the
  shards that its own entries hold: an axis position is computed by every
  rank with an entry in its row (data) or column (seq), as the reference
  replicates over the other axis.  :func:`all_gather` and :func:`psum`
  first reduce the rank's own shards, then run ONE collective over the
  group (``all_gather_into_tensor`` of the shards' bytes, padded where the
  ranks' blocks differ in size; ``all_reduce(SUM)``): NCCL on the card,
  gloo on the CPU.  Gloo takes host tensors only, so under gloo a tensor on
  the card goes through host memory on its way in and out.  A collective
  runs in the current stream's order (NCCL's stream waits on it, gloo's
  staging copy runs on it), where the forms compute their shards.  Each
  position's copy is taken from one rank, its owner (the rank of the
  position's first entry).
"""

from __future__ import annotations

import collections
import math
from typing import NamedTuple

import numpy as np
import torch

DATA_AXIS = "data"
SEQ_AXIS = "seq"
AXES = (DATA_AXIS, SEQ_AXIS)

#: the collectives run over a process group, by backend
_COLLECTIVES: collections.Counter = collections.Counter()


def local_devices() -> list[torch.device]:
    """Every local card, once each (the counterpart of
    ``jax.local_devices()``).  Raises ``RuntimeError`` without CUDA: the
    CPU runs only where the caller passes CPU devices."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a mesh over the local cards needs CUDA, which is not available; pass "
            "devices=[torch.device('cpu')] * n to run a mesh on the CPU"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _group() -> tuple[int, int] | None:
    """(rank, world size) of an initialized ``torch.distributed`` group,
    else None."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return None


class Device(NamedTuple):
    """One entry of :func:`devices`: the rank that drives it and its torch
    device on that rank (the counterpart of a ``jax.Device`` and its
    ``process_index``)."""

    process_index: int
    device: torch.device


def devices(local=None) -> list[Device]:
    """Every rank's devices in rank order: the counterpart of
    ``jax.devices()``.

    ``local`` is what this rank contributes: by default its own card (the
    current device, by the one-card-a-rank rule of
    :func:`.runtime.initialize`), or the CPU where CUDA is not available; a
    test may pass logical shards (``[cpu] * 2``, the same count on every
    rank).  In an initialized group one ``all_gather_object`` collects every
    rank's list, so every rank must call it.  Outside a group: this
    process's devices, ``local`` or every local card."""
    group = _group()
    if group is None:
        return [Device(0, _device(d)) for d in (local_devices() if local is None else local)]
    if local is None:
        local = [_device("cuda") if torch.cuda.is_available() else torch.device("cpu")]
    every = [None] * group[1]
    torch.distributed.all_gather_object(every, [str(_device(d)) for d in local])
    return [Device(r, torch.device(d)) for r, names in enumerate(every) for d in names]


def _default_devices() -> list:
    """The devices of ``make_mesh()``: the group's in an initialized
    process group, else every local card."""
    return devices() if _group() is not None else local_devices()


class _Axis(NamedTuple):
    """One mesh axis as this process sees it.  ``entries`` are its
    positions' devices (a torch device, or a :class:`Device` across
    processes); ``mine`` the positions this process computes, ``devices``
    the torch device it computes each on; ``owner`` the rank whose copy of
    each position the collectives take (None for one controller, which
    computes every position)."""

    entries: tuple
    mine: tuple
    devices: tuple
    owner: tuple | None


def _layout(devices) -> _Axis:
    """An axis from a tuple of torch devices (one controller, every position
    this process's), or an :class:`_Axis` as it is."""
    if isinstance(devices, _Axis):
        return devices
    devices = tuple(devices)
    return _Axis(devices, tuple(range(len(devices))), devices, None)


class Mesh:
    """A (data, seq) grid of devices: torch devices driven by one process,
    or :class:`Device` entries across the ranks of a process group.
    ``shape[axis]`` is the axis size; :meth:`axis_devices` lists the
    devices along one axis (at index 0 of the other: the reference
    replicates over the other axis, which one controller need not compute
    twice), and :meth:`axis` this process's view of it.  ``rank`` is this
    process's rank on a mesh across processes, else None."""

    axis_names = AXES

    def __init__(self, devices):
        rows = [list(row) for row in devices]
        if not rows or not rows[0] or len({len(r) for r in rows}) != 1:
            raise ValueError("a mesh is a non-empty (data, seq) grid of devices")
        self.rank = None  # one controller
        kinds = {isinstance(d, Device) for r in rows for d in r}
        if kinds == {True}:
            group = _group()
            if group is None:  # outside a group the entries are this process's devices
                rows = [[d.device for d in r] for r in rows]
            else:
                held = {int(d.process_index) for r in rows for d in r}
                if held != set(range(group[1])):
                    raise ValueError(f"a mesh across processes holds a device of every rank: ranks {sorted(held)} "
                                     f"of a group of {group[1]}")
                self.rank = group[0]
        elif kinds != {False}:
            raise ValueError("a mesh holds torch devices or Device entries, not both")
        if self.rank is None:
            self.devices = tuple(tuple(_device(d) for d in r) for r in rows)
        else:
            self.devices = tuple(tuple(Device(int(d.process_index), torch.device(d.device)) for d in r) for r in rows)
        self.shape = {DATA_AXIS: len(self.devices), SEQ_AXIS: len(self.devices[0])}

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[SEQ_AXIS]

    def axis(self, name: str) -> _Axis:
        """This process's view of one axis (:class:`_Axis`)."""
        if name == DATA_AXIS:
            lines = self.devices
        elif name == SEQ_AXIS:
            lines = tuple(zip(*self.devices))
        else:
            raise ValueError(f"unknown mesh axis {name!r}; expected one of {AXES}")
        entries = tuple(line[0] for line in lines)
        if self.rank is None:
            return _layout(entries)
        mine = {}  # position -> this rank's first device in its line
        for i, line in enumerate(lines):
            for d in line:
                if d.process_index == self.rank:
                    mine.setdefault(i, d.device)
        return _Axis(entries, tuple(mine), tuple(mine.values()), tuple(d.process_index for d in entries))

    def axis_devices(self, axis: str) -> tuple:
        return self.axis(axis).entries

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[[str(d) for d in row] for row in self.devices]})"


def make_mesh(data: int | None = None, seq: int = 1, *, devices=None) -> Mesh:
    """Build a (data, seq) mesh.  ``data=None`` uses all remaining devices;
    ``devices=None`` every device of the group in an initialized process
    group (:func:`devices`, one card a rank), else every local card
    (:func:`local_devices`).  :class:`Device` entries build a mesh across
    processes (one controller outside a group), torch devices a mesh of one
    controller."""
    if devices is None:
        devices = _default_devices()
    devices = list(devices)
    n = len(devices)
    if data is None:
        if n % seq:
            raise ValueError(f"{n} devices not divisible by seq={seq}")
        data = n // seq
    if data * seq > n:
        raise ValueError(f"mesh {data}x{seq} exceeds {n} devices")
    return Mesh([devices[r * seq : (r + 1) * seq] for r in range(data)])


def default_mesh() -> Mesh:
    return make_mesh()


class ShardedTensor:
    """An array held by the devices of one mesh axis: the port's form of a
    sharded or replicated ``jax.Array``.

    ``shards`` are this process's, in mesh order, each on its own device,
    laid over ``axis`` (:meth:`Mesh.axis`): every shard on a mesh of one
    controller, the shards of ``axis.mine`` across processes.  Sharded (``replicated=False``): shard ``i`` is block
    ``i`` of the array along dim 0.  Replicated: every shard is the whole
    array (one tensor per distinct device, shared where a device repeats).
    ``np.asarray`` (or :meth:`numpy`) gives the whole array on the host;
    for a sharded array that spans other ranks' devices it raises
    ``RuntimeError``, as JAX does for an array that spans non-addressable
    devices (read this rank's ``shards``, or gather)."""

    def __init__(self, shards, *, axis: _Axis, replicated: bool = False):
        self.shards = tuple(shards)
        self.axis = axis
        self.replicated = replicated

    @property
    def devices(self) -> tuple[torch.device, ...]:
        return tuple(s.device for s in self.shards)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def _spans_ranks(self) -> bool:
        return not self.replicated and len(self.axis.mine) < len(self.axis.entries)

    @property
    def shape(self) -> tuple[int, ...]:
        first = self.shards[0]
        if self.replicated:
            return tuple(first.shape)
        return (len(self.axis.entries) * first.shape[0], *first.shape[1:])  # equal blocks

    def full(self) -> torch.Tensor:
        """The whole array on the first shard's device: a shard itself where
        one holds it, else the shards concatenated there.  Raises
        ``RuntimeError`` for a sharded array that spans other ranks."""
        if self._spans_ranks():
            raise RuntimeError(
                f"fetching the value of a sharded array that spans other ranks' devices is not possible: this "
                f"rank holds {len(self.axis.mine)} of its {len(self.axis.entries)} shards; gather it "
                f"(gather=True) or read this rank's .shards"
            )
        if self.replicated or len(self.shards) == 1:
            return self.shards[0]
        dev = self.shards[0].device
        return torch.cat([s.to(dev) for s in self.shards])

    def numpy(self) -> np.ndarray:
        return self.full().cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype, copy=False)

    def __repr__(self) -> str:
        kind = "replicated" if self.replicated else "sharded"
        return f"ShardedTensor({kind}, {self.dtype}{list(self.shape)}, on {[str(d) for d in self.devices]})"


def per_device(devices, make) -> list:
    """``make(device)`` once per distinct device, in mesh order (a repeated
    device shares its value)."""
    made: dict = {}
    return [made[d] if d in made else made.setdefault(d, make(d)) for d in devices]


def for_kernel(t: torch.Tensor) -> torch.Tensor:
    """``t`` where a kernel reads it in place (16-byte aligned), else an
    aligned copy: a shard cut from the middle of a batch or a stream may
    start anywhere."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def shard_rows(x, devices) -> list[torch.Tensor]:
    """Split dim 0 of ``x`` (a tensor, an array or a :class:`ShardedTensor`)
    into one equal block a position of the axis ``devices`` (a tuple of
    torch devices, or an :class:`_Axis`), and return this process's blocks,
    block ``i`` on its device: a view where ``x`` already lies there (copied
    only where a kernel could not read the view in place), a copy
    elsewhere.  A sharded input already laid out over the same axis is taken
    as it is.  Raises ``ValueError`` where the axis does not divide the
    rows."""
    axis = _layout(devices)
    if isinstance(x, ShardedTensor):
        if not x.replicated and x.axis == axis:
            return list(x.shards)
        x = x.full()
    elif not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    D, B = len(axis.entries), x.shape[0]
    if B % D:
        raise ValueError(f"batch of {B} rows does not divide over the data axis of size {D}")
    if len(set(axis.devices)) == 1:
        x = x.to(axis.devices[0])  # one copy of the whole batch, then views
    b = B // D
    return [for_kernel(x[i * b : (i + 1) * b].to(dev)) for i, dev in zip(axis.mine, axis.devices)]


def _backend_device(axis: _Axis) -> torch.device:
    """Where a collective's tensors lie: host memory under gloo, this rank's
    card under NCCL."""
    return torch.device("cpu") if torch.distributed.get_backend() == "gloo" else axis.devices[0]


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    if not t.numel():
        return torch.empty(0, dtype=torch.uint8, device=t.device)
    return t.contiguous().view(torch.uint8).reshape(-1)


def _gather_bytes(parts: list, sizes: list, axis: _Axis) -> list[torch.Tensor]:
    """Every rank's bytes (``sizes[r]`` on rank r; this rank's are
    ``parts``, u8, laid end to end) by one ``all_gather_into_tensor``, each
    rank's block padded to the largest (rounded up to 16 bytes).  Under
    gloo a rank on the card stages through pinned host memory (the caching
    host allocator keeps it for the next gather)."""
    dev, n = _backend_device(axis), 16 * -(-max(max(sizes), 1) // 16)  # each rank's block 16-byte aligned
    pinned = dev.type == "cpu" and axis.devices[0].type == "cuda"
    buf = torch.empty(n, dtype=torch.uint8, device=dev, pin_memory=pinned)
    at = 0
    for p in parts:
        buf[at : at + p.numel()].copy_(p)
        at += p.numel()
    out = torch.empty(n * len(sizes), dtype=torch.uint8, device=dev, pin_memory=pinned)
    torch.distributed.all_gather_into_tensor(out, buf)
    _COLLECTIVES[str(torch.distributed.get_backend())] += 1
    return [out[r * n : r * n + s] for r, s in enumerate(sizes)]


def _every_block(blocks: list, axis: _Axis, rows: list | None = None) -> list[torch.Tensor]:
    """Every position's block of an axis from this process's ``blocks`` (one
    for each of ``axis.mine``; one dtype and trailing shape): the blocks
    themselves on a mesh of one controller; across processes each position's
    block from its owner, by one all_gather over the group (after one small
    all_gather of the blocks' row counts where ``rows``, each position's
    dim-0 size, is not given).  The blocks come back where the collective
    left them (host memory under gloo)."""
    if axis.owner is None:
        return list(blocks)
    rank, world = _group()
    own = dict(zip(axis.mine, blocks))
    held = [[i for i, o in enumerate(axis.owner) if o == r] for r in range(world)]
    if rows is None:
        counts = torch.tensor([own[i].shape[0] for i in held[rank]], dtype=torch.int64)
        got = _gather_bytes([_as_bytes(counts)], [8 * len(h) for h in held], axis)
        rows = [0] * len(axis.entries)
        for h, part in zip(held, got):
            for i, c in zip(h, part.cpu().view(torch.int64).tolist()):
                rows[i] = c
    first = blocks[0]
    row_bytes = math.prod(first.shape[1:]) * first.element_size()
    got = _gather_bytes([_as_bytes(own[i]) for i in held[rank]],
                        [sum(rows[i] for i in h) * row_bytes for h in held], axis)
    out = [None] * len(axis.entries)
    for h, part in zip(held, got):
        at = 0
        for i in h:
            n = rows[i] * row_bytes
            out[i] = part[at : at + n].view(first.dtype).reshape(rows[i], *first.shape[1:])
            at += n
    return out


def _joined(blocks: list) -> torch.Tensor:
    """The blocks laid end to end along dim 0: a view of the buffer where
    they already lie so (one gather of equal blocks in rank order), else a
    concatenation."""
    first, at = blocks[0], blocks[0].data_ptr()
    for b in blocks:
        if not b.is_contiguous() or b.data_ptr() != at:
            return torch.cat(blocks)
        at += b.numel() * b.element_size()
    return first.as_strided((sum(b.shape[0] for b in blocks), *first.shape[1:]), first.stride(),
                            first.storage_offset())


def all_gather(shards, devices) -> ShardedTensor:
    """Every device of the axis (``devices``, as in :func:`shard_rows`) gets
    the whole array: the shards concatenated along dim 0.  A device that
    holds the only shard keeps it as it is."""
    axis = _layout(devices)
    if axis.owner is not None:
        whole = _joined(_every_block(shards, axis, [shards[0].shape[0]] * len(axis.entries)))
        return ShardedTensor(per_device(axis.devices, whole.to), replicated=True, axis=axis)

    def whole(dev):
        if len(shards) == 1 and shards[0].device == dev:
            return shards[0]
        return torch.cat([s.to(dev) for s in shards])

    return ShardedTensor(per_device(axis.devices, whole), replicated=True, axis=axis)


def psum(shards, devices) -> ShardedTensor:
    """Every device of the axis gets the sum of the shards."""
    axis = _layout(devices)
    if axis.owner is not None:
        rank, dev = _group()[0], _backend_device(axis)
        total = torch.zeros(shards[0].shape, dtype=shards[0].dtype, device=dev)
        for i, s in zip(axis.mine, shards):
            if axis.owner[i] == rank:
                total += s.to(dev)
        torch.distributed.all_reduce(total)
        _COLLECTIVES[str(torch.distributed.get_backend())] += 1
        return ShardedTensor(per_device(axis.devices, total.to), replicated=True, axis=axis)

    def total(dev):
        out = shards[0].to(dev)
        for s in shards[1:]:
            out = out + s.to(dev)
        return out

    return ShardedTensor(per_device(axis.devices, total), replicated=True, axis=axis)
