"""Device meshes: a (data, seq) grid of torch devices, the arrays a mesh
axis holds, and the collectives over an axis.

The port's counterpart of ``cute_nucleotides_tpu/parallel/mesh.py``, with
its axis names, :func:`make_mesh` and :func:`default_mesh` and their
errors.  A codec has one meaningful parallel axis -- reads are independent
-- so the default mesh is 1-D over every local card, named ``"data"``; the
``"seq"`` axis shards one long sequence (:mod:`.longseq`).

One process drives every device of a :class:`Mesh` (a single controller):
it holds no process group, and its collectives are host-driven --
:func:`all_gather` concatenates, :func:`psum` adds, and the long-sequence
mode's ring halo is a slice of the successor's block.  Each is a
device-to-device copy only where two shards sit on different devices; on
one device it is a view or a slice.  A mesh may name one device more than
once: each entry is one logical shard, so 8 shards run on the CPU, or 4 on
one card.
"""

from __future__ import annotations

import numpy as np
import torch

DATA_AXIS = "data"
SEQ_AXIS = "seq"
AXES = (DATA_AXIS, SEQ_AXIS)


def local_devices() -> list[torch.device]:
    """Every local card, once each.  Raises ``RuntimeError`` without CUDA:
    the CPU runs only where the caller passes CPU devices."""
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


class Mesh:
    """A (data, seq) grid of devices.  ``shape[axis]`` is the axis size;
    :meth:`axis_devices` lists the devices along one axis (at index 0 of the
    other: the reference replicates over the other axis, which one
    controller need not compute twice)."""

    axis_names = AXES

    def __init__(self, devices):
        self.devices = tuple(tuple(_device(d) for d in row) for row in devices)
        if not self.devices or not self.devices[0] or len({len(r) for r in self.devices}) != 1:
            raise ValueError("a mesh is a non-empty (data, seq) grid of devices")
        self.shape = {DATA_AXIS: len(self.devices), SEQ_AXIS: len(self.devices[0])}

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[SEQ_AXIS]

    def axis_devices(self, axis: str) -> tuple[torch.device, ...]:
        if axis == DATA_AXIS:
            return tuple(row[0] for row in self.devices)
        if axis == SEQ_AXIS:
            return self.devices[0]
        raise ValueError(f"unknown mesh axis {axis!r}; expected one of {AXES}")

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[[str(d) for d in row] for row in self.devices]})"


def make_mesh(data: int | None = None, seq: int = 1, *, devices=None) -> Mesh:
    """Build a (data, seq) mesh.  ``data=None`` uses all remaining devices;
    ``devices=None`` every local card (:func:`local_devices`)."""
    if devices is None:
        devices = local_devices()
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

    ``shards`` are in mesh order, each on its own device.  Sharded
    (``replicated=False``): shard ``i`` is block ``i`` of the array along
    dim 0.  Replicated: every shard is the whole array (one tensor per
    distinct device, shared where a device repeats).  ``np.asarray`` (or
    :meth:`numpy`) gives the whole array on the host."""

    def __init__(self, shards, *, replicated: bool = False):
        self.shards = tuple(shards)
        self.replicated = replicated

    @property
    def devices(self) -> tuple[torch.device, ...]:
        return tuple(s.device for s in self.shards)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def shape(self) -> tuple[int, ...]:
        first = self.shards[0]
        if self.replicated:
            return tuple(first.shape)
        return (sum(s.shape[0] for s in self.shards), *first.shape[1:])

    def full(self) -> torch.Tensor:
        """The whole array on the first shard's device: a shard itself where
        one holds it, else the shards concatenated there."""
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
    into ``len(devices)`` equal blocks, block ``i`` on ``devices[i]``: a view
    where ``x`` already lies there (copied only where a kernel could not
    read the view in place), a copy elsewhere.  A sharded input already laid
    out over ``devices`` is taken as it is.  Raises ``ValueError`` where the
    axis does not divide the rows."""
    if isinstance(x, ShardedTensor):
        if not x.replicated and x.devices == tuple(devices):
            return list(x.shards)
        x = x.full()
    elif not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    D, B = len(devices), x.shape[0]
    if B % D:
        raise ValueError(f"batch of {B} rows does not divide over the data axis of size {D}")
    if len(set(devices)) == 1:
        x = x.to(devices[0])  # one copy of the whole batch, then views
    b = B // D
    return [for_kernel(x[i * b : (i + 1) * b].to(dev)) for i, dev in enumerate(devices)]


def all_gather(shards, devices) -> ShardedTensor:
    """Every device of the axis gets the whole array: the shards
    concatenated along dim 0.  A device that holds the only shard keeps it
    as it is."""

    def whole(dev):
        if len(shards) == 1 and shards[0].device == dev:
            return shards[0]
        return torch.cat([s.to(dev) for s in shards])

    return ShardedTensor(per_device(devices, whole), replicated=True)


def psum(shards, devices) -> ShardedTensor:
    """Every device of the axis gets the sum of the shards."""

    def total(dev):
        out = shards[0].to(dev)
        for s in shards[1:]:
            out = out + s.to(dev)
        return out

    return ShardedTensor(per_device(devices, total), replicated=True)
