"""Run one cell once: set-up, the measured window, the traced window where
asked, the check against the plain reference, and the result line.

``python -m nucbench --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` prints, as the last line of standard output, one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (and with
``--trace 1`` ``breakdown``), and last ``checks``: each number compared
beside its limit, which also end standard error.  Without CUDA, or with
fewer cards than the cell asks for, it prints no result and exits 2.

A cell on several cards runs one process a card: this process is rank 0 and
starts the others (hidden arguments ``--rank``, ``--world``,
``--rendezvous``); they meet through a file store in a fresh directory
under the temporary directory, and rank 0 prints for all of them.  Every
rank reads its own ``sys.modules`` once its window has closed: rank 0
prints no result where any rank loaded JAX, Flax or the JAX package.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import datetime
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

from . import cells
from .trace import Capture, Trace, warm_profiler

#: seconds of the window that run under the profiler in a traced run (the
#: rest runs as in an untraced one); long traces lose events
TRACE_SECONDS = 3.0
#: traced windows tried before a run gives up on the profile (it can come
#: back without device events)
TRACE_ATTEMPTS = 4
#: top-level module names that may not be loaded once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "cute_nucleotides_tpu")
#: seconds rank 0 waits for the other ranks to end
JOIN_TIMEOUT_S = 120


@dataclasses.dataclass
class Check:
    """One number compared with the plain reference, and its limit: the run
    is correct where every value is at most its limit."""

    name: str
    value: float
    limit: float


class Spans:
    """The benchmark's own host spans ``(name, start, end)`` around its
    calls into the program, kept while ``on`` (or where ``always``)."""

    def __init__(self):
        self.on = False
        self.items: list = []

    @contextlib.contextmanager
    def __call__(self, name: str, always: bool = False):
        if not (self.on or always):
            yield
            return
        t = time.perf_counter()
        try:
            yield
        finally:
            self.items.append((name, t, time.perf_counter()))


@dataclasses.dataclass
class Context:
    """What a driver gets: where it runs, its seed, its rank, and where it
    records spans and work."""

    device: object
    seed: int
    rank: int = 0
    world: int = 1
    control: bool = False
    spans: Spans = dataclasses.field(default_factory=Spans)
    #: work in the traced window, counted by the driver with the frozen models
    work: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    tracing: bool = False
    control_group: object = None

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def vote(self, stop: bool) -> bool:
        """Rank 0's decision, on every rank (one gloo all-reduce of a host
        tensor; the card is not synchronized)."""
        return self.any(stop and self.rank == 0)

    def any(self, flag: bool) -> bool:
        """True on every rank where it is true on some rank."""
        if self.world == 1:
            return bool(flag)
        import torch

        t = torch.tensor([int(flag)], dtype=torch.int32)
        torch.distributed.all_reduce(t, group=self.control_group, op=torch.distributed.ReduceOp.MAX)
        return bool(t.item())

    def barrier(self) -> None:
        if self.world > 1:
            import torch

            torch.distributed.barrier(group=self.control_group)

    def gather(self, obj) -> list:
        if self.world == 1:
            return [obj]
        import torch

        out = [None] * self.world
        torch.distributed.all_gather_object(out, obj, group=self.control_group)
        return out


def _launches() -> dict:
    from cute_nucleotides_tpu_torch.ops import kernels

    return {f"launches.{fn.__name__}": fn.launches for fn in kernels.WRAPPERS}


def _collectives() -> dict:
    from cute_nucleotides_tpu_torch.parallel import mesh

    return {f"collectives.{k}": v for k, v in mesh._COLLECTIVES.items()}


def _counts() -> dict:
    return {**_launches(), **_collectives()}


def _delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if v - before.get(k, 0)}


def _merge(overrides: dict | None, cell: cells.Cell) -> None:
    for key in ("config", "traffic"):
        getattr(cell, key).update((overrides or {}).get(key, {}))


def _start_ranks(args, cell: cells.Cell, rendezvous: str, device: str) -> list:
    env = dict(os.environ)
    procs = []
    for r in range(1, cell.chips):
        cmd = [sys.executable, "-m", "nucbench", "--workload", cell.name, "--seed", str(args.seed), "--seconds",
               str(args.seconds), "--trace", str(args.trace), "--rank", str(r), "--world", str(cell.chips),
               "--rendezvous", rendezvous, "--device", device, "--control", str(int(args.control))]
        if args.overrides:
            cmd += ["--overrides", args.overrides]
        procs.append(subprocess.Popen(cmd, cwd=cells.ROOT, env=dict(env, LOCAL_RANK=str(r)),
                                      stdout=subprocess.DEVNULL))
    return procs


def _join(procs: list) -> list[int]:
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=max(1.0, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            p.kill()
            codes.append(p.wait())
    return codes


def _init_group(ctx: Context, rendezvous: str) -> None:
    import torch

    if ctx.device.type == "cuda":
        torch.cuda.set_device(ctx.device)
    torch.distributed.init_process_group(
        "nccl" if ctx.device.type == "cuda" else "gloo", init_method=f"file://{rendezvous}/store",
        world_size=ctx.world, rank=ctx.rank, timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S))
    ctx.control_group = torch.distributed.new_group(backend="gloo")


def _rank_result(ctx: Context, cell: cells.Cell, trace: Trace | None, checks: list, peak: int) -> dict:
    layer = {}
    if trace is not None:
        for name, _, reader in cell.per_layer:
            v = reader.read(trace)
            if v is not None:
                layer[name] = float(v)
    out = {"checks": [(c.name, c.value, c.limit) for c in checks], "layer": layer, "peak": peak,
           "forbidden": forbidden_loaded()}
    if trace is not None:
        out["busy_s"] = trace.busy_s()
        out["window_s"] = trace.window_s
        out["breakdown"] = trace.breakdown()
    return out


def run(cell: cells.Cell, seed: int, seconds: float, trace: bool, *, t0: float, device: str = "cuda", rank: int = 0,
        world: int = 1, rendezvous: str | None = None, control: bool = False) -> dict | None:
    """One run of ``cell``; rank 0 returns the result line as a dict, the
    other ranks None.  ``device`` is "cuda" on the card; the CPU runs only
    where a test asks for it (the kernels' plain versions)."""
    import torch

    dev = torch.device("cuda", rank) if device == "cuda" else torch.device("cpu")
    ctx = Context(dev, seed, rank, world, control)
    if world > 1:
        _init_group(ctx, rendezvous)
    driver = cell.driver
    state = driver.setup(ctx, cell.config, cell.traffic)
    ctx.sync()
    ctx.barrier()
    setup_s = time.perf_counter() - t0

    tr = None
    if trace:
        if hasattr(driver, "probe"):
            driver.probe(ctx, state)
        warm_profiler(dev)
        traced = min(seconds, TRACE_SECONDS)
        kept = collections.Counter(ctx.work), list(ctx.spans.items)
        for attempt in range(TRACE_ATTEMPTS):
            ctx.work, ctx.spans.items = collections.Counter(kept[0]), list(kept[1])
            before = _counts()
            ctx.tracing = ctx.spans.on = True
            with Capture(dev) as cap:
                driver.measure(ctx, state, traced)
            ctx.tracing = ctx.spans.on = False
            empty = dev.type == "cuda" and not cap.events
            if empty:
                print(f"nucbench: rank {rank}: traced window {attempt + 1} came back empty (device events, markers: "
                      f"{cap.seen})", file=sys.stderr)
            if not ctx.any(empty):
                break
        tr = Trace(cap.events, cap.window, ctx.spans.items, _delta(_counts(), before), dict(ctx.work))
        if seconds > traced:
            driver.measure(ctx, state, seconds - traced)
    else:
        driver.measure(ctx, state, seconds)
    ctx.sync()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    summary = dict(driver.summary(ctx, state), setup_s=setup_s)
    checks = driver.check(ctx, state)
    del state
    parts = ctx.gather(_rank_result(ctx, cell, tr, checks, peak))
    if world > 1:
        torch.distributed.destroy_process_group()
    if rank:
        return None
    return _result(cell, dev, summary, parts, trace)


def _result(cell: cells.Cell, dev, summary: dict, parts: list, trace: bool) -> dict:
    import torch

    checks: dict[str, list] = {}
    for part in parts:
        for name, value, limit in part["checks"]:
            slot = checks.setdefault(name, [0, limit])
            slot[0] += value
    correct = all(v <= lim for v, lim in checks.values())
    metrics = {}
    if trace:  # the per-layer metrics, each the mean over the ranks that read it
        for name, unit, _ in cell.per_layer:
            got = [p["layer"][name] for p in parts if name in p["layer"]]
            if got:
                metrics[name] = {"value": sum(got) / len(got), "unit": unit}
    else:
        for name, unit, reader in cell.end_to_end:
            v = reader.read(summary)
            if v is not None:
                metrics[name] = {"value": float(v), "unit": unit}
    device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": len(parts), "memory_peak_bytes": max(p["peak"] for p in parts)}
    out = {"correct": correct, "attempted": int(summary["attempted"]), "failed": int(summary.get("failed", 0)),
           "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = sum(p["busy_s"] for p in parts) / len(parts)
        device["window_s"] = sum(p["window_s"] for p in parts) / len(parts)
        out["breakdown"] = parts[0]["breakdown"]
    if summary.get("pace"):
        out["pace"] = summary["pace"]
    out["forbidden"] = sorted({m for p in parts for m in p["forbidden"]})  # popped before printing
    out["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in checks.items()}
    return out


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: the port's name begins with the latter)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _refuse(loaded: list[str], who: str) -> bool:
    """Name the forbidden modules ``who`` loaded, on standard error."""
    if loaded:
        print(f"nucbench: forbidden modules loaded in {who}'s process: {loaded}", file=sys.stderr)
    return bool(loaded)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m nucbench", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0, help=argparse.SUPPRESS)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument("--rendezvous", help=argparse.SUPPRESS)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"), help=argparse.SUPPRESS)
    p.add_argument("--overrides", help=argparse.SUPPRESS)
    return p


def main(argv: list[str], t0: float) -> int:
    args = _parser().parse_args(argv)
    cell = cells.resolve(args.workload)
    _merge(json.loads(args.overrides) if args.overrides else None, cell)
    if args.rank:  # a rank that rank 0 started; it prints nothing on stdout
        run(cell, args.seed, args.seconds, bool(args.trace), t0=t0, device=args.device, rank=args.rank,
            world=args.world, rendezvous=args.rendezvous, control=bool(args.control))
        return 3 if _refuse(forbidden_loaded(), f"rank {args.rank}") else 0
    import torch

    if args.device == "cuda" and (not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"nucbench: {cell.name} needs {cell.chips} CUDA device(s); {have} available", file=sys.stderr)
        return 2
    return run_main(args, cell, t0)


def run_main(args, cell: cells.Cell, t0: float) -> int:
    """Rank 0: start the other ranks where the cell has several cards, run,
    check the loaded modules, print."""
    rendezvous, procs = None, []
    if cell.chips > 1:
        if args.device == "cuda":
            from cute_nucleotides_tpu_torch.ops import _build

            _build.load()  # one build for all ranks, before they start
        rendezvous = tempfile.mkdtemp(prefix="nucbench-")
        procs = _start_ranks(args, cell, rendezvous, args.device)
    try:
        result = run(cell, args.seed, args.seconds, bool(args.trace), t0=t0, device=args.device,
                     world=cell.chips, rendezvous=rendezvous, control=bool(args.control))
    finally:
        codes = _join(procs)
        if rendezvous:
            shutil.rmtree(rendezvous, ignore_errors=True)
    if _refuse(sorted(set(result.pop("forbidden")) | set(forbidden_loaded())), "a rank"):
        return 3
    if any(codes):
        print(f"nucbench: a rank failed (exit codes {codes})", file=sys.stderr)
        return 1
    if result.get("pace"):
        print(f"nucbench: steps dispatched a second: {result.pop('pace')}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
