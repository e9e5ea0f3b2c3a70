"""What a traced window saw: device events on the host's clock, the
benchmark's own host spans, the program's counters and the work the cell
did.  Per-layer metric readers (``nucbench/metrics/<name>.py``) read a
:class:`Trace`; the reductions here are plain functions of intervals.

The device events come from ``torch.profiler`` with CUDA activity only, read
as raw kineto events (``key_averages()`` would build a Python object per
event).  Their clock is the profiler's; two marker kernels, launched right
after a synchronize at the window's start and end, tie it to the host's
``perf_counter``: the window is the span between the markers, and every
event is moved by the first marker's offset.
"""

from __future__ import annotations

import dataclasses
import time

#: the marker kernel (``torch.cuda._sleep``), left out of every reduction
MARKER = "spin_kernel"
#: entries of each breakdown list
TOP = 10


def merge(intervals) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` intervals as disjoint sorted ones."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def busy(intervals, lo: float, hi: float) -> float:
    """Seconds within ``[lo, hi]`` covered by at least one interval: work
    that overlaps (a copy beside a kernel) counts once."""
    return sum(e - s for s, e in merge(clip(intervals, lo, hi)))


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The idle stretches of ``[lo, hi]``: where no interval runs."""
    out, at = [], lo
    for s, e in merge(clip(intervals, lo, hi)):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


def innermost(spans, times) -> list[str]:
    """For each of ``times``, the name of the innermost span that holds it
    (``start <= t < end``), or ``"outside any span"``; in one sweep: spans
    from one thread nest or are disjoint, so the innermost open span is the
    one opened last."""
    marks = [(s, 1, i) for i, (_, s, _) in enumerate(spans)] + [(e, 0, i) for i, (_, _, e) in enumerate(spans)]
    marks += [(t, 2, j) for j, t in enumerate(times)]
    out = ["outside any span"] * len(times)
    open_: list[int] = []
    for _, kind, i in sorted(marks):  # at one time: ends, then starts, then queries
        if kind == 1:
            open_.append(i)
        elif kind == 0:
            open_.remove(i)
        elif open_:
            out[i] = spans[open_[-1]][0]
    return out


def top_ops(events) -> list[list]:
    """The device operations that took the most time: ``[[name,
    seconds], ...]``, summed by name."""
    total: dict[str, float] = {}
    for name, s, e in events:
        total[name] = total.get(name, 0.0) + (e - s)
    return [[n, t] for n, t in sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]


def named_gaps(idle, spans) -> list[list]:
    """Idle device time summed by what the host was doing when each gap
    began (the innermost benchmark span), largest first: ``[["<span> (n
    gaps)", seconds], ...]``."""
    total: dict[str, list] = {}
    for (s, e), name in zip(idle, innermost(spans, [s for s, _ in idle])):
        slot = total.setdefault(name, [0.0, 0])
        slot[0] += e - s
        slot[1] += 1
    ranked = sorted(total.items(), key=lambda kv: -kv[1][0])[:TOP]
    return [[f"{name} ({n} gaps)", t] for name, (t, n) in ranked]


@dataclasses.dataclass
class Trace:
    """One rank's traced window.  ``events`` are device operations as
    ``(name, start, end)`` in host ``perf_counter`` seconds, ``window`` the
    traced span, ``spans`` the benchmark's host spans ``(name, start,
    end)``, ``counters`` the program's counts over the window (kernel
    launches by wrapper, collectives) and ``work`` what the cell's driver
    counted there with the frozen models (bounds, floors, queries, bytes)."""

    events: list
    window: tuple[float, float]
    spans: list
    counters: dict
    work: dict

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def matching(self, *tags: str) -> list:
        """The events whose name holds one of ``tags`` (all, given none)."""
        if not tags:
            return list(self.events)
        return [ev for ev in self.events if any(t in ev[0] for t in tags)]

    def busy_s(self, *tags: str) -> float:
        """Device-busy seconds of the window, of the events whose name holds
        one of ``tags`` where given."""
        return busy([(s, e) for _, s, e in self.matching(*tags)], *self.window)

    def kernel_s(self, *tags: str) -> float:
        """Summed durations of the matching events (one stream: the same as
        their union)."""
        return sum(e - s for _, s, e in self.matching(*tags))

    def complete(self, tags: tuple, wrappers: tuple) -> bool:
        """True where the profile saw at least as many matching kernels as
        the wrappers launched in the window (the profiler can lose events)."""
        launched = sum(self.counters.get(f"launches.{w}", 0) for w in wrappers)
        return launched > 0 and len(self.matching(*tags)) >= launched

    def breakdown(self) -> dict:
        return {"device_ops": top_ops(self.events),
                "idle_gaps": named_gaps(gaps([(s, e) for _, s, e in self.events], *self.window), self.spans)}


class Capture:
    """``with Capture(device) as cap:`` profiles the device over the block;
    afterwards ``cap.events`` and ``cap.window`` are set (host seconds), and
    ``cap.seen`` counts the device events and markers the profiler gave.  On
    the CPU it only times the block."""

    def __init__(self, device):
        self.device = device
        self.events: list = []
        self.window = (0.0, 0.0)
        self.seen = (0, 0)

    def _marker(self) -> int:
        import torch

        torch.cuda.synchronize(self.device)
        t = time.perf_counter_ns()
        torch.cuda._sleep(1000)
        return t

    def __enter__(self):
        if self.device.type != "cuda":
            self._host = [time.perf_counter_ns()]
            return self
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._host = [self._marker()]
        return self

    def __exit__(self, *exc):
        if self.device.type != "cuda":
            self.window = (self._host[0] / 1e9, time.perf_counter_ns() / 1e9)
            return False
        import torch
        from torch.autograd import DeviceType

        self._host.append(self._marker())
        torch.cuda.synchronize(self.device)
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        raw, marks = [], []
        for ev in self._prof.profiler.kineto_results.events():
            if ev.device_type() != DeviceType.CUDA:
                continue
            s = ev.start_ns()
            item = (ev.name(), s, s + ev.duration_ns())
            (marks if MARKER in item[0] else raw).append(item)
        self.seen = (len(raw), len(marks))
        marks.sort(key=lambda m: m[1])
        if len(marks) < 2:  # no device clock to tie to: the window stays empty
            return False
        offset = marks[0][1] - self._host[0]
        self.window = ((marks[0][1] - offset) / 1e9, (marks[-1][2] - offset) / 1e9)
        self.events = [(n[:96], (s - offset) / 1e9, (e - offset) / 1e9) for n, s, e in raw]
        return False


def warm_profiler(device) -> None:
    """One tiny profiled session, so that the profiler's start-up (seconds,
    on the first session of a process) stays out of the traced window."""
    if device.type != "cuda":
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.cuda._sleep(1000)
        torch.cuda.synchronize(device)
