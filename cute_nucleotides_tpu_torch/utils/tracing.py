"""The port's span recorder: named host intervals on
``time.perf_counter_ns()``, kept in this process's memory.

``with tracing.span("align.stream"):`` records ``(name, start_ns, end_ns,
parent, call_id, thread)``.  ``parent`` is the index in :func:`spans` of
the span that was open on the same thread when this one began, or -1;
``call_id`` is shared by a top-level span and every span recorded inside
it, so the steps of one call can be grouped.

It records only while a ``torch.profiler`` session is open, or between
:func:`enable` and :func:`disable`.  Otherwise :func:`span` returns one
shared no-op context manager and allocates nothing.  It puts nothing into
the profiler's stream (no ``record_function`` or NVTX range, no device op,
no synchronize), so a profile holds the same device events with it as
without; its clock is the one a profile's device events are moved onto
where they are tied to the host (``nucbench/trace.py``).  Kept spans live
in flat integer arrays, so recording leaves no object behind for the
garbage collector to walk.

At most :data:`CAPACITY` spans are kept; past it the oldest stay and
:func:`dropped` counts the rest.
"""

from __future__ import annotations

import itertools
import threading
import time
from array import array

from torch.autograd import profiler as _profiler

__all__ = ["span", "enable", "disable", "spans", "clear", "dropped", "CAPACITY"]

#: spans kept until :func:`clear`
CAPACITY = 1 << 20

_enabled = False
_dropped = 0
#: the kept spans, one entry each, in the order they began; ``_end`` is -1
#: while a span is open.  :func:`clear` puts new ones in their place, so a
#: span open across it ends in the arrays it began in
_names: list[str] = []
_start, _end, _parent, _call, _thread = array("q"), array("q"), array("q"), array("q"), array("Q")
_lock = threading.Lock()
_calls = itertools.count()
#: ``stack``: per thread, ``(index or -1, its _end array, call_id)`` of each open span
_local = threading.local()


class _Off:
    """The shared context manager of :func:`span` while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("_name", "_at")

    def __init__(self, name: str):
        self._name = name

    def __enter__(self):
        global _dropped
        try:
            stack = _local.stack
        except AttributeError:
            stack = _local.stack = []
        top = stack[-1] if stack else None
        call = top[2] if top else next(_calls)
        with _lock:
            end, i = _end, len(_names)
            if i < CAPACITY:
                _names.append(self._name)
                _parent.append(top[0] if top and top[1] is end else -1)
                _call.append(call)
                _thread.append(threading.get_ident())
                end.append(-1)
                _start.append(time.perf_counter_ns())
            else:
                _dropped += 1
                i = -1
        self._at = (i, end, call)
        stack.append(self._at)
        return None

    def __exit__(self, exc_type, exc, tb):
        t = time.perf_counter_ns()
        _local.stack.pop()
        i, end, _ = self._at
        if i >= 0:
            end[i] = t  # one item of an array that only grows: no lock needed
        return False


def span(name: str):
    """A context manager that records the block as the span ``name`` while
    recording is on, and does nothing otherwise."""
    if _enabled or _profiler._is_profiler_enabled:
        return _Span(name)
    return _OFF


def enable() -> None:
    """Record spans with no profiler open, until :func:`disable`."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def spans() -> list[tuple]:
    """The kept spans, in the order they began: ``(name, start_ns, end_ns,
    parent, call_id, thread)``, ``parent`` an index into this list or -1
    (also where the parent was dropped or cleared)."""
    with _lock:
        return list(zip(_names, _start, _end, _parent, _call, _thread))


def clear() -> None:
    """Forget the kept spans and the dropped count."""
    global _dropped, _names, _start, _end, _parent, _call, _thread
    with _lock:
        _names = []
        _start, _end, _parent, _call, _thread = array("q"), array("q"), array("q"), array("q"), array("Q")
        _dropped = 0


def dropped() -> int:
    """Spans not kept since the last :func:`clear`, the buffer being full."""
    return _dropped
