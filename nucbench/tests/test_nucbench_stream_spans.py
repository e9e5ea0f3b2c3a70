"""The readers of the program's own spans in the guide cell,
``stream_glue_us_per_call`` and ``readbacks_per_query``: they count only
spans that begin in the traced window (not those of a retried attempt or
of the untraced rest), and read nothing without spans, queries or the
recorder."""

import os
import sys
import time

import pytest

from cute_nucleotides_tpu_torch.utils import tracing
from nucbench import cells, harness
from nucbench.trace import Trace

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("stream_glue_us_per_call", "readbacks_per_query")
#: the guide cell cut to three chromosomes (six calls a guide), as the CPU runs cut it
SMALL = {"config": {"chromosomes": {"a": 5000, "b": 3001, "c": 1200}},
         "traffic": {"guide_pool": 12, "checked_guides": 3}}
STEPS = ("align.stream.peq", "align.stream.plan", "align.stream.launch", "align.stream.reduce")


def _reader(name):
    return cells.load_module(cells.reader_path(HERE, "metrics", name), f"t_{name}")


def _guide(at_s: float, call_us: float, readback_us: tuple, call_id0: int, calls: int = 48) -> list:
    """``calls`` planted ``best_match_stream`` calls from ``at_s`` on, in the
    recorder's form: each a top span of ``call_us``, four steps (a copy
    inside the launch) and two read-backs of ``readback_us``."""
    out = []
    t = int(at_s * 1e9)
    for c in range(calls):
        top = len(out)
        out.append(("align.stream", t, t + int(call_us * 1e3), -1, call_id0 + c, 1))
        for k, name in enumerate(STEPS):
            out.append((name, t + 1000 * k, t + 1000 * k + 500, top, call_id0 + c, 1))
        out.append(("align.stream.copy", t + 2100, t + 2200, top + 3, call_id0 + c, 1))
        at = t + 10_000
        for us in readback_us:
            out.append(("align.stream.readback", at, at + int(us * 1e3), top, call_id0 + c, 1))
            at += int(us * 1e3)
        t += int(call_us * 1e3) + 5000
    return out


def _two_attempts(monkeypatch, queries=1, window=(3.0, 4.0), bench=()) -> Trace:
    """Spans of a first traced attempt (slow calls, retried), of the kept
    window's one guide and of the untraced rest after it; the window is the
    second attempt's, ``bench`` the benchmark's own spans in it."""
    spans = _guide(1.0, 900.0, (100.0, 100.0), 0)
    spans += [(n, s, e, p + len(spans) if p >= 0 else -1, c, t) for n, s, e, p, c, t in
              _guide(3.0, 300.0, (50.0, 20.0), 100)]
    spans += [(n, s, e, p + len(spans) if p >= 0 else -1, c, t) for n, s, e, p, c, t in
              _guide(5.0, 600.0, (10.0, 10.0), 200)]
    monkeypatch.setattr(tracing, "spans", lambda: list(spans))
    return Trace([], window, list(bench), {}, {"queries": queries})


def test_readers_count_only_the_windows_spans(monkeypatch):
    t = _two_attempts(monkeypatch)
    assert _reader("readbacks_per_query").read(t) == pytest.approx(96.0)
    assert _reader("stream_glue_us_per_call").read(t) == pytest.approx(230.0)  # 300 less 50 and 20


def test_a_window_whose_end_lands_early_is_held_to_the_benchmarks_spans(monkeypatch):
    """The profile's clock can put the window's end before the host's: the
    guide's span, on the host's clock, still bounds the window."""
    guide = [("client.guide", 3.0, 3.0147), ("packed_ops.best_match_stream", 3.0146, 3.0147)]
    t = _two_attempts(monkeypatch, window=(3.0, 3.010), bench=guide)
    assert _reader("readbacks_per_query").read(t) == pytest.approx(96.0)
    assert _reader("stream_glue_us_per_call").read(t) == pytest.approx(230.0)
    short = _two_attempts(monkeypatch, window=(3.0, 3.010))
    assert _reader("readbacks_per_query").read(short) < 96.0  # without them the last calls fall out


@pytest.mark.parametrize("name", NAMES)
def test_readers_read_nothing_without_a_window_spans_queries_or_recorder(monkeypatch, name):
    assert _reader(name).read(_two_attempts(monkeypatch, queries=0)) is None
    assert _reader(name).read(_two_attempts(monkeypatch, window=(0.0, 0.0))) is None  # markers lost
    monkeypatch.setattr(tracing, "spans", lambda: [])
    assert _reader(name).read(Trace([], (3.0, 4.0), [], {}, {"queries": 1})) is None
    t = _two_attempts(monkeypatch)
    monkeypatch.setitem(sys.modules, "cute_nucleotides_tpu_torch.utils.tracing", None)  # a program without it
    monkeypatch.delattr(sys.modules["cute_nucleotides_tpu_torch.utils"], "tracing")
    assert _reader(name).read(t) is None


def test_a_cpu_guide_run_with_the_recorder_on_reports_both():
    """The small guide cell (3 chromosomes, so 6 calls a guide) traced on the
    CPU, where no profiler opens: with :func:`tracing.enable` the warm-up's
    spans lie before the window and are left out."""
    cell = cells.resolve("grch38-2bit.guide-search")
    harness._merge(SMALL, cell)
    tracing.clear()
    tracing.enable()
    try:
        r = harness.run(cell, 2**31 + 977, 0.6, True, t0=time.perf_counter(), device="cpu")
    finally:
        tracing.disable()
        tracing.clear()
    assert r["correct"] is True
    assert r["metrics"]["readbacks_per_query"]["value"] == 12.0
    assert r["metrics"]["readbacks_per_query"]["unit"] == "reads"
    assert r["metrics"]["stream_glue_us_per_call"]["value"] > 0
