"""The reader of the parallel layer's spans in the gather cell,
``dp_host_us_per_step``: it counts only ``dp.encode`` spans that begin in
the traced window, takes the row-count gathers out of them, reads nothing
from a program without the spans, and reads above 0 from a traced run of
the cell on four gloo ranks."""

import json
import os
import subprocess
import sys

import pytest

from cute_nucleotides_tpu_torch.utils import tracing
from nucbench import cells
from nucbench.trace import Trace

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
GATHER = "reads150-b5-dp4.gather"
SMALL = {"traffic": {"reads_a_batch": 256}}
SEED = 2**31 + 2311


def _reader():
    return cells.load_module(cells.reader_path(HERE, "metrics", "dp_host_us_per_step"), "t_dp_host_us_per_step")


def _steps(at_s: float, step_us: float, rows_us: float, steps: int = 8) -> list:
    """``steps`` planted ``data_parallel_encode`` calls from ``at_s`` on, in
    the recorder's form: the call, its codec step, the gather with its
    staging, collective and (``rows_us`` > 0) row-count gather."""
    out = []
    t = int(at_s * 1e9)
    for c in range(steps):
        top = len(out)
        out.append(("dp.encode", t, t + int(step_us * 1e3), -1, c, 1))
        out.append(("dp.encode.codec", t + 1000, t + 5000, top, c, 1))
        out.append(("mesh.all_gather", t + 6000, t + int(step_us * 1e3) - 1000, top, c, 1))
        at = t + 7000
        if rows_us:
            out.append(("mesh.all_gather.rows", at, at + int(rows_us * 1e3), top + 2, c, 1))
            out.append(("mesh.all_gather.collective", at + 100, at + 200, top + 3, c, 1))
            at += int(rows_us * 1e3)
        out.append(("mesh.all_gather.stage", at, at + 500, top + 2, c, 1))
        out.append(("mesh.all_gather.collective", at + 600, at + 900, top + 2, c, 1))
        t += int(step_us * 1e3) + 4000
    return out


def _shifted(spans: list, by: int) -> list:
    return [(n, s, e, p + by if p >= 0 else -1, c, t) for n, s, e, p, c, t in spans]


def _trace(monkeypatch, window=(3.0, 4.0), bench=()) -> Trace:
    """Steps before the window (a retried attempt), in it and after it (the
    untraced rest)."""
    spans = _steps(1.0, 900.0, 0.0)
    spans += _shifted(_steps(3.0, 150.0, 40.0), len(spans))
    spans += _shifted(_steps(5.0, 600.0, 0.0), len(spans))
    monkeypatch.setattr(tracing, "spans", lambda: list(spans))
    return Trace([], window, list(bench), {}, {})


def test_reader_counts_the_windows_steps_less_their_row_gathers(monkeypatch):
    assert _reader().read(_trace(monkeypatch)) == pytest.approx(110.0)  # 150 less 40


def test_a_window_whose_end_lands_early_is_held_to_the_benchmarks_spans(monkeypatch):
    steps = [("parallel.data_parallel_encode", 3.0, 3.0012)]
    assert _reader().read(_trace(monkeypatch, window=(3.0, 3.0005), bench=steps)) == pytest.approx(110.0)


def test_reader_reads_nothing_without_a_window_spans_or_recorder(monkeypatch):
    r = _reader()
    assert r.read(_trace(monkeypatch, window=(0.0, 0.0))) is None  # markers lost
    t = _trace(monkeypatch, window=(7.0, 8.0))
    assert r.read(t) is None  # no step began in the window
    monkeypatch.setattr(tracing, "spans", lambda: [("align.stream", 3_100_000_000, 3_200_000_000, -1, 0, 1)])
    assert r.read(Trace([], (3.0, 4.0), [], {}, {})) is None  # a program whose parallel layer records none
    t = _trace(monkeypatch)
    monkeypatch.setitem(sys.modules, "cute_nucleotides_tpu_torch.utils.tracing", None)  # a program without it
    monkeypatch.delattr(sys.modules["cute_nucleotides_tpu_torch.utils"], "tracing")
    assert r.read(t) is None


#: each rank's interpreter records the port's spans with no profiler open (the CPU has none)
RECORD = "from cute_nucleotides_tpu_torch.utils import tracing\ntracing.enable()\n"
#: as RECORD, in a program whose parallel layer records no span (the parent of this cell)
SILENT = RECORD + "tracing.span = lambda name: tracing._OFF\n"


def _traced_gather(tmp_path, site: str) -> dict:
    (tmp_path / "sitecustomize.py").write_text(site)
    env = {k: v for k, v in os.environ.items() if k not in ("LOCAL_RANK", "RANK", "WORLD_SIZE")}
    env.update(CUDA_VISIBLE_DEVICES="", PYTHONPATH=os.pathsep.join([str(tmp_path), ROOT]))
    cmd = [sys.executable, "-m", "nucbench", "--workload", GATHER, "--seed", str(SEED), "--seconds", "1", "--trace",
           "1", "--device", "cpu", "--overrides", json.dumps(SMALL)]
    p = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("site", ["record", "silent"])
def test_a_traced_gather_run_on_four_gloo_ranks(tmp_path, site):
    r = _traced_gather(tmp_path, RECORD if site == "record" else SILENT)
    assert r["correct"] is True and r["device"]["count"] == 4 and r["device"]["window_s"] > 0
    if site == "record":
        assert r["metrics"]["dp_host_us_per_step"]["value"] > 0
        assert r["metrics"]["dp_host_us_per_step"]["unit"] == "us"
    else:
        assert "dp_host_us_per_step" not in r["metrics"]
