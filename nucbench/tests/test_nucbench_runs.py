"""Whole runs on the CPU at small sizes (the kernels' plain versions): the
result line, sound runs, the control, and the faults a cell can have
planted underneath its timed path, each of which must read not correct."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from nucbench import cells, harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SMALL = {
    "reads150-b5.codec": {"traffic": {"reads_a_batch": 512}},
    "reads150-b5.adapter-scan": {"traffic": {"reads_a_batch": 512}},
    "grch38-2bit.guide-search": {"config": {"chromosomes": {"a": 5000, "b": 3001, "c": 1200}},
                                 "traffic": {"guide_pool": 12, "checked_guides": 3}},
    "reads150-b5-dp4.gather": {"traffic": {"reads_a_batch": 256}},
}
ONE_CARD = [c for c in SMALL if c != "reads150-b5-dp4.gather"]
SEED = 2**31 + 977


def _run(name, trace=False, control=False, seconds=0.6):
    cell = cells.resolve(name)
    harness._merge(SMALL[name], cell)
    return harness.run(cell, SEED, seconds, trace, t0=time.perf_counter(), device="cpu", control=control)


@pytest.mark.parametrize("name", ONE_CARD)
def test_sound_runs_are_correct_and_print_the_contracts_keys(name):
    r = _run(name)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["attempted"] > 0 and r["failed"] == 0
    assert all(c["value"] <= c["limit"] == 0 for c in r["checks"].values())
    assert "setup_s" in r["metrics"] and len(r["metrics"]) >= 2
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.mark.parametrize("name", ONE_CARD)
def test_traced_runs_carry_the_trace_keys(name):
    r = _run(name, trace=True)
    assert r["correct"] is True
    assert {"busy_s", "window_s"} <= set(r["device"]) and set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "setup_s" not in r["metrics"]  # a traced run reports the per-layer metrics alone


@pytest.mark.parametrize("name", ONE_CARD)
def test_the_control_is_not_correct(name):
    r = _run(name, control=True)
    assert r["correct"] is False
    assert max(c["value"] for c in r["checks"].values()) > 0


def _stale(fn):
    """A step that returns its state unchanged: its first answer, forever."""
    first = []

    def wrapped(*a, **k):
        if not first:
            first.append(fn(*a, **k))
        return first[0]

    return wrapped


def _flip(t: torch.Tensor) -> torch.Tensor:
    t = t.clone()
    t.view(-1)[t.numel() // 2] += 1
    return t


def _faults_codec(monkeypatch, kind):
    from cute_nucleotides_tpu_torch.models import Base5Codec

    enc, dec = Base5Codec.encode_checked, Base5Codec.decode_checked
    if kind == "stale":
        monkeypatch.setattr(Base5Codec, "encode_checked", _stale(enc))
    elif kind == "half":
        def half(self, x):
            w, f = enc(self, x[: x.shape[0] // 2])
            return torch.cat([w, torch.zeros_like(w)]), f
        monkeypatch.setattr(Base5Codec, "encode_checked", half)
    elif kind == "altered":
        monkeypatch.setattr(Base5Codec, "decode_checked", lambda self, w: (_flip(dec(self, w)[0]), dec(self, w)[1]))


def _faults_adapter(monkeypatch, kind):
    from cute_nucleotides_tpu_torch.ops import align

    fn = align.best_match_packed_b5
    if kind == "stale":
        monkeypatch.setattr(align, "best_match_packed_b5", _stale(fn))
    elif kind == "half":
        def half(q, ql, t, tl):
            n = t.shape[0] // 2
            d, e = fn(q[:n], ql[:n], t[:n], tl[:n])
            return torch.cat([d, torch.zeros_like(d)]), torch.cat([e, torch.zeros_like(e)])
        monkeypatch.setattr(align, "best_match_packed_b5", half)
    elif kind == "altered":
        monkeypatch.setattr(align, "best_match_packed_b5", lambda *a: (_flip(fn(*a)[0]), fn(*a)[1]))


def _faults_guide(monkeypatch, kind):
    from cute_nucleotides_tpu_torch.ops import align

    fn = align.best_match_stream
    if kind == "stale":
        monkeypatch.setattr(align, "best_match_stream", _stale(fn))
    elif kind == "half":
        monkeypatch.setattr(align, "best_match_stream", lambda w, n, q: fn(w, n // 2, q))
    elif kind == "altered":
        monkeypatch.setattr(align, "best_match_stream", lambda w, n, q: (fn(w, n, q)[0] + 1, fn(w, n, q)[1]))


FAULTS = {"reads150-b5.codec": _faults_codec, "reads150-b5.adapter-scan": _faults_adapter,
          "grch38-2bit.guide-search": _faults_guide}


@pytest.mark.parametrize("kind", ["stale", "half", "altered"])
@pytest.mark.parametrize("name", ONE_CARD)
def test_a_fault_underneath_the_timed_path_is_not_correct(monkeypatch, name, kind):
    FAULTS[name](monkeypatch, kind)
    assert _run(name)["correct"] is False


# --- a four-rank cell: four gloo processes on the CPU --------------------------
# BENCHMARK.json holds no four-card cell; the data-parallel gather's files are
# there for one, and these tests add it as entries in a copy of the checkout.

GATHER = "reads150-b5-dp4.gather"
GATHER_ENTRIES = {
    "config": {"name": "reads150-b5-dp4", "source": "https://www.nvidia.com/en-us/data-center/hgx/",
               "file": "nucbench/configs/reads150-b5-dp4.json", "reduced": ["reads_held"], "why": "a test"},
    "workload": {"name": GATHER, "config": "reads150-b5-dp4", "traffic": "gather", "chips": 4, "why": "a test"},
}

GATHER_FAULTS = {
    "stale": "dp.data_parallel_encode = stale(dp.data_parallel_encode)",
    "half": ("_enc = dp.data_parallel_encode\n"
             "def half(x, **k):\n"
             "    s = x.shards[0]\n"
             "    s[s.shape[0] // 2:] = 65\n"
             "    return _enc(x, **k)\n"
             "dp.data_parallel_encode = half"),
    "exchange": ("_ag = mesh.all_gather\n"
                 "def local(shards, devices):\n"
                 "    return mesh.ShardedTensor([torch.cat([shards[0]] * len(devices.entries))], replicated=True,"
                 " axis=devices)\n"
                 "mesh.all_gather = local"),
    "altered": ("_enc = dp.data_parallel_encode\n"
                "def altered(x, **k):\n"
                "    out = _enc(x, **k)\n"
                "    out.shards[0].view(torch.int32).view(-1)[7] += 1\n"
                "    return out\n"
                "dp.data_parallel_encode = altered"),
}
PATCH = """
import torch
from cute_nucleotides_tpu_torch.parallel import data_parallel as dp, mesh


def stale(fn):
    first = []
    def wrapped(*a, **k):
        if not first:
            first.append(fn(*a, **k))
        return first[0]
    return wrapped


{fault}
"""


def _with_gather(tmp_path):
    """A copy of the benchmark with the four-rank gather cell added."""
    import shutil

    root = tmp_path / "checkout"
    if root.exists():
        return root
    shutil.copytree(os.path.join(ROOT, "nucbench"), root / "nucbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    bench["configs"].append(GATHER_ENTRIES["config"])
    bench["workloads"].append(GATHER_ENTRIES["workload"])
    for m in bench["end_to_end"]:
        if m["name"] == "nt_rate":
            m["workloads"].append(GATHER)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _gather_run(tmp_path, site=None, control=False):
    root = _with_gather(tmp_path)
    path = [str(root), ROOT]
    if site:
        (tmp_path / "site").mkdir(exist_ok=True)
        (tmp_path / "site" / "sitecustomize.py").write_text(site)
        path.insert(0, str(tmp_path / "site"))
    env = {k: v for k, v in os.environ.items() if k not in ("LOCAL_RANK", "RANK", "WORLD_SIZE")}
    env.update(CUDA_VISIBLE_DEVICES="", PYTHONPATH=os.pathsep.join(path))
    cmd = [sys.executable, "-m", "nucbench", "--workload", GATHER, "--seed", str(SEED), "--seconds", "1", "--trace",
           "0", "--device", "cpu", "--control", str(int(control)), "--overrides", json.dumps(SMALL[GATHER])]
    return subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True, timeout=240)


def _gather(tmp_path, fault=None, control=False):
    p = _gather_run(tmp_path, PATCH.format(fault=GATHER_FAULTS[fault]) if fault else None, control)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_gather_across_four_gloo_ranks(tmp_path):
    r = _gather(tmp_path)
    assert r["correct"] is True and r["device"]["count"] == 4 and r["attempted"] > 0
    assert _gather(tmp_path, control=True)["correct"] is False


@pytest.mark.parametrize("fault", sorted(GATHER_FAULTS))
def test_a_fault_in_the_gather_is_not_correct(tmp_path, fault):
    assert _gather(tmp_path, fault)["correct"] is False


@pytest.mark.parametrize("rank", [0, 1])
def test_jax_loaded_on_any_rank_stops_the_result(tmp_path, rank):
    site = ("import os, sys, types\n"
            f"if os.environ.get('LOCAL_RANK', '0') == '{rank}':\n"
            "    sys.modules['flax'] = types.ModuleType('flax')\n")
    p = _gather_run(tmp_path, site)
    assert p.returncode == 3 and p.stdout == ""
    assert "flax" in p.stderr and "forbidden" in p.stderr


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=ROOT)
    p = subprocess.run([sys.executable, "-m", "nucbench", "--workload", "reads150-b5.codec", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout == "" and "CUDA" in p.stderr


def test_only_the_benchmarks_files_no_result(tmp_path):
    import shutil

    shutil.copytree(os.path.join(ROOT, "nucbench"), tmp_path / "nucbench")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-m", "nucbench", "--workload", "reads150-b5.codec", "--seed", "1",
                        "--seconds", "1", "--trace", "0", "--device", "cpu"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
