"""A later cell, configuration or metric is new files and new entries: the
harness finds them by name, and no file that is already there changes."""

import hashlib
import json
import os
import shutil
import time

from nucbench import cells, harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _digests(root) -> dict:
    out = {}
    for d, _, files in os.walk(root / "nucbench"):
        for f in files:
            if f.endswith((".py", ".json")):
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_a_cell_added_as_new_files_only(tmp_path):
    shutil.copytree(os.path.join(ROOT, "nucbench"), tmp_path / "nucbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path)

    pkg = tmp_path / "nucbench"
    (pkg / "configs" / "tiny-genome.json").write_text(json.dumps(
        {"name": "tiny-genome", "chromosomes": {"c1": 4000, "c2": 2500}, "reduced": [], "assumed": []}))
    (pkg / "traffic" / "guides-tiny.json").write_text(json.dumps(
        {"driver": "guide_search", "guide_pool": 8, "spacer_nt": 20, "pam": "NGG", "from_genome": 0.5,
         "checked_guides": 2}))
    (pkg / "metrics" / "traced_window_s.py").write_text("def read(trace):\n    return trace.window_s\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-genome", "source": "https://example.org/tiny",
                             "file": "nucbench/configs/tiny-genome.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny-genome.guides-tiny", "config": "tiny-genome", "traffic": "guides-tiny",
                               "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] in ("query_rate", "query_p95_ms"):
            m["workloads"].append("tiny-genome.guides-tiny")
    bench["per_layer"].append({"name": "traced_window_s", "unit": "s", "better": "lower", "source": "host_clock",
                               "layer": "Client", "moves": "query_rate", "workloads": ["tiny-genome.guides-tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = cells.resolve("tiny-genome.guides-tiny", root=str(tmp_path))
    assert [m[0] for m in cell.end_to_end] == ["query_rate", "query_p95_ms", "setup_s"]
    assert [m[0] for m in cell.per_layer] == ["traced_window_s"]  # the others list their cells
    plain = harness.run(cell, 2**32 + 5, 0.5, False, t0=time.perf_counter(), device="cpu")
    assert plain["correct"] and set(plain["metrics"]) == {"query_rate", "query_p95_ms", "setup_s"}
    traced = harness.run(cell, 2**32 + 5, 0.5, True, t0=time.perf_counter(), device="cpu")
    assert traced["correct"] and set(traced["metrics"]) == {"traced_window_s"}
    after = _digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before
    assert sorted(set(after) - set(before)) == ["nucbench/configs/tiny-genome.json", "nucbench/metrics/traced_window_s.py",
                                                "nucbench/traffic/guides-tiny.json"]


def test_every_named_part_of_the_benchmark_exists():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for w in bench["workloads"]:
        cell = cells.resolve(w["name"])
        assert cell.chips == w["chips"] and cell.per_layer and len(cell.end_to_end) >= 2


def test_split_metrics_share_the_reader_named_before_the_dot():
    pkg = os.path.join(ROOT, "nucbench")
    assert cells.reader_path(pkg, "metrics", "device_idle_pct.query") == os.path.join(pkg, "metrics",
                                                                                       "device_idle_pct.py")
    assert cells.reader_path(pkg, "metrics", "codec_roofline") == os.path.join(pkg, "metrics", "codec_roofline.py")
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for m in bench["per_layer"]:
        assert os.path.exists(cells.reader_path(pkg, "metrics", m["name"])), m["name"]
    texts = [open(os.path.join(pkg, "metrics", f), "rb").read() for f in os.listdir(os.path.join(pkg, "metrics"))
             if f.endswith(".py")]
    assert len(texts) == len(set(texts))  # no two readers are copies of one yardstick
