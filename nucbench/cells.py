"""Find a cell's parts by the names in ``BENCHMARK.json``.

Everything that belongs to one configuration, one traffic mix or one metric
sits in files of its own, found by name:

* ``configs``' ``file`` entry: the deployment (sizes, guarantees, chips);
* ``nucbench/traffic/<traffic>.json``: the mix's parameters, and the
  ``driver`` that runs it;
* ``nucbench/drivers/<driver>.py``: the general code that makes a mix's
  inputs from the seed, drives its window and checks its answers;
* ``nucbench/end_to_end/<metric>.py`` and ``nucbench/metrics/<metric>.py``:
  one reader a metric, ``read(...) -> float | None``; a metric split by the
  end-to-end metric it moves (``device_idle_pct.batch``) falls back to the
  reader named before its first dot (``device_idle_pct.py``), so the split
  parts share one yardstick.

So a later cell, configuration or metric is new files and new entries; no
file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import types

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    driver: types.ModuleType
    #: (name, unit, reader module) of the end-to-end metrics it reports
    end_to_end: list
    #: (name, unit, reader module) of its per-layer metrics
    per_layer: list


def load_module(path: str, name: str) -> types.ModuleType:
    """A module from its file (names may hold dots, as metric names do)."""
    name = name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(entry: dict, cell: str, moves_ok) -> bool:
    listed = entry.get("workloads")
    return cell in listed if listed is not None else moves_ok(entry)


def reader_path(pkg: str, folder: str, name: str) -> str:
    """``<folder>/<name>.py``, else ``<folder>/<name before its first dot>.py``."""
    whole = os.path.join(pkg, folder, f"{name}.py")
    return whole if os.path.exists(whole) else os.path.join(pkg, folder, f"{name.split('.')[0]}.py")


def resolve(workload: str, root: str = ROOT) -> Cell:
    """The cell named ``workload``, with its configuration, mix, driver and
    metric readers loaded from the files under ``root``."""
    bench = _read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; known: {sorted(cells)}")
    w = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _read_json(os.path.join(root, cfg["file"]))
    pkg = os.path.join(root, "nucbench")
    traffic = _read_json(os.path.join(pkg, "traffic", f"{w['traffic']}.json"))
    driver = load_module(os.path.join(pkg, "drivers", f"{traffic['driver']}.py"), f"nucbench_driver_{traffic['driver']}")

    e2e = [m for m in bench["end_to_end"] if _reports(m, workload, lambda m: True)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reports(m, workload, lambda m: m["moves"] in names)]

    def readers(entries, folder):
        return [(m["name"], m["unit"], load_module(reader_path(pkg, folder, m["name"]), f"nucbench_{folder}_{m['name']}"))
                for m in entries]

    return Cell(workload, int(w["chips"]), config, traffic, driver, readers(e2e, "end_to_end"),
                readers(layer, "metrics"))
