"""``BENCHMARK.json`` and the files it names, found by name.

* a configuration: the ``file`` of its entry (``configs/<name>.json``);
* a traffic mix: ``traffic/<name>.json``, read by ``generator.py``;
* a cell: ``workloads/<name>.json`` (its overrides of the traffic's
  parameters and the limits ``correct`` is held to);
* a metric: ``metrics/<name>.py``, whose ``read(run)`` returns the number
  or None when the run holds nothing to read.

A later cell or metric adds files and entries; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

from perfbench import generator

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def cell(bench: dict, name: str, root: Path = ROOT):
    """The cell ``name`` with its configuration, traffic and limits."""
    from perfbench.bench import Cell

    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    entry = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / configs[entry["config"]]["file"])
    workload = _json(HERE / "workloads" / f"{name}.json")
    traffic = _json(HERE / "traffic" / f"{entry['traffic']}.json")
    traffic.update(workload.get("traffic", {}))
    return Cell(name, config, generator.check(traffic), workload["limits"],
                entry["chips"])


def metrics_for(bench: dict, name: str, trace: bool) -> list[dict]:
    """The metrics a run of cell ``name`` reports: its end-to-end metrics,
    or with tracing its per-layer ones (listed for it, or unlisted and
    moving an end-to-end metric the cell reports)."""
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if name in m.get("workloads", ()) or (
                "workloads" not in m and m["moves"] in moved)]


def reader(metric: str):
    """``read`` of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    if mod_spec is None or not path.is_file():
        raise FileNotFoundError(f"metric {metric!r} has no reader {path}")
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
