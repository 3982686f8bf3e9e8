"""Reads `BENCHMARK.json` and finds each piece of a cell by its name:

- a configuration: the file `BENCHMARK.json` names for it (by rule
  `configs/<config>.json`);
- a traffic mix: `traffic/<mix>.json`;
- a per-layer metric: its reader, `metrics/<metric>.py`, a module with
  `read(ctx) -> float | None`.

A later change adds a configuration, a mix, a metric or a cell by adding
such a file and an entry in `BENCHMARK.json`; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)

_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _checked(name: str) -> str:
    if not _NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    return name


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _entry(items: List[dict], name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    return _entry(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: str = ROOT) -> dict:
    """The configuration as it is run (its file), with its entry's name."""
    entry = _entry(bench["configs"], _checked(name), "configuration")
    with open(os.path.join(root, entry["file"])) as f:
        cfg = json.load(f)
    cfg["name"] = name
    return cfg


def traffic(name: str, bench_dir: str = BENCH_DIR) -> dict:
    with open(os.path.join(bench_dir, "traffic", f"{_checked(name)}.json")
              ) as f:
        return json.load(f)


def reader(name: str, bench_dir: str = BENCH_DIR):
    """The per-layer metric's reader module, loaded from its file."""
    path = os.path.join(bench_dir, "metrics", f"{_checked(name)}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _listed(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def end_to_end(bench: dict, cell: str) -> List[dict]:
    """The end-to-end metrics the cell reports."""
    return [m for m in bench["end_to_end"] if _listed(m, cell)]


def per_layer(bench: dict, cell: str) -> List[dict]:
    """The per-layer metrics the cell reports with `--trace 1`: those that
    list it, and those without a list whose end-to-end metric it reports."""
    e2e = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench["per_layer"]
            if ("workloads" in m and cell in m["workloads"])
            or ("workloads" not in m and m["moves"] in e2e)]


def cell_parts(bench: dict, name: str, root: str = ROOT,
               bench_dir: str = BENCH_DIR) -> Dict:
    """-> {"workload", "config", "traffic"} of a cell."""
    wl = workload(bench, name)
    return {"workload": wl, "config": config(bench, wl["config"], root),
            "traffic": traffic(wl["traffic"], bench_dir)}
