"""Finds a cell's configuration, traffic mix and metrics by name.

``BENCHMARK.json`` at the root of the checkout names every cell
(``workloads``), the file of each configuration, and each metric. A
traffic mix is ``traffic/<name>.json`` and a metric's reader
``metrics/<name>.py`` beside this file; nothing here lists them, so a
later cell, configuration, traffic mix or metric is a file and an entry,
never an edit. Stdlib only.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _named(entries: List[dict], name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    known = ", ".join(e["name"] for e in entries)
    raise KeyError(f"no {what} named {name!r} (known: {known})")


def workload(manifest: dict, name: str) -> dict:
    return _named(manifest["workloads"], name, "workload")


def config(manifest: dict, name: str, root: str = ROOT) -> dict:
    """The configuration file of configuration ``name``."""
    entry = _named(manifest["configs"], name, "configuration")
    with open(os.path.join(root, entry["file"])) as f:
        return json.load(f)


def traffic(name: str, bench_dir: str = BENCH_DIR) -> dict:
    with open(os.path.join(bench_dir, "traffic", f"{name}.json")) as f:
        return json.load(f)


def cell_metrics(manifest: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones with
    ``trace`` off, the per-layer ones with it on; a metric without a
    ``workloads`` list belongs to every cell."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader(name: str, bench_dir: str = BENCH_DIR):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    module_name = "benchmark_metric_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(module_name, path)
    if spec is None:
        raise KeyError(f"no reader for metric {name!r} at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metric(name: str, ctx: dict,
                bench_dir: str = BENCH_DIR) -> Optional[tuple]:
    """``(value, how)`` of metric ``name`` from a run's context, or None
    where its reader finds nothing to read."""
    return reader(name, bench_dir)(ctx)
