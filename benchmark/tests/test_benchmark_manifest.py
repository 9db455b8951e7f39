"""BENCHMARK.json against the contract's form, and finding things by name."""

from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from benchmark import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                  "workloads"},
}


@pytest.fixture(scope="module")
def bench():
    return manifest.load()


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_names_and_units(bench):
    assert set(bench) == KEYS["top"]
    names = []
    for group, kind in (("configs", "config"), ("workloads", "workload"),
                        ("end_to_end", "end_to_end"),
                        ("per_layer", "per_layer")):
        for entry in bench[group]:
            assert set(entry) <= KEYS[kind], entry
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert _line(entry[key]), (key, entry[key])
    metric_names = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(set(metric_names)) == len(metric_names)
    for group in ("configs", "workloads"):
        group_names = [n for g, n in names if g == group]
        assert len(set(group_names)) == len(group_names)
    assert len(json.dumps(bench)) <= 64 * 1024
    assert all(_line(word) for word in bench["command"])


def test_end_to_end_rules(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in bench["workloads"]}
    for cell in cells:
        reported = manifest.cell_metrics(bench, cell, trace=False)
        assert len(reported) >= 2 and any(m["name"] == "setup_s"
                                           for m in reported)
        assert manifest.cell_metrics(bench, cell, trace=True)


def test_per_layer_rules(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    layers = {}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell]), (m["name"], cell)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], []).append(m["name"])
    assert set(layers) == {"warm start", "facade", "engine and launcher",
                           "front end and service", "lanes", "kernels",
                           "device", "mesh"}


def test_cells_and_files(bench):
    configs = {c["name"] for c in bench["configs"]}
    used = {w["config"] for w in bench["workloads"]}
    assert used == configs
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(1 for w in bench["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(bench["workloads"]) // 4)
    for w in bench["workloads"]:
        assert w["chips"] in (1, 4)
        traffic = manifest.traffic(w["traffic"])
        assert traffic["driver"] in ("batch", "sessions")
    for c in bench["configs"]:
        assert c["file"].startswith("benchmark/configs/")
        data = manifest.config(bench, c["name"])
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(manifest.reader(m["name"]))
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51


def test_an_added_configuration_is_found_without_an_edit(tmp_path):
    """A later PR adds files and entries: a configuration, a traffic mix,
    a metric and a cell, all found by name in a copy of the benchmark."""
    root = tmp_path / "checkout"
    shutil.copytree(manifest.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "_work",
                                                  "__pycache__"))
    bench = manifest.load()
    extra = json.loads((root / "benchmark/configs/conway-b3s23.json")
                       .read_text())
    extra.update(name="highlife-b36s23", rule="B36/S23", born=[[3, 3], [6, 6]])
    (root / "benchmark/configs/highlife-b36s23.json").write_text(
        json.dumps(extra))
    (root / "benchmark/traffic/batch-1024.json").write_text(json.dumps(
        dict(manifest.traffic("batch-16384"), shape=[1024, 1024])))
    (root / "benchmark/metrics/extra.generations.py").write_text(
        "def read(ctx):\n    return ctx['window']['generations'], 'count'\n")
    bench["configs"].append({"name": "highlife-b36s23", "source": "x",
                             "file": "benchmark/configs/highlife-b36s23.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "highlife-batch-1024",
                               "config": "highlife-b36s23",
                               "traffic": "batch-1024", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "extra.generations", "unit": "gens",
                               "better": "higher", "source": "program_counter",
                               "layer": "facade", "moves": "setup_s",
                               "workloads": ["highlife-batch-1024"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    loaded = manifest.load(str(root))
    cell = manifest.workload(loaded, "highlife-batch-1024")
    assert manifest.config(loaded, cell["config"], str(root))["rule"] == "B36/S23"
    assert manifest.traffic(cell["traffic"],
                            str(root / "benchmark"))["shape"] == [1024, 1024]
    names = [m["name"] for m in manifest.cell_metrics(loaded, cell["name"], True)]
    assert "extra.generations" in names
    value, _ = manifest.read_metric("extra.generations",
                                    {"window": {"generations": 42}},
                                    str(root / "benchmark"))
    assert value == 42
    assert os.path.exists(root / "benchmark/run.py")
