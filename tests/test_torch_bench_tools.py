"""The bench package's tools against the repository's scripts and the JAX
package, on the CPU.

The gate and the history, and the JAX scripts ``scripts/perf_gate.py`` and
``scripts/perf_history.py`` (loaded by path), give the same rows, exit
codes, folded entries and anomaly flags over the same synthetic records;
``weak_scaling``'s grids equal the JAX script's sharded runner on the fake
CPU devices and its records have the JAX script's keys; ``config5``'s
population and active tiles equal the JAX engines'; ``warm_vs_cold``'s warm
process is served from the registry its cold one wrote; the roofline
report renders a RunReport and ``--check`` says whether it has a device
track. Every record, store and history is written under ``tmp_path``.
"""

import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gameoflifewithactors_torch.bench import (config5, gate, history,
                                              roofline_report, warm_vs_cold,
                                              weak_scaling)
from gameoflifewithactors_torch.bench import run as bench
from gameoflifewithactors_torch.models.rules import CONWAY as T_CONWAY
from gameoflifewithactors_torch.ops.packed import multi_step_packed as t_packed
from gameoflifewithactors_tpu.memory import PagedEngineState as JPaged
from gameoflifewithactors_tpu.models import seeds as j_seeds
from gameoflifewithactors_tpu.models.rules import CONWAY
from gameoflifewithactors_tpu.ops import bitpack as j_bitpack
from gameoflifewithactors_tpu.ops.sparse import SparseEngineState as JSparse
from gameoflifewithactors_tpu.ops.stencil import Topology as JTopology
from gameoflifewithactors_tpu.parallel import mesh as j_mesh
from gameoflifewithactors_tpu.parallel import sharded as j_sharded

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    path = os.path.join(_REPO, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bench_record(value, **extra):
    return {"metric": "cell-updates/sec/chip, 16384x16384 B3/S23 (cuda, 50% "
                      "soup, cuda)", "value": value,
            "unit": "cell-updates/sec", **extra}


def _report(rate, tick_mean=0.1):
    return {"schema_version": 1, "created_at": "2026-10-17T00:00:00Z",
            "step_metrics": [{"generation": 8, "generations_stepped": 8,
                              "wall_seconds": 1.0,
                              "cell_updates_per_sec": rate}],
            "compile_seconds_total": 2.0,
            "phase_seconds": {"coordinator.tick": {
                "total_s": 4 * tick_mean, "count": 4, "mean_s": tick_mean}},
            "stalls": []}


@pytest.mark.parametrize("base,current,want_rc", [
    (_bench_record(1.2e13), _bench_record(1.15e13), 0),
    (_bench_record(1.2e13), _bench_record(0.6e13), 1),
    (_bench_record(1.2e13, needs_recapture=True), _bench_record(0.6e13), 0),
    (_report(1e9), _report(0.5e9, tick_mean=0.3), 1),
    ({"parsed": _bench_record(2.0)}, {"parsed": _bench_record(2.1)}, 0)])
def test_gate_matches_perf_gate(tmp_path, capsys, base, current, want_rc):
    paths = []
    for name, rec in (("base.json", base), ("current.json", current)):
        paths.append(str(tmp_path / name))
        with open(paths[-1], "w") as f:
            json.dump(rec, f)
    theirs_rc = _script("perf_gate").main([*paths, "--json"])
    theirs = json.loads(capsys.readouterr().out)
    ours_rc = gate.main([*paths, "--json"])
    ours = json.loads(capsys.readouterr().out)
    assert ours_rc == theirs_rc == want_rc
    assert ours == theirs
    assert gate.main([*paths, "--informational"]) == 0
    capsys.readouterr()


def test_gate_refuses_unusable_input(tmp_path, capsys):
    assert gate.main([str(tmp_path / "missing.json"),
                      str(tmp_path / "missing.json")]) == 2
    assert "unusable input" in capsys.readouterr().err


def _write(path, rec):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f)


def test_history_folds_what_perf_history_folds_of_the_port(tmp_path):
    repo = str(tmp_path)
    res = os.path.join(repo, "results")
    store = os.path.join(res, "cuda_best.json")
    _write(store, {
        "cuda:auto:16384:B3/S23": {**_bench_record(1.27e13),
                                   "recorded_at": "2026-10-17T01:00:00Z",
                                   "telemetry_report":
                                       "results/bench_report.json"},
        "cuda:cuda:16384:brain": {**_bench_record(8.3e12),
                                  "metric": "brain", "stale": True}})
    _write(os.path.join(res, "bench_report.json"), _report(1.26e13))
    # a series of five records, the last one far from the others
    for i, value in enumerate((1.0, 1.02, 0.99, 1.01, 3.0)):
        _write(os.path.join(res, f"weak_{i}.json"), {
            "metric": "weak-scaling efficiency (cuda)", "value": value,
            "unit": "fraction", "package": bench.PACKAGE,
            "single_chip_equivalent_updates_per_sec": 1e12 * value,
            "recorded_at": f"2026-10-17T0{i}:00:00Z"})
    # the JAX package's records: not the port's to fold
    _write(os.path.join(res, "tpu_best.json"),
           {"auto:default:B3/S23": _bench_record(2.2e12)})
    _write(os.path.join(repo, "BENCH_r01.json"),
           {"parsed": _bench_record(1e9)})
    _write(os.path.join(res, "warmstart_cpu.json"),
           {"metric": "warm-start (cpu)", "value": 0.4})
    jax_hist = _script("perf_history")
    theirs = jax_hist.fold(repo, os.path.join(repo, "jax.jsonl"))["appended"]
    theirs = [e for e in theirs if not e["source"].startswith(
        ("BENCH_", "results/tpu_", "results/warmstart_cpu"))]
    ours = history.fold(repo, store, os.path.join(res, "history_cuda.jsonl"))
    strip = lambda es: sorted(({k: v for k, v in e.items()
                                if k != "appended_at"} for e in es),
                              key=lambda e: e["id"])
    assert strip(ours["appended"]) == strip(theirs)
    assert len(ours["appended"]) == 2 + 1 + 10
    stats = history.series_stats(strip(ours["history"]))
    assert stats == jax_hist.series_stats(strip(theirs))
    flagged = {s: [a["value"] for a in v["anomalies"]] for s, v in
               stats.items() if v["anomalies"]}
    assert flagged == {"weak-scaling efficiency (cuda)": [3.0],
                       "weak-scaling efficiency (cuda) [per-chip-equivalent]":
                           [3e12]}
    # append-only: a second fold appends nothing; --strict sees the anomaly
    assert history.fold(repo, store, os.path.join(
        res, "history_cuda.jsonl"))["appended"] == []
    assert history.main(["--repo", repo, "--check", "--strict"]) == 1
    assert history.main(["--repo", repo, "--check"]) == 0
    assert history.main(["--repo", str(tmp_path / "empty"), "--check"]) == 2


def _jax_weak_lines(capsys, argv):
    mod = _script("weak_scaling")
    saved = sys.argv
    sys.argv = ["weak_scaling.py", *argv]
    try:
        mod.main()
    finally:
        sys.argv = saved
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]


def test_weak_scaling_matches_the_jax_script(tmp_path, capsys):
    argv = ["--tile", "64x64", "--gens", "8", "--repeats", "1", "--counts",
            "1,2,4"]
    theirs = _jax_weak_lines(capsys, argv)
    store = str(tmp_path / "results" / "cuda_best.json")
    bench.persist_if_best(store, "cpu:auto:64:B3/S23", {
        "metric": "cell-updates/sec/chip, 64x64 B3/S23 (packed, 50% soup, "
                  "cpu)", "value": 1e8, "unit": "cell-updates/sec",
        "rule": "B3/S23", "recorded_at": "2026-10-17T00:00:00Z"})
    ours = weak_scaling.run(weak_scaling.parse(
        argv + ["--device", "cpu", "--positions", "4", "--store", store]))
    capsys.readouterr()
    assert [set(r) for r in ours["series"]] == [set(r) for r in theirs[:-1]]
    assert set(ours["summary"]) == set(theirs[-1])
    for key in ("devices", "mesh", "grid", "runner", "platform"):
        assert [r[key] for r in ours["series"]] == \
            [r[key] for r in theirs[:-1]]
    assert ours["summary"]["metric"] == theirs[-1]["metric"]
    # the grids: the JAX script's draws, its sharded runner on the fake
    # CPU devices, the same generations
    rng = np.random.default_rng(0)
    for fin, rec in zip(ours["finals"], theirs):
        h, w = rec["grid"]
        grid = rng.integers(0, 2, size=(h, w), dtype=np.uint8)
        mesh = j_mesh.make_mesh(None, jax.devices()[:rec["devices"]])
        run = j_sharded.make_multi_step_packed(mesh, CONWAY, JTopology.TORUS)
        placed = j_mesh.device_put_sharded_grid(
            jnp.asarray(j_bitpack.pack_np(grid)), mesh)
        want = np.asarray(run(placed, fin["generations"]))
        assert fin["generations"] == 8 + 8
        np.testing.assert_array_equal(
            fin["final"].numpy().view(np.uint32), want)


@pytest.mark.parametrize("runner", ["band", "sparse-tiled"])
def test_weak_scaling_runners_step_the_global_grid(tmp_path, capsys, runner):
    ours = weak_scaling.run(weak_scaling.parse(
        ["--device", "cpu", "--positions", "4", "--tile", "64x64", "--gens",
         "8", "--repeats", "1", "--runner", runner, "--store",
         str(tmp_path / "none.json")]))
    capsys.readouterr()
    assert [r["devices"] for r in ours["series"]] == [1, 2, 4]
    assert "cost_vs_single_chip" not in ours["summary"]
    for fin in ours["finals"]:
        want = t_packed(fin["start"], fin["generations"], rule=T_CONWAY)
        assert torch.equal(fin["final"], want)
    out = str(tmp_path / "weak.json")
    assert weak_scaling.main(["--device", "cpu", "--positions", "2", "--tile",
                              "64x64", "--gens", "8", "--repeats", "1",
                              "--runner", runner, "--store",
                              str(tmp_path / "none.json"), "--out", out]) == 0
    with open(out) as f:
        rec = json.load(f)
    assert rec["stale"] and rec["needs_recapture"] and \
        rec["package"] == bench.PACKAGE


def test_weak_scaling_reference_is_the_dense_main_path(tmp_path):
    store = str(tmp_path / "results" / "cuda_best.json")
    soup = "cell-updates/sec/chip, 64x64 B3/S23 (packed, 50% soup, cpu)"
    for key, metric, value, at in (
            ("cpu:auto:64:B3/S23", soup, 1e8, "2026-10-17T00:00:00Z"),
            # newer, and none may stand in: a gun, another size, an
            # explicit plain backend, another rule, another platform
            ("cpu:sparse:default:B3/S23", "cell-updates/sec/chip, "
             "4096x4096 B3/S23 (sparse, gosper-gun, cpu)", 5e12,
             "2026-10-18T00:00:00Z"),
            ("cpu:auto:1024:B3/S23", soup.replace("64x64", "1024x1024"),
             3e8, "2026-10-18T00:00:01Z"),
            ("cpu:packed:64:B3/S23", soup, 4e8, "2026-10-18T00:00:02Z"),
            ("cpu:auto:64:brain", soup, 6e8, "2026-10-18T00:00:03Z"),
            ("cuda:auto:default:B3/S23", soup, 7e8, "2026-10-18T00:00:04Z")):
        bench.persist_if_best(store, key, {
            "metric": metric, "value": value, "unit": "cell-updates/sec",
            "rule": "brain" if key.endswith("brain") else "B3/S23",
            "recorded_at": at})
    ref = weak_scaling.single_chip_reference("cpu", "B3/S23", (64, 64), store)
    assert ref["value"] == 1e8 and ref["file"].endswith("#cpu:auto:64:B3/S23")
    assert ref["stale"]         # no commit stamp
    assert weak_scaling.single_chip_reference("cpu", "B3/S23", None,
                                              store) is None


def test_weak_scaling_sizes_repetitions_by_time(tmp_path, capsys,
                                                monkeypatch):
    monkeypatch.setattr(weak_scaling, "REP_SECONDS", 0.02)
    for runner, g in (("packed", 1), ("band", 8)):
        ours = weak_scaling.run(weak_scaling.parse(
            ["--device", "cpu", "--positions", "2", "--tile", "64x64",
             "--repeats", "2", "--runner", runner, "--store",
             str(tmp_path / "none.json")]))
        for fin in ours["finals"]:
            gens = [r["generations"] for r in fin["repetitions"]]
            assert len(gens) == 2 and all(
                n >= bench.MIN_GENS and n % g == 0 for n in gens)
            assert fin["generations"] == 8 * g + 64 + sum(gens)
            want = t_packed(fin["start"], fin["generations"], rule=T_CONWAY)
            assert torch.equal(fin["final"], want)
    capsys.readouterr()


def test_config5_build_and_step_keeps_the_record_format():
    words = config5.seed_words(1024)
    _, rec = config5.build_and_step(words, "sparse", 24, topology="torus",
                                    device="cpu")
    (timed,) = config5.run(size=1024, gens=8, repeats=1,
                           backends=("sparse",), device="cpu",
                           emit=lambda line: None)
    assert set(rec) == set(timed) | {"build_s"}
    assert rec["topology"] == "torus" and timed["topology"] == "dead"
    assert rec["generations_run"] == 24 and len(rec["repetition_seconds"]) == 1
    assert rec["value"] == 24 / rec["repetition_seconds"][0]
    assert rec["population"] > 36


def test_config5_matches_the_jax_engines():
    gens, repeats = 24, 2
    ours = config5.run(size=1024, gens=gens, repeats=repeats,
                       backends=("sparse", "paged"), device="cpu",
                       emit=lambda line: None)
    words = j_seeds.seeded_packed((1024, 1024), "gosper_gun", top=512,
                                  left_word=16)
    for summary, cls in zip(ours, (JSparse, JPaged)):
        state = cls(jnp.asarray(words), CONWAY)
        for n in (4,) + (gens,) * repeats:
            state.step(n)
        assert summary["population"] == j_bitpack.population(state.packed)
        assert summary["active_tiles"] == state.active_tiles()
        assert summary["generations_run"] == 4 + gens * repeats
        assert summary["metric"] == (f"gens/sec, 1024x1024 Gosper gun "
                                     f"({summary['backend']}, cpu)")
    assert ours[0]["population"] > 36      # the gun fired


def test_warm_vs_cold_warm_process_reads_the_registry(tmp_path, monkeypatch,
                                                      capsys):
    monkeypatch.setattr(warm_vs_cold, "specs_for",
                        lambda device: warm_vs_cold.PLAIN_SPECS[:1])
    out = str(tmp_path / "warm.json")
    root = str(tmp_path / "root")
    assert warm_vs_cold.main(["--device", "cpu", "--keep-cache", root,
                              "--out", out]) == 0
    with open(out) as f:
        rec = json.load(f)
    (row,) = rec["specs"]
    assert row["warm_aot_loaded"] is True and row["cold_events"] == {}
    assert row["warm_events"] == {"aot_loaded": 1}
    assert rec["layer1_only_warm"]["events"] == {}
    assert os.listdir(os.path.join(root, "torch_aot"))
    assert os.path.exists(rec["warm_report"])
    assert json.loads(capsys.readouterr().out)["metric"].endswith(
        "1 representative specs (cpu)")


def test_roofline_report_renders_and_checks(tmp_path, capsys):
    cpu_report = str(tmp_path / "results" / "r.json")
    assert bench.main(["--device", "cpu", "--size", "128", "--gens", "8",
                       "--repeats", "1", "--store",
                       str(tmp_path / "results" / "s.json"),
                       "--telemetry-out", cpu_report]) == 0
    capsys.readouterr()
    assert roofline_report.main([cpu_report]) == 0
    text = capsys.readouterr().out
    assert "Device activity**: not measured" in text
    assert "Counted work" in text
    assert roofline_report.main([cpu_report, "--check"]) == 1
    with open(cpu_report) as f:
        rep = json.load(f)
    (step,) = rep["step_metrics"]
    best, wall = step["cell_updates_per_sec"], step["wall_seconds"]
    # a device track whose span (busy / duty) is the tick's alone, then
    # one whose span holds more than the tick
    for busy, want in ((0.5 * wall, f"In-kernel rate**: {best / 0.5:.4e}"),
                       (0.6 * wall, "In-kernel rate**: not measured")):
        rep["profile"] = {"source": "device_tracks", "windows": 1,
                          "device_busy_seconds": busy,
                          "device_duty_cycle": 0.5,
                          "idle_gaps_us": [120.0, 8.5],
                          "top_kernels": [["life_packed_kernel", 240000.0]]}
        card = str(tmp_path / "card.json")
        with open(card, "w") as f:
            json.dump(rep, f)
        assert roofline_report.main([card, "--check"]) == 0
        assert roofline_report.main([card]) == 0
        text = capsys.readouterr().out
        assert want in text
        assert "`life_packed_kernel` — 240.000 ms" in text
        assert f"{busy * 1e3:.3f} ms over 1 profiler window(s)" in text
    assert roofline_report.main([str(tmp_path / "missing.json")]) == 1
    assert roofline_report.main([str(tmp_path / "missing.json"),
                                 "--check"]) == 1
