"""The port's bench (``python -m gameoflifewithactors_torch.bench``) against
the JAX package and ``bench.py``, on the CPU.

After its warm-up, probe and repetitions the bench's state equals the JAX
package's stepper after the same generations from the same numpy grid,
bit for bit (tolerance 0); its last line has ``bench.py``'s keys and
metric format; it refuses what ``bench.py`` refuses and what the port has
no path for, exiting non-zero with no record; its store keeps the best
fresh record; the provenance of its records follows its timing protocol.
Every store, report and record is written under ``tmp_path``.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from gameoflifewithactors_torch.bench import run as bench
from gameoflifewithactors_torch.utils import provenance
from gameoflifewithactors_tpu.memory import PagedEngineState as JPaged
from gameoflifewithactors_tpu.models import seeds as j_seeds
from gameoflifewithactors_tpu.models.generations import parse_any as j_parse
from gameoflifewithactors_tpu.ops import bitpack as j_bitpack
from gameoflifewithactors_tpu.ops.packed import multi_step_packed
from gameoflifewithactors_tpu.ops.packed_generations import (
    multi_step_packed_generations, pack_generations_for)
from gameoflifewithactors_tpu.ops.packed_ltl import multi_step_ltl_packed
from gameoflifewithactors_tpu.ops.sparse import SparseEngineState as JSparse
from gameoflifewithactors_tpu.ops.stencil import Topology as JTopology
from gameoflifewithactors_tpu.ops.stencil import multi_step

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GENS, REPEATS = 8, 2
TOTAL = bench.WARMUP_GENERATIONS + REPEATS * GENS


def _jax_seed(backend, rule, side):
    """``bench.py``'s seeds (:410-424), through the JAX package."""
    rng = np.random.default_rng(0)
    if backend in ("sparse", "paged"):
        return j_seeds.seeded((side, side), "gosper_gun", side // 2, side // 2)
    states = getattr(rule, "states", 2)
    if states > 2:
        return rng.integers(0, states, size=(side, side), dtype=np.uint8)
    return rng.integers(0, 2, size=(side, side), dtype=np.uint8)


def _run(tmp_path, *extra):
    args = bench.parse(["--device", "cpu", "--gens", str(GENS), "--repeats",
                        str(REPEATS), "--store", str(tmp_path / "s.json"),
                        *extra])
    return bench.run_bench(args)


def _words(t):
    return t.cpu().numpy().view(np.uint32)


@pytest.mark.parametrize("rule_name,backend,side", [
    ("B3/S23", "packed", 256), ("B3/S23", "dense", 256),
    ("brain", "packed", 256), ("bosco", "packed", 256),
    ("B3/S23", "sparse", 1024), ("B3/S23", "paged", 1024)])
def test_bench_state_matches_the_jax_stepper(tmp_path, rule_name, backend,
                                             side):
    record, coord = _run(tmp_path, "--rule", rule_name, "--backend", backend,
                         "--size", str(side))
    assert record["backend"] == backend and coord.generation == TOTAL
    assert [r["generations"] for r in record["repetitions"]] == [GENS] * 2
    rule = j_parse(rule_name)
    grid = _jax_seed(backend, rule, side)
    torus = JTopology.TORUS
    if backend == "dense":
        want = np.asarray(multi_step(jnp.asarray(grid), TOTAL, rule=rule,
                                     topology=torus))
        np.testing.assert_array_equal(coord.engine.state.numpy(), want)
        return
    if rule_name == "brain":
        want = multi_step_packed_generations(
            pack_generations_for(jnp.asarray(grid), rule), TOTAL, rule=rule,
            topology=torus)
    elif rule_name == "bosco":
        want = multi_step_ltl_packed(jnp.asarray(j_bitpack.pack_np(grid)),
                                     TOTAL, rule=rule, topology=torus)
    elif backend in ("sparse", "paged"):
        cls = JSparse if backend == "sparse" else JPaged
        state = cls(jnp.asarray(j_bitpack.pack_np(grid)), rule,
                    topology=torus)
        for n in (bench.WARMUP_GENERATIONS, GENS, GENS):   # the bench's ticks
            state.step(n)
        assert coord.engine.active_tiles() == state.active_tiles()
        want = state.packed
    else:
        want = multi_step_packed(jnp.asarray(j_bitpack.pack_np(grid)), TOTAL,
                                 rule=rule, topology=torus)
    np.testing.assert_array_equal(_words(coord.engine.state), np.asarray(want))


def test_last_line_has_bench_py_keys_and_metric(tmp_path, capsys):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    jax_run = subprocess.run(
        [sys.executable, "bench.py", "--no-probe", "--size", "256", "--gens",
         "8", "--repeats", "1", "--telemetry-out",
         str(tmp_path / "jax_report.json")],
        cwd=_REPO, env=env, capture_output=True, text=True, timeout=300)
    assert jax_run.returncode == 0, jax_run.stderr
    theirs = json.loads(jax_run.stdout.strip().splitlines()[-1])
    assert bench.main(["--device", "cpu", "--size", "256", "--gens", "8",
                       "--repeats", "1", "--store",
                       str(tmp_path / "s.json")]) == 0
    ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(theirs) <= set(ours)
    # the backend and platform names of the port in bench.py's format
    mapped = theirs["metric"].replace("(pallas,", "(cuda,").replace(
        ", tpu)", ", cuda)")
    assert ours["metric"] == mapped == \
        "cell-updates/sec/chip, 256x256 B3/S23 (packed, 50% soup, cpu)"
    assert ours["unit"] == theirs["unit"] == "cell-updates/sec"
    assert ours["vs_baseline"] == ours["value"] / 1e9
    assert ours["value"] == max(r["cell_updates_per_sec"]
                                for r in ours["repetitions"])
    assert ours["median"] == ours["value"] and ours["spread"] == 0.0
    assert ours["device"] == {"name": "cpu", "power_limit": None}
    assert ours["package"] == bench.PACKAGE and "commit" in ours


def test_without_cuda_it_exits_nonzero_and_prints_no_record(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "gameoflifewithactors_torch.bench", "--size",
         "256", "--gens", "8", "--repeats", "1", "--store",
         str(tmp_path / "s.json")],
        cwd=_REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "{" not in out.stdout and "no CUDA device" in out.stderr
    assert not (tmp_path / "s.json").exists()


@pytest.mark.parametrize("extra,message", [
    (["--backend", "pallas"], "kernel backend is 'cuda'"),
    (["--rule", "W110"], "1D (elementary) rule"),
    (["--backend", "cuda"], "needs a CUDA device"),
    (["--backend", "cuda", "--rule", "R2,C3,S2..6,B3..5"],
     "needs a CUDA device")])
def test_refusals_exit_nonzero_with_no_record(tmp_path, capsys, extra,
                                              message):
    store = tmp_path / "s.json"
    rc = bench.main(["--device", "cpu", "--size", "64", "--gens", "8",
                     "--repeats", "1", "--store", str(store), *extra])
    captured = capsys.readouterr()
    assert rc == 2 and captured.out == "" and message in captured.err
    assert not store.exists()


def test_explicit_backends_route_as_bench_py(capsys):
    from gameoflifewithactors_torch.models.generations import parse_any

    assert bench.route("sparse", parse_any("brain"), 256) == "packed"
    assert "runs on the bit-plane packed path; --backend sparse -> packed" \
        in capsys.readouterr().err
    assert bench.route("packed", parse_any("bosco"), 100) == "dense"
    assert "runs on the dense path; --backend packed -> dense" \
        in capsys.readouterr().err
    for rule in ("brain", "bosco", "B3/S23"):
        for backend in ("auto", "cuda", "dense", "paged"):
            assert bench.route(backend, parse_any(rule), 256) == backend
    assert bench.route("sparse", parse_any("bosco"), 256) == "sparse"
    assert bench.route("packed", parse_any("R2,C3,S2..6,B3..5"), 256) == \
        "packed"
    assert capsys.readouterr().err == ""


def test_store_keeps_the_best_fresh_record_and_reports(tmp_path, capsys):
    store = str(tmp_path / "results" / "cuda_best.json")
    # records with no commit stamp: stale, and uncertifiable, so the
    # best-of ratchet decides between them
    rec = {"metric": "cell-updates/sec/chip, 64x64 B3/S23 (packed, 50% soup, "
                     "cpu)", "value": 10.0, "unit": "cell-updates/sec",
           "package": bench.PACKAGE, "commit": None, "commit_dirty": True}
    assert bench.persist_if_best(store, "cpu:auto:64:B3/S23", rec)
    assert not bench.persist_if_best(store, "cpu:auto:64:B3/S23",
                                     {**rec, "value": 5.0})
    assert bench.persist_if_best(store, "cpu:auto:64:B3/S23",
                                 {**rec, "value": 20.0})
    kept = bench.load_store(store)["cpu:auto:64:B3/S23"]
    assert kept["value"] == 20.0 and kept["ok"] is True
    # a record of a clean tree replaces a stale one, even when slower
    clean = {**rec, "value": 15.0, "commit": "abc1234", "commit_dirty": False}
    assert bench.persist_if_best(store, "cpu:auto:64:B3/S23", clean)
    assert bench.load_store(store)["cpu:auto:64:B3/S23"]["value"] == 15.0
    # an --out record beside the store is the port's when it names the
    # package; a record of the JAX package's beside it is not reported
    with open(tmp_path / "results" / "weak.json", "w") as f:
        json.dump({**rec, "value": 3.0}, f)
    with open(tmp_path / "results" / "tpu_best.json", "w") as f:
        json.dump({"auto:default:B3/S23": {**rec, "package": None}}, f)
    bench.report(store)
    lines = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(lines[-1])
    assert summary["records"] == 2 and summary["store"] == store
    assert [ln.split()[1:3] for ln in lines[:-1]] == [
        ["store", "cpu:auto:64:B3/S23"], ["artifact", "weak"]]


def test_telemetry_report_has_a_step_record_per_repetition(tmp_path):
    from gameoflifewithactors_torch.obs.report import RunReport

    report = tmp_path / "results" / "bench_report.json"
    store = tmp_path / "results" / "cuda_best.json"
    assert bench.main(["--device", "cpu", "--size", "128", "--gens", "8",
                       "--repeats", "3", "--store", str(store),
                       "--telemetry-out", str(report),
                       "--profile-sample", "5"]) == 0
    rep = RunReport.load(str(report))
    assert rep.profile["windows"] == 1
    assert (tmp_path / "results" / "bench_report.attribution.json").exists()
    assert [m["generations_stepped"] for m in rep.step_metrics] == [8] * 3
    assert rep.phase_seconds["bench.rep"]["count"] == 3
    assert rep.phase_seconds["bench.warmup"]["count"] == 1
    assert rep.config["backend"] == "packed" and rep.roofline["achieved"]
    entry = bench.load_store(str(store))["cpu:auto:128:B3/S23"]
    assert entry["telemetry_report"] == os.path.join("results",
                                                     "bench_report.json")


def _git(repo, *args):
    return subprocess.run(["git", "-c", "user.name=t", "-c",
                           "user.email=t@example.com", *args], cwd=repo,
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip()


def test_a_record_whose_bench_files_changed_reads_stale(tmp_path):
    run_py = "gameoflifewithactors_torch/bench/run.py"
    assert run_py in provenance.BACKEND_PATHS["cuda"]
    assert all("gameoflifewithactors_torch/bench/timing.py" in paths
               for paths in provenance.BACKEND_PATHS.values())
    assert provenance._PROTOCOL == "gameoflifewithactors_torch/bench"
    assert provenance._PROTOCOL in provenance.ALL_OPS_PATHS
    repo = str(tmp_path)
    _git(repo, "init", "-q")
    os.makedirs(os.path.join(repo, os.path.dirname(run_py)))
    with open(os.path.join(repo, run_py), "w") as f:
        f.write("REPEATS = 3\n")
    _git(repo, "add", "-A")
    _git(repo, "commit", "-q", "-m", "protocol")
    with open(os.path.join(repo, run_py), "w") as f:
        f.write("REPEATS = 5\n")
    _git(repo, "commit", "-q", "-am", "another protocol")
    metric = "cell-updates/sec/chip, 16384x16384 B3/S23 (cuda, 50% soup, cuda)"
    old = {"metric": metric, "commit": _git(repo, "rev-parse", "--short",
                                            "HEAD~")}
    st = provenance.staleness(old, repo=repo)
    assert st["stale"] and run_py in st["reason"]
    fresh = dict(old, commit=_git(repo, "rev-parse", "--short", "HEAD"))
    assert provenance.staleness(fresh, repo=repo)["stale"] is False
