"""The port's fleet drills end to end on the CPU, each in a subprocess of
its own (``python -m gameoflifewithactors_torch.drills.<name> --device
cpu``), their grids held against the JAX package at tolerance 0.

- serve_load: 24 sessions, 8 sampled, a SIGKILL and ``--resume`` of the
  server; every session of the final checkpoint equals the JAX test
  oracle (``tests/oracle.py``) at its generation.
- soak: three workers (packed, dense, sparse) and their twins under the
  seeded plan, one killed and resumed; each ``final.npy`` equals the JAX
  package's ``GridCoordinator`` run unfaulted from the same genesis.
- chaos_multihost: four gloo processes through a preemption, checkpoint
  rot and a kill, all 14 verdicts ``PASS``; ``final.npy`` equals the JAX
  package's ``multi_step_packed`` from the JAX ``initial_grid``.

Without a card, ``--device cuda`` (the default) exits non-zero before it
starts a process or writes anything.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from gameoflifewithactors_torch.drills import serve_load as t_serve_load
from gameoflifewithactors_torch.resilience import worker as t_worker
from gameoflifewithactors_tpu.coordinator import GridCoordinator as JCoord
from gameoflifewithactors_tpu.models.generations import parse_any as j_parse
from gameoflifewithactors_tpu.ops import bitpack as j_bitpack
from gameoflifewithactors_tpu.ops.packed import multi_step_packed
from gameoflifewithactors_tpu.ops.stencil import Topology as JTop
from gameoflifewithactors_tpu.resilience import distributed as JD

from .oracle import numpy_run

_REPO = Path(__file__).resolve().parents[1]


def _drill(name: str, *args: str, timeout: float, env=None):
    return subprocess.run(
        [sys.executable, "-m", f"gameoflifewithactors_torch.drills.{name}",
         *args], cwd=_REPO, capture_output=True, text=True,
        timeout=timeout, env=dict(os.environ, **(env or {})))


@pytest.mark.parametrize("name", ["serve_load", "soak", "chaos_multihost"])
def test_drill_refuses_without_a_card(name, tmp_path):
    out = tmp_path / "out"
    done = _drill(name, "--out", str(out), timeout=120,
                  env={"CUDA_VISIBLE_DEVICES": ""})
    assert done.returncode != 0
    assert "no CUDA device" in done.stderr
    assert not out.exists() and done.stdout == ""


def test_serve_load_on_the_cpu_equals_the_jax_oracle(tmp_path):
    out = tmp_path / "serve"
    done = _drill("serve_load", "--device", "cpu", "--sessions", "24",
                  "--sample", "8", "--out", str(out), timeout=180)
    assert done.returncode == 0, done.stdout[-3000:] + done.stderr[-3000:]
    lines = done.stdout.splitlines()
    assert "serve_load: 8 grids oracle-checked pre-kill" in lines
    assert "serve_load: SIGKILLed the server; resuming" in lines
    assert lines[-1].startswith("serve_load: OK")
    # the server's final checkpoint (written on its SIGTERM) holds every
    # session: each equals the JAX test oracle at its generation
    ck = np.load(out / "sessions.npz")
    manifest = json.loads(str(ck["manifest"]))
    sessions = sorted(manifest["sessions"], key=lambda s: s["sid"])
    assert len(sessions) == 24
    stride = t_serve_load.sample_stride(24, 8)
    for i, s in enumerate(sessions):
        # two mixed rounds, then three more generations for the sampled
        before_kill = (1 + i % 4) + (1 + (i + 1) % 4)
        assert s["generation"] == before_kill + 3 * (i % stride == 0)
        family, tenant = t_serve_load.session_assignment(i)
        assert s["tenant"] == tenant and s["pending_steps"] == 0
        h, w = family["height"], family["width"]
        seed = (np.random.default_rng(i).random((h, w)) < 0.35
                ).astype(np.uint8)
        want = numpy_run(seed, j_parse(family["rule"]),
                         JTop(family["topology"]), s["generation"])
        got = j_bitpack.unpack_np(ck[s["array"]])
        np.testing.assert_array_equal(got, want)


def test_soak_on_the_cpu_equals_jax(tmp_path):
    out = tmp_path / "soak"
    done = _drill("soak", "--device", "cpu", "--processes", "3",
                  "--generations", "80", "--checkpoint-every", "10",
                  "--watchdog-deadline", "2", "--out", str(out),
                  timeout=300)
    assert done.returncode == 0, done.stdout[-3000:] + done.stderr[-3000:]
    assert done.stdout.splitlines()[-1].startswith("soak: OK")
    report = json.loads((out / "soak_report.json").read_text())
    assert report["ok"] and report["invariant_failures"] == []
    assert [k["worker"] for k in report["results"]["killed"]] == [0]
    timeline = json.loads((out / "timeline.json").read_text())
    assert "launcher" in timeline["flight_headers"]
    assert "goltpu_" in (out / "fleet_metrics.prom").read_text()
    for w, flavor in enumerate(("packed", "dense", "sparse")):
        spec = json.loads((out / f"w{w}" / "spec.json").read_text())
        assert spec["flavor"] == flavor and spec["device"] == "cpu"
        want = JCoord(tuple(spec["shape"]), "B3/S23",
                      seed=t_worker.genesis(spec, 0), backend="packed")
        want.tick(80)
        final = np.load(out / f"w{w}" / "final.npy")
        np.testing.assert_array_equal(final, want.snapshot())
        assert final.sum() > 0


def test_chaos_multihost_on_the_cpu_equals_jax(tmp_path):
    out = tmp_path / "chaos"
    done = _drill("chaos_multihost", "--device", "cpu", "--out", str(out),
                  timeout=300)
    assert done.returncode == 0, done.stdout[-3000:] + done.stderr[-3000:]
    lines = done.stdout.splitlines()
    verdicts = [ln for ln in lines if ln.startswith(("  PASS  ", "  FAIL  "))]
    assert len(verdicts) == 14 and all(v.startswith("  PASS  ")
                                       for v in verdicts), verdicts
    assert lines[-1].startswith("CHAOS-MULTIHOST-OK")
    report = json.loads((out / "chaos_report.json").read_text())
    assert report["ok_with_oracle"]
    assert {f["kind"] for f in report["faults_fired"]} == {
        "process_kill", "process_preempt", "checkpoint_corrupt"}
    spec = JD.ElasticSpec(shape=(96, 128), target_gens=120, chunk=20,
                          rng_seed=0, mesh_shape=(2, 2), gens_per_exchange=4)
    packed0 = jnp.asarray(j_bitpack.pack_np(JD.initial_grid(spec)))
    want = j_bitpack.unpack_np(np.asarray(multi_step_packed(
        packed0, 120, rule=j_parse("B3/S23"), topology=JTop.TORUS)))
    final = np.load(out / "final.npy")
    np.testing.assert_array_equal(final, want[:, :128])
    assert final.sum() > 0
