"""The port's soak worker, end to end on the CPU, against the JAX package.

``python -m gameoflifewithactors_torch.resilience.worker`` runs a packed
member under the Supervisor with a FaultPlan; the test SIGKILLs it
mid-run (the ``kill`` fault kind belongs to the launcher), relaunches it
with ``--resume``, and holds the final grid against the JAX package's
coordinator run unfaulted from the same grid, and the report against the
JAX worker's fields.
"""

import json
import os
import select
import signal
import subprocess
import sys
import time
import urllib.request

import numpy as np

from gameoflifewithactors_torch.resilience import worker as t_worker
from gameoflifewithactors_torch.resilience.faultplan import FaultEvent
from gameoflifewithactors_tpu.coordinator import GridCoordinator as JCoord
from gameoflifewithactors_tpu.resilience import worker as j_worker

REPORT_FIELDS = {"name", "flavor", "resume", "pid", "ok", "members",
                 "stalls_detected", "flight_dumps", "last_dump_reason"}
MEMBER_FIELDS = {"member", "resumed_generation", "final_generation",
                 "population", "faults_applied", "supervisor"}


def _healthz(port: int) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                timeout=5) as r:
        return json.loads(r.read())


def test_worker_killed_resumes_and_equals_jax(tmp_path):
    plan = [
        FaultEvent(worker=0, at_gen=50, kind="corrupt_region",
                   params={"top_f": 0.1, "left_f": 0.1, "h_f": 0.25,
                           "w_f": 0.25, "seed": 11}).to_dict(),
        FaultEvent(worker=0, at_gen=70, kind="retrace").to_dict(),
    ]
    workdir = tmp_path / "w0"
    spec = {"name": "t-worker", "flavor": "packed", "shape": [64, 64],
            "generations": 100, "checkpoint_every": 20, "rng_seed": 5,
            "workdir": str(workdir), "watchdog_deadline": 5.0,
            "events": plan, "device": "cpu", "chunk_sleep_seconds": 0.3}
    spec_path = tmp_path / "spec.json"
    spec_path.write_text(json.dumps(spec))
    cmd = [sys.executable, "-m", "gameoflifewithactors_torch.resilience.worker",
           "--spec", str(spec_path)]
    env = dict(os.environ, GOLTPU_SANITIZE="1")
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    try:
        assert select.select([proc.stdout], [], [], 60)[0], "no METRICS_PORT"
        line = proc.stdout.readline()
        assert line.startswith("METRICS_PORT "), proc.stderr.read()[-2000:]
        port = int(line.split()[1])
        deadline = time.perf_counter() + 60
        # the gen-0 save and the first chunk's are durable
        while _healthz(port).get("checkpoints", 0) < 2:
            assert time.perf_counter() < deadline and proc.poll() is None
            time.sleep(0.05)
        proc.send_signal(signal.SIGKILL)     # the launcher's `kill` kind
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate(timeout=30)
    assert proc.returncode == -signal.SIGKILL
    assert not (workdir / "final.npy").exists()

    resumed = subprocess.run(cmd + ["--resume"], capture_output=True,
                             text=True, timeout=120, env=env)
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    assert resumed.stdout.startswith("METRICS_PORT ")
    report = json.loads((workdir / "report.json").read_text())
    assert set(report) == REPORT_FIELDS and report["ok"] is True
    assert report["resume"] is True
    member = report["members"][0]
    assert set(member) == MEMBER_FIELDS
    assert 20 <= member["resumed_generation"] < 50
    assert member["final_generation"] == 100
    assert member["supervisor"]["restarts_by_cause"] == \
        {"fault:corrupt_region": 1}
    assert member["supervisor"]["retraces_attributed"] == 1

    want = JCoord((64, 64), "B3/S23", seed=t_worker.genesis(spec, 0),
                  backend="packed")
    want.tick(100)
    final = np.load(workdir / "final.npy")
    np.testing.assert_array_equal(final, want.snapshot())
    assert member["population"] == int(final.sum()) > 0
    assert t_worker.FLAVORS == j_worker.FLAVORS


def test_resumed_report_counts_the_killed_incarnation(tmp_path):
    """A stall and a corruption applied before the SIGKILL stay in the
    resumed worker's report (``progress.json``): the faults, the restarts
    they caused, the stall detected and its flight dump; neither is
    applied again, and the final grid equals the JAX package's
    coordinator run unfaulted."""
    plan = [
        FaultEvent(worker=0, at_gen=20, kind="stall").to_dict(),
        FaultEvent(worker=0, at_gen=30, kind="corrupt_region",
                   params={"top_f": 0.2, "left_f": 0.3, "h_f": 0.3,
                           "w_f": 0.3, "seed": 4}).to_dict(),
    ]
    workdir = tmp_path / "w0"
    spec = {"name": "t-progress", "flavor": "packed", "shape": [64, 64],
            "generations": 100, "checkpoint_every": 10, "rng_seed": 9,
            "workdir": str(workdir), "watchdog_deadline": 1.0,
            "events": plan, "device": "cpu", "chunk_sleep_seconds": 0.2}
    spec_path = tmp_path / "spec.json"
    spec_path.write_text(json.dumps(spec))
    cmd = [sys.executable, "-m", "gameoflifewithactors_torch.resilience.worker",
           "--spec", str(spec_path)]
    env = dict(os.environ, GOLTPU_SANITIZE="1")
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    try:
        assert select.select([proc.stdout], [], [], 60)[0], "no METRICS_PORT"
        port = int(proc.stdout.readline().split()[1])
        deadline = time.perf_counter() + 60
        while _healthz(port).get("generation", 0) < 50:
            assert time.perf_counter() < deadline and proc.poll() is None
            time.sleep(0.05)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate(timeout=30)
    progress = json.loads((workdir / "progress.json").read_text())
    assert progress["members"]["0"]["consumed"] == [0, 1]

    resumed = subprocess.run(cmd + ["--resume"], capture_output=True,
                             text=True, timeout=120, env=env)
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    report = json.loads((workdir / "report.json").read_text())
    assert set(report) == REPORT_FIELDS and report["ok"] and report["resume"]
    member = report["members"][0]
    assert [(f["kind"], f["applied_at_gen"])
            for f in member["faults_applied"]] == [("stall", 20),
                                                   ("corrupt_region", 30)]
    assert member["resumed_generation"] >= 40
    assert member["supervisor"]["restarts_by_cause"] == \
        {"fault:stall": 1, "fault:corrupt_region": 1}
    assert report["stalls_detected"] >= 1 and report["flight_dumps"] >= 1

    want = JCoord((64, 64), "B3/S23", seed=t_worker.genesis(spec, 0),
                  backend="packed")
    want.tick(100)
    np.testing.assert_array_equal(np.load(workdir / "final.npy"),
                                  want.snapshot())
