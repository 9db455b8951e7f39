"""Soak worker: one supervised coordinator process, driven by a spec.

Counterpart of ``gameoflifewithactors_tpu.resilience.worker``.
``python -m gameoflifewithactors_torch.resilience.worker --spec
spec.json`` builds the coordinator flavor the spec names (packed, dense,
sparse, LtL, or an ensemble of supervised members) on the spec's
``device`` (default the card), arms the full obs stack (StallWatchdog +
FlightRecorder + MetricsServer with a /healthz progress probe), and runs
the spec's generations under a :class:`~.supervisor.Supervisor`,
applying the spec's FaultPlan slice at chunk boundaries through the
supervisor's detected-fault channel.

Member ``m`` starts from ``rng_seed + m`` and ``random_fill`` through
numpy (``np.random.default_rng``), so that the same spec gives the same
grid on every device and in a launcher's oracle (the JAX package's worker
draws it with ``jax.random``, whose bits torch cannot reproduce).

Launcher protocol:

- stdout line 1: ``METRICS_PORT <port>`` — the launcher scrapes
  ``/healthz`` for live generation/restart counts and ``/metrics`` for
  the counters;
- the launcher may SIGKILL this process at any moment (that *is* the
  ``kill`` fault kind) and relaunch with ``--resume``: the worker
  reloads the last atomic checkpoint and skips the plan events an
  earlier incarnation consumed (``progress.json``, rewritten at every
  chunk boundary: the events applied, the supervisor's counters, the
  stalls detected and flight dumps), so that the final report counts
  every incarnation's faults, restarts, stalls and dumps (the JAX
  package's worker reports its last incarnation's only, and skips every
  event scheduled before the checkpointed generation, applied or not);
- on completion the worker writes ``final.npy`` (the exact grid — the
  launcher diffs it against the unfaulted oracle's) and ``report.json``
  (supervisor stats + fault accounting), then exits 0. Exit 2 = the
  supervisor gave up (circuit open / unexplained retrace); exit 1 =
  spec or harness error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

# flavor -> (rule, backend) — the mixed fleet the soak exercises; the
# ensemble flavor runs `ensemble_size` supervised members sequentially
# in one process (member m seeds from rng_seed + m)
FLAVORS = {
    "packed": ("B3/S23", "packed"),
    "dense": ("B3/S23", "dense"),
    "sparse": ("B3/S23", "sparse"),
    "ltl": ("majority", "dense"),
    "ensemble": ("B3/S23", "packed"),
}


def _checkpoint_path(workdir: Path, member: int) -> Path:
    return workdir / f"checkpoint-m{member}.npz"


def _add_stats(prior: dict, now: dict) -> dict:
    """Supervisor counters over incarnations: ``prior`` (an earlier
    process's, from ``progress.json``) plus ``now``; the generation and
    the circuit are this process's."""
    out = dict(now)
    for key, value in now.items():
        if key == "restarts_by_cause":
            merged = dict(prior.get(key, {}))
            for cause, n in value.items():
                merged[cause] = merged.get(cause, 0) + n
            out[key] = merged
        elif key not in ("generation", "circuit_open"):
            out[key] = prior.get(key, 0) + value
    return out


def genesis(spec: dict, member: int) -> np.ndarray:
    """Member ``member``'s start grid: ``random_fill`` of its cells alive,
    drawn by numpy from ``rng_seed + member``."""
    rng = np.random.default_rng(int(spec.get("rng_seed", 0)) + member)
    return (rng.random(tuple(spec["shape"]))
            < spec.get("random_fill", 0.33)).astype(np.uint8)


def _build_coordinator(spec: dict, member: int, resume: bool):
    """(coordinator, resumed_generation) for one ensemble member."""
    from ..coordinator import GridCoordinator
    from ..utils import checkpoint as ckpt_lib

    rule, backend = FLAVORS[spec["flavor"]]
    device = spec.get("device", "cuda")
    ckpt = _checkpoint_path(Path(spec["workdir"]), member)
    if resume and ckpt.exists():
        engine = ckpt_lib.load_engine(ckpt, backend=backend, device=device)
        return GridCoordinator.from_engine(engine), engine.generation
    coordinator = GridCoordinator(
        tuple(spec["shape"]), rule, seed=genesis(spec, member),
        backend=backend, device=device)
    return coordinator, 0


def _run_member(spec: dict, member: int, resume: bool,
                health: dict, health_lock: threading.Lock,
                progress: dict, save_progress) -> dict:
    """One supervised member run; returns its report entry. ``progress``
    holds what earlier incarnations did; ``save_progress()`` writes it."""
    from ..obs import spans as obs_spans
    from ..resilience import faultplan as plan_lib
    from ..resilience.supervisor import RestartPolicy, Supervisor

    coordinator, resumed_gen = _build_coordinator(spec, member, resume)
    deadline = float(spec.get("watchdog_deadline", 6.0))
    stall_seconds = float(spec.get("stall_seconds", deadline * 1.5))
    # plan events target the worker, and the plan exercises member 0 of
    # an ensemble (members 1.. are the fault-free control group); events
    # an earlier incarnation consumed stay consumed
    mine = progress["members"].setdefault(
        str(member), {"consumed": [], "applied": [], "supervisor": {}})
    prior_stats = dict(mine["supervisor"])
    applied: List[dict] = mine["applied"]
    events = [(i, plan_lib.FaultEvent.from_dict(e))
              for i, e in enumerate(spec.get("events", []))] \
        if member == 0 else []
    events = [(i, e) for i, e in events
              if e.kind not in plan_lib.LAUNCHER_KINDS
              and i not in mine["consumed"]]

    supervisor = Supervisor(
        coordinator,
        checkpoint_path=str(_checkpoint_path(Path(spec["workdir"]), member)),
        checkpoint_every=int(spec.get("checkpoint_every", 40)),
        validators=(),
        policy=RestartPolicy(
            max_restarts=int(spec.get("max_restarts", 8)),
            backoff_initial_seconds=0.02, backoff_max_seconds=0.5),
    )

    # the launcher paces chunks so its kill events can land mid-run — a
    # CPU Life grid would otherwise finish between two healthz polls
    chunk_sleep = float(spec.get("chunk_sleep_seconds", 0.0))

    def before_chunk(gen: int) -> None:
        # the chunks before this boundary are done: faults applied at the
        # last one have had their restarts, stalls and dumps
        mine["supervisor"] = _add_stats(prior_stats, supervisor.stats())
        save_progress()
        due = [(i, e) for i, e in events if e.at_gen <= gen]
        for i, ev in due:
            events.remove((i, ev))
            kind = plan_lib.apply_fault(supervisor, ev,
                                        stall_seconds=stall_seconds)
            applied.append({"kind": kind, "scheduled": ev.kind,
                            "at_gen": ev.at_gen, "applied_at_gen": gen})
            mine["consumed"].append(i)
        with health_lock:
            health["generation"] = gen
            health["member"] = member
        if chunk_sleep > 0:
            time.sleep(chunk_sleep)

    supervisor.before_chunk = before_chunk
    with health_lock:
        health["supervisor"] = supervisor
    target = int(spec["generations"])
    # ambient trace (GOLTPU_TRACE from the soak launcher) makes this span
    # a child of the launcher's on the merged fleet timeline
    with obs_spans.span("soak.member", member=member,
                        flavor=spec["flavor"], target_gens=target):
        supervisor.run(max(0, target - coordinator.generation))
    mine["supervisor"] = stats = _add_stats(prior_stats, supervisor.stats())
    save_progress()
    return {
        "member": member,
        "resumed_generation": resumed_gen,
        "final_generation": coordinator.generation,
        "population": coordinator.population(),
        "faults_applied": list(applied),
        "supervisor": stats,
    }


def run_spec(spec: dict, *, resume: bool = False,
             announce=print) -> int:
    """The worker body; returns the process exit code."""
    from ..obs import exporter as obs_exporter
    from ..obs import flight as obs_flight
    from ..obs import watchdog as obs_watchdog
    from ..resilience.supervisor import CircuitOpenError

    workdir = Path(spec["workdir"])
    workdir.mkdir(parents=True, exist_ok=True)
    deadline = float(spec.get("watchdog_deadline", 6.0))

    health: dict = {"generation": 0, "member": 0, "done": False}
    health_lock = threading.Lock()

    def health_info() -> dict:
        with health_lock:
            sup = health.get("supervisor")
            out = {"generation": health["generation"],
                   "member": health["member"], "done": health["done"]}
        if sup is not None:
            out.update(sup.stats())
        return out

    wd = obs_watchdog.arm(obs_watchdog.StallWatchdog(deadline))
    # install() with the watchdog BEFORE arm(): arm's own install() is a
    # no-op on an installed recorder, and installing without the
    # watchdog would silently drop the dump-on-stall chain
    fr = obs_flight.FlightRecorder(str(workdir / "flight.jsonl"))
    fr.install(watchdog=wd)
    obs_flight.arm(fr)
    # a launcher SIGTERM is external: chain a tape note IN FRONT of the
    # recorder's dump-then-die handler (chain_signal_handler — never raw
    # signal.signal, which would silently drop the dump hook; the serve
    # loop follows the same rule). No lock in the note: the handler runs
    # on the main thread and must not wait on health_lock mid-signal.
    import signal as signal_lib

    unchain = obs_flight.chain_signal_handler(
        signal_lib.SIGTERM,
        lambda signum, frame: fr.note(
            "worker_sigterm", {"member": health.get("member", 0)}))
    server = obs_exporter.serve_metrics(
        int(spec.get("metrics_port", 0)),
        host=spec.get("metrics_host", "127.0.0.1"),
        health_info=health_info)
    announce(f"METRICS_PORT {server.port}", flush=True)

    # what earlier incarnations did (a --resume after a SIGKILL)
    progress_path = workdir / "progress.json"
    progress = (json.loads(progress_path.read_text())
                if resume and progress_path.exists() else {"members": {}})
    prior_stalls = int(progress.get("stalls_detected", 0))
    prior_dumps = int(progress.get("flight_dumps", 0))

    def save_progress() -> None:
        progress["stalls_detected"] = prior_stalls + len(wd.events_since(0))
        progress["flight_dumps"] = prior_dumps + fr.dumps
        tmp = workdir / f"progress.json.tmp{os.getpid()}"
        tmp.write_text(json.dumps(progress))
        os.replace(tmp, progress_path)

    members = (int(spec.get("ensemble_size", 2))
               if spec["flavor"] == "ensemble" else 1)
    report: dict = {"name": spec.get("name", "worker"),
                    "flavor": spec["flavor"], "resume": resume,
                    "pid": os.getpid(), "ok": False, "members": []}
    code = 0
    try:
        grids = []
        for m in range(members):
            entry = _run_member(spec, m, resume, health, health_lock,
                                progress, save_progress)
            report["members"].append(entry)
            grids.append(_final_grid(spec, m))
        final = grids[0] if members == 1 else np.stack(grids)
        np.save(workdir / "final.npy", final)
        report["ok"] = True
    except (CircuitOpenError, AssertionError) as exc:
        report["error"] = f"{type(exc).__name__}: {exc}"
        code = 2
    finally:
        with health_lock:
            health["done"] = True
        report["stalls_detected"] = prior_stalls + len(wd.events_since(0))
        report["flight_dumps"] = prior_dumps + fr.dumps
        report["last_dump_reason"] = fr.last_dump_reason
        tmp = workdir / f"report.json.tmp{os.getpid()}"
        tmp.write_text(json.dumps(report, indent=2))
        os.replace(tmp, workdir / "report.json")
        # always leave a tape (after the report so report["flight_dumps"]
        # still counts only in-run dumps): the launcher's merged timeline
        # needs spans from clean workers too
        fr.dump(f"end of run (exit code {code})")
        server.stop()
        unchain()
        obs_flight.disarm()
        obs_watchdog.disarm()
    return code


def _final_grid(spec: dict, member: int) -> np.ndarray:
    """Reload the member's final state from its own last checkpoint —
    the grid the launcher diffs is the one that survived the atomic-save
    discipline, which is exactly the recovery contract under test."""
    from ..utils import checkpoint as ckpt_lib

    grid, _meta = ckpt_lib.load_grid(
        _checkpoint_path(Path(spec["workdir"]), member))
    return grid


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="soak worker (one supervised coordinator process)")
    parser.add_argument("--spec", required=True,
                        help="path to the worker spec JSON")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the last checkpoint in workdir")
    args = parser.parse_args(argv)
    spec = json.loads(Path(args.spec).read_text())
    if spec.get("flavor") not in FLAVORS:
        sys.stderr.write(f"unknown flavor {spec.get('flavor')!r} "
                         f"(known: {sorted(FLAVORS)})\n")
        return 1
    return run_spec(spec, resume=args.resume)


if __name__ == "__main__":
    sys.exit(main())
