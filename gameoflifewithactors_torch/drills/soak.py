"""Fleet soak: N supervised coordinator processes under a seeded fault plan.

    python -m gameoflifewithactors_torch.drills.soak --seed 0 --duration 60

Counterpart of the JAX package's ``scripts/soak.py``. Launches a mixed
fleet of worker subprocesses (``python -m
gameoflifewithactors_torch.resilience.worker`` — packed, dense, sparse,
LtL, ensemble specs) on ``--device``, an unfaulted *oracle* twin for
each, and executes a deterministic
:class:`~..resilience.faultplan.FaultPlan`: state corruption and drops
through the supervisor's detected-fault channel, induced stalls and
retraces, and launcher-side SIGKILL + ``--resume`` of live workers.
Throughout the run it scrapes each worker's ``/healthz`` (progress,
restart counts) and ``/metrics`` (obs/exporter.py).

At the end it asserts the invariants the obs + resilience stack
promises, and writes ``soak_report.json``:

- every worker (faulted and oracle) exits 0 with ``ok: true`` — no
  circuit opened, no unexplained post-warm retrace (RetraceSentinel),
  no transfer-guard raise (workers run under ``GOLTPU_SANITIZE=1``);
- the fleet injected the required fault-kind floor (state corruption,
  induced stall, worker SIGKILL);
- each faulted worker's final grid is bit-identical to its oracle's —
  recovery is exact, not approximate;
- every induced stall was detected by the watchdog and left a flight
  dump on disk;
- every killed worker resumed from its atomic checkpoint and still
  converged to the oracle grid;
- ``/metrics`` answered with ``goltpu_``-namespace content for every
  worker.

Beside it: ``fleet_metrics.prom`` (every process's last scrape, merged)
and ``timeline.json`` (every tape on one clock, the launcher's
``launcher-flight.jsonl`` included). Exit 0 = all green. Same ``--seed``
replays the identical fault schedule (the report embeds the plan JSON).
Without a card ``--device cuda`` (the default) exits non-zero before a
worker starts.
"""

from __future__ import annotations

import argparse
import json
import os
import select
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..engine import resolve_device
from ..obs import aggregate as obs_aggregate
from ..obs import flight as obs_flight
from ..obs import spans as obs_spans
from ..resilience.faultplan import LAUNCHER_KINDS, STATE_KINDS, FaultPlan

_REPO = str(Path(__file__).resolve().parents[2])

FLAVOR_ORDER = ("packed", "dense", "sparse", "ltl", "ensemble")
SHAPES = {"packed": (128, 128), "dense": (128, 128), "sparse": (128, 128),
          "ltl": (96, 96), "ensemble": (64, 64)}


def build_specs(args, out: Path, plan: FaultPlan,
                shapes: Optional[Dict[str, Tuple[int, int]]] = None
                ) -> List[dict]:
    shapes = SHAPES if shapes is None else shapes
    specs = []
    for w in range(args.processes):
        flavor = FLAVOR_ORDER[w % len(FLAVOR_ORDER)]
        specs.append({
            "name": f"w{w}-{flavor}",
            "flavor": flavor,
            "shape": list(shapes[flavor]),
            "rng_seed": args.seed * 1000 + w,
            "random_fill": 0.33,
            "generations": args.generations,
            "checkpoint_every": args.checkpoint_every,
            "watchdog_deadline": args.watchdog_deadline,
            "chunk_sleep_seconds": args.chunk_sleep,
            "workdir": str(out / f"w{w}"),
            "events": [e.to_dict() for e in plan.for_worker(w)
                       if e.kind not in LAUNCHER_KINDS],
            "device": args.device,
        })
    return specs


def build_plan(args) -> FaultPlan:
    """The seeded schedule. Kills target the first ``--kills``
    non-ensemble workers, so resume is exercised on a single-member
    checkpoint."""
    kill_targets = [w for w in range(args.processes)
                    if FLAVOR_ORDER[w % len(FLAVOR_ORDER)] != "ensemble"
                    ][:args.kills]
    return FaultPlan.generate(
        args.seed, workers=args.processes, horizon=args.generations,
        faults_per_worker=args.faults_per_worker,
        kinds=("corrupt_region", "drop_region", "drop_shard", "stall",
               "retrace"),
        ensure_kinds=("corrupt_region", "stall", "retrace"),
        kill_workers=kill_targets)


class WorkerProc:
    """One worker subprocess + its scrape state."""

    def __init__(self, spec_path: Path, workdir: Path, env: dict,
                 resume: bool = False):
        self.workdir = workdir
        self.log = open(workdir / "worker.log", "ab")
        cmd = [sys.executable, "-m",
               "gameoflifewithactors_torch.resilience.worker",
               "--spec", str(spec_path)]
        if resume:
            cmd.append("--resume")
        self.proc = subprocess.Popen(cmd, cwd=_REPO, env=env,
                                     stdout=subprocess.PIPE,
                                     stderr=self.log, text=True)
        self.port: Optional[int] = None
        self.resumed = resume
        self.last_health: dict = {}
        self.last_metrics: str = ""

    def read_port(self) -> int:
        """First stdout line is ``METRICS_PORT <port>`` (printed before
        any stepping, but after the torch import the subprocess pays)."""
        t0 = time.perf_counter()
        line = self.proc.stdout.readline()
        if not line.startswith("METRICS_PORT"):
            raise RuntimeError(
                f"worker announced {line!r} instead of METRICS_PORT "
                f"(after {time.perf_counter() - t0:.0f}s; log "
                f"{self.workdir / 'worker.log'})")
        self.port = int(line.split()[1])
        return self.port

    def poll_port(self) -> Optional[int]:
        """The announced port, read once the line is there (no wait): the
        launcher polls every process at once, so that none runs to its
        end unscraped while another is still importing torch."""
        if self.port is None and select.select([self.proc.stdout], [], [],
                                               0)[0]:
            self.read_port()
        return self.port

    def scrape(self) -> None:
        if self.port is None or self.proc.poll() is not None:
            return
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{self.port}/healthz",
                    timeout=2) as r:
                self.last_health = json.loads(r.read())
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{self.port}/metrics",
                    timeout=2) as r:
                self.last_metrics = r.read().decode("utf-8")
        except (OSError, ValueError):
            pass  # mid-restart or mid-kill; the next poll retries

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self.proc.stdout.close()
        self.log.close()


def run_fleet(args, out: Path, specs: List[dict], plan: FaultPlan,
              env: dict) -> dict:
    """Launch faulted workers + oracles, execute kills, wait, report."""
    deadline = time.perf_counter() + args.duration + args.grace
    kills = {e.worker: e for e in plan.events if e.kind == "kill"
             if specs[e.worker]["flavor"] != "ensemble"}
    killed: dict = {}

    workers: List[WorkerProc] = []
    oracles: List[WorkerProc] = []
    try:
        for spec in specs:
            wd = Path(spec["workdir"])
            wd.mkdir(parents=True, exist_ok=True)
            spec_path = wd / "spec.json"
            spec_path.write_text(json.dumps(spec, indent=2))
            workers.append(WorkerProc(spec_path, wd, env))
            # the oracle twin: identical spec, zero faults, no pacing
            ospec = dict(spec, events=[], chunk_sleep_seconds=0.0,
                         name=spec["name"] + "-oracle",
                         workdir=str(out / f"oracle-{spec['name']}"))
            owd = Path(ospec["workdir"])
            owd.mkdir(parents=True, exist_ok=True)
            ospec_path = owd / "spec.json"
            ospec_path.write_text(json.dumps(ospec, indent=2))
            oracles.append(WorkerProc(ospec_path, owd, env))

        # poll loop: read ports, scrape, time kills, resume killed workers
        while time.perf_counter() < deadline:
            alive = [p for p in workers + oracles if p.proc.poll() is None]
            if not alive:
                break
            for i, p in enumerate(workers):
                p.poll_port()
                p.scrape()
                ev = kills.get(i)
                if (ev is not None and i not in killed
                        and p.proc.poll() is None
                        and p.last_health.get("generation", 0) >= ev.at_gen):
                    os.kill(p.proc.pid, signal.SIGKILL)
                    p.proc.wait()
                    killed[i] = {"worker": i, "scheduled_at_gen": ev.at_gen,
                                 "killed_at_gen": p.last_health["generation"]}
                    obs_flight.note_event(
                        "launcher_kill",
                        {"worker": i,
                         "at_gen": p.last_health["generation"]})
                    print(f"soak: SIGKILL w{i} at generation "
                          f"{p.last_health['generation']} (scheduled "
                          f">= {ev.at_gen}); resuming", flush=True)
                    old = p
                    workers[i] = WorkerProc(
                        Path(specs[i]["workdir"]) / "spec.json",
                        Path(specs[i]["workdir"]), env, resume=True)
                    old.close()
            for p in oracles:
                p.poll_port()
                p.scrape()
            time.sleep(args.poll_seconds)
    except BaseException:
        for p in workers + oracles:
            p.close()
        raise

    results = {"workers": [], "oracles": [], "killed": list(killed.values())}
    # last scraped exposition per process, for the fleet-wide merged
    # metrics artifact (popped out of the report before it is written)
    results["expositions"] = dict(
        {f"w{i}": p.last_metrics for i, p in enumerate(workers)},
        **{f"oracle{i}": p.last_metrics for i, p in enumerate(oracles)})
    for kind, procs in (("workers", workers), ("oracles", oracles)):
        for p in procs:
            rc = p.proc.poll()
            if rc is None:
                p.proc.kill()
                rc = "timeout"
            report_path = p.workdir / "report.json"
            report = (json.loads(report_path.read_text())
                      if report_path.exists() else None)
            results[kind].append({
                "workdir": str(p.workdir), "exit_code": rc,
                "report": report, "last_health": p.last_health,
                "scraped_metrics": bool(p.last_metrics),
                "metrics_has_namespace": "goltpu_" in p.last_metrics,
            })
            p.close()
    return results


def check_invariants(args, results: dict, specs: List[dict],
                     plan: FaultPlan) -> List[str]:
    """Every failed invariant becomes one human-readable line."""
    failures: List[str] = []

    def report_of(entry) -> dict:
        return entry.get("report") or {}

    for kind in ("workers", "oracles"):
        for entry in results[kind]:
            r = report_of(entry)
            if entry["exit_code"] != 0 or not r.get("ok"):
                failures.append(
                    f"{entry['workdir']}: exit={entry['exit_code']} "
                    f"ok={r.get('ok')} error={r.get('error')}")

    # fault-kind floor: state corruption + stall from worker reports,
    # SIGKILL from the launcher's own accounting
    applied = [f for entry in results["workers"]
               for m in report_of(entry).get("members", [])
               for f in m.get("faults_applied", [])]
    applied_kinds = {f["kind"] for f in applied}
    if not applied_kinds & set(STATE_KINDS):
        failures.append(f"no state-corruption fault applied ({applied_kinds})")
    if "stall" not in applied_kinds:
        failures.append(f"no stall fault applied ({applied_kinds})")
    if plan_kills(plan, specs) and not results["killed"]:
        failures.append("kill was scheduled but never executed "
                        "(workers finished between polls?)")

    for i, (w, o) in enumerate(zip(results["workers"], results["oracles"])):
        wf = Path(w["workdir"]) / "final.npy"
        of = Path(o["workdir"]) / "final.npy"
        if not (wf.exists() and of.exists()):
            failures.append(f"w{i}: missing final grid "
                            f"({wf.exists()=} {of.exists()=})")
            continue
        if not np.array_equal(np.load(wf), np.load(of)):
            failures.append(
                f"w{i}: faulted-and-recovered final grid differs from "
                f"oracle ({specs[i]['flavor']})")

    for i, entry in enumerate(results["workers"]):
        r = report_of(entry)
        stalls_injected = sum(
            1 for m in r.get("members", [])
            for f in m.get("faults_applied", []) if f["kind"] == "stall")
        if stalls_injected:
            if r.get("stalls_detected", 0) < stalls_injected:
                failures.append(
                    f"w{i}: {stalls_injected} stalls injected but only "
                    f"{r.get('stalls_detected', 0)} detected")
            if not (Path(entry["workdir"]) / "flight.jsonl").exists():
                failures.append(f"w{i}: induced stall left no flight dump")
            elif r.get("flight_dumps", 0) < 1:
                failures.append(f"w{i}: flight recorder never dumped "
                                f"despite {stalls_injected} stalls")
        retraces = sum(
            1 for m in r.get("members", [])
            for f in m.get("faults_applied", []) if f["kind"] == "retrace")
        attributed = sum(m.get("supervisor", {}).get(
            "retraces_attributed", 0) for m in r.get("members", []))
        if retraces and attributed < retraces:
            failures.append(f"w{i}: {retraces} retraces injected, "
                            f"{attributed} attributed")
        if not entry["metrics_has_namespace"]:
            failures.append(f"w{i}: /metrics never served goltpu_ content")

    for k in results["killed"]:
        r = report_of(results["workers"][k["worker"]])
        if not r.get("resume"):
            failures.append(
                f"w{k['worker']}: killed but final report says it never "
                "resumed from checkpoint")
    return failures


def plan_kills(plan: FaultPlan, specs: List[dict]) -> List[int]:
    return [e.worker for e in plan.events if e.kind == "kill"
            and specs[e.worker]["flavor"] != "ensemble"]


def run(out: Path, *, seed: int = 0, duration: float = 60.0,
        processes: int = 3, generations: int = 240,
        checkpoint_every: int = 40, faults_per_worker: int = 2,
        kills: int = 1, watchdog_deadline: float = 6.0,
        chunk_sleep: float = 0.3, poll_seconds: float = 0.1,
        grace: float = 120.0, device: str = "cuda",
        shapes: Optional[Dict[str, Tuple[int, int]]] = None) -> dict:
    """The drill; prints its plan and verdict lines and returns the
    report written to ``soak_report.json``. Raises RuntimeError at once
    when ``device`` is ``cuda`` and there is no card."""
    resolve_device(device)
    args = argparse.Namespace(
        seed=seed, duration=duration, processes=processes,
        generations=generations, checkpoint_every=checkpoint_every,
        faults_per_worker=faults_per_worker, kills=kills,
        watchdog_deadline=watchdog_deadline, chunk_sleep=chunk_sleep,
        poll_seconds=poll_seconds, grace=grace, device=device)
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)

    plan = build_plan(args)
    (out / "faultplan.json").write_text(plan.to_json())
    print(f"soak: seed={args.seed} processes={args.processes} "
          f"plan kinds={plan.kinds()} "
          f"({len(plan.events)} events)", flush=True)

    specs = build_specs(args, out, plan, shapes)
    env = dict(os.environ, GOLTPU_SANITIZE="1",
               GOLTPU_CACHE_DIR=os.environ.get(
                   "GOLTPU_CACHE_DIR",
                   os.path.join(_REPO, ".goltpu_cache")))

    # fleet trace: workers inherit the launcher's trace id + span id via
    # GOLTPU_TRACE, so their spans nest under the launcher on the merged
    # timeline; the launcher tapes its own kills into launcher-flight.jsonl
    ctx = obs_spans.TraceContext(obs_spans.new_trace_id(),
                                 obs_spans.new_span_id())
    previous_ctx = obs_spans.set_process_context(ctx)
    env.update(ctx.child_env())
    fr = obs_flight.FlightRecorder(str(out / "launcher-flight.jsonl"))
    fr.install(signals=False)
    obs_flight.arm(fr)

    t0 = time.perf_counter()
    try:
        with obs_spans.span("soak.fleet", seed=args.seed,
                            processes=args.processes):
            results = run_fleet(args, out, specs, plan, env)
        wall = time.perf_counter() - t0
        failures = check_invariants(args, results, specs, plan)

        expositions = results.pop("expositions", {})
        live = {k: v for k, v in expositions.items() if v}
        if live:
            (out / "fleet_metrics.prom").write_text(
                obs_aggregate.merge_expositions(live))
        fr.dump(f"soak launcher done (failures={len(failures)})")
    finally:
        obs_flight.disarm()
        fr.uninstall()
        obs_spans.set_process_context(previous_ctx)
    dumps = sorted(out.glob("*/flight.jsonl"))
    dumps.append(out / "launcher-flight.jsonl")
    dumps = [p for p in dumps if p.exists()]
    obs_aggregate.write_merged_timeline(
        str(out / "timeline.json"),
        flight_dumps=[str(p) for p in dumps],
        labels={str(p): (p.parent.name if p.name == "flight.jsonl"
                         else "launcher") for p in dumps})

    report = {
        "seed": args.seed,
        "trace_id": ctx.trace_id,
        "timeline": str(out / "timeline.json"),
        "fleet_metrics": (str(out / "fleet_metrics.prom")
                          if live else None),
        "plan": json.loads(plan.to_json()),
        "wall_seconds": round(wall, 2),
        "results": results,
        "invariant_failures": failures,
        "ok": not failures,
    }
    (out / "soak_report.json").write_text(json.dumps(report, indent=2))
    if failures:
        print(f"soak: FAILED after {wall:.1f}s "
              f"({len(failures)} invariant failures):", flush=True)
        for f in failures:
            print(f"  - {f}", flush=True)
        return report
    print(f"soak: OK in {wall:.1f}s — {args.processes} workers, "
          f"{len(plan.events)} scheduled faults "
          f"({', '.join(plan.kinds())}), {len(results['killed'])} "
          "kill/resume cycles, all grids bit-identical to oracle",
          flush=True)
    return report


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="fleet soak under a deterministic fault plan")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--duration", type=float, default=60.0,
                        help="soft wall-clock budget (seconds); workers "
                        "exceeding it + grace are killed and failed")
    parser.add_argument("--processes", type=int, default=3)
    parser.add_argument("--generations", type=int, default=240)
    parser.add_argument("--checkpoint-every", type=int, default=40)
    parser.add_argument("--faults-per-worker", type=int, default=2)
    parser.add_argument("--kills", type=int, default=1)
    parser.add_argument("--watchdog-deadline", type=float, default=6.0)
    parser.add_argument("--chunk-sleep", type=float, default=0.3)
    parser.add_argument("--poll-seconds", type=float, default=0.1)
    parser.add_argument("--grace", type=float, default=120.0,
                        help="extra seconds past --duration before the "
                        "launcher declares a hang")
    parser.add_argument("--out", default=None,
                        help="output dir (default: ./soak_out)")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="where every worker steps (default: the card)")
    args = parser.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as exc:
        print(f"soak: {exc}", file=sys.stderr)
        return 2
    params = vars(args)
    out = Path(params.pop("out") or os.path.join(_REPO, "soak_out"))
    return 0 if run(out, **params)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
