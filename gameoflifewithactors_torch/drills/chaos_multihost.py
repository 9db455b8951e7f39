"""Multi-process chaos drill: SIGKILL, preemption, and checkpoint rot on a
live localhost fleet — recovery must be bit-exact.

    python -m gameoflifewithactors_torch.drills.chaos_multihost --seed 0

Counterpart of the JAX package's ``scripts/chaos_multihost.py``. Launches
an :class:`~..resilience.distributed.ElasticFleet` of N real OS processes
(one ``torch.distributed`` gloo group over localhost, positions on
``--device``, sharded v2 checkpoints) and executes a seeded
:class:`~..resilience.faultplan.FaultPlan` of the *launcher-level* fault
kinds. By default the fleet runs the width-k ghost-zone pipeline on a 2x2
mesh (``--mesh 2x2 --gens-per-exchange 4`` — one halo exchange per 4
generations); shrunk epochs deterministically re-tile via
``parallel.multihost.global_mesh_for_grid``. ``--mesh band
--gens-per-exchange 1`` runs lock-step row bands. The fault kinds:

- ``process_kill`` — SIGKILL a worker mid-run; every survivor must
  self-detect the dead peer (stale heartbeat / barrier deadline) and
  exit within the detection bound instead of wedging in a collective;
- ``process_preempt`` — SIGTERM a worker; it must finish its chunk,
  checkpoint, and exit with the distinct "preempted" status, and the
  fleet must re-form *smaller* (the mesh reshapes over n-1 processes);
- ``checkpoint_corrupt`` — flip bytes in a shard of the newest
  committed checkpoint generation (then kill its owner); the rebuilt
  fleet's restore must refuse the corrupt generation by CRC and fall
  back to the previous complete one.

After the fleet converges, the drill replays the same spec on a single
device (``ops.packed.multi_step_packed`` — no fleet, no faults) and
asserts the fleet's final grid is **bit-identical** to the oracle's:
elastic recovery is exact replay, not approximation. It also asserts the
paper trail: detection latency under the bound, a "preempted" status +
shrunk roster, a refused generation in some worker's restore record,
survivor flight dumps on disk, the launcher registry's recovery-latency
histogram populated, and one merged, clock-aligned timeline of every
tape (the launcher's ``launcher-flight.jsonl`` included).

Writes ``<out>/chaos_report.json`` (fleet report + oracle verdict +
per-check results); the last line is ``CHAOS-MULTIHOST-OK`` or
``CHAOS-MULTIHOST-FAILED``. Exit 0 = all green. Same ``--seed`` replays
the identical fault schedule. Without a card ``--device cuda`` (the
default) exits non-zero before a worker starts.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ..engine import resolve_device
from ..resilience.faultplan import FaultEvent, FaultPlan

LAUNCHER_FAULTS = ("process_kill", "process_preempt", "checkpoint_corrupt")


def build_events(seed: int, workers: int, horizon: int) -> List[FaultEvent]:
    """The drill's schedule: one event of each launcher kind, at seeded
    generations, targets clamped to workers 0/1 so every event stays
    addressable after the preemption shrinks the roster."""
    plan = FaultPlan.generate(
        seed, workers=2, horizon=horizon, faults_per_worker=0,
        kinds=LAUNCHER_FAULTS, ensure_kinds=LAUNCHER_FAULTS)
    assert workers >= 3, "drill needs >= 3 processes to survive a shrink"
    return list(plan.events)


def _parse_pair(text: str, what: str) -> tuple:
    try:
        a, b = text.lower().split("x")
        return int(a), int(b)
    except ValueError:
        raise SystemExit(f"--{what} wants AxB (e.g. 96x128), got {text!r}")


def oracle_grid(spec, device="cpu") -> np.ndarray:
    """The fleet's spec on one device, no fleet, no faults: the port's
    plain packed stepper from the same genesis grid, on ``device``."""
    from ..models.generations import parse_any
    from ..ops import bitpack
    from ..ops.packed import multi_step_packed
    from ..ops.stencil import Topology
    from ..resilience.distributed import initial_grid
    from ..utils.interop import state_from_numpy, state_to_numpy

    packed0 = state_from_numpy(bitpack.pack_np(initial_grid(spec)), device)
    words = multi_step_packed(packed0, spec.target_gens,
                              rule=parse_any(spec.rule),
                              topology=Topology(spec.topology))
    return bitpack.unpack_np(state_to_numpy(words))[:, :spec.shape[1]]


def run(out: Path, *, seed: int = 0, processes: int = 4,
        generations: int = 120, chunk: int = 20,
        shape: Tuple[int, int] = (96, 128),
        mesh_shape: Optional[Tuple[int, int]] = (2, 2),
        gens_per_exchange: int = 4, chunk_sleep: float = 0.3,
        heartbeat_deadline: float = 3.0, barrier_deadline: float = 15.0,
        device: str = "cuda") -> dict:
    """The drill; prints the plan and one line per verdict, writes
    ``chaos_report.json`` and returns it (``ok_with_oracle`` is the
    verdict). Raises RuntimeError at once when ``device`` is ``cuda`` and
    there is no card."""
    resolve_device(device)
    from ..obs import aggregate as obs_aggregate
    from ..obs import exporter as obs_exporter
    from ..obs import flight as obs_flight
    from ..obs.registry import REGISTRY
    from ..resilience.distributed import (EXIT_PREEMPTED, ElasticFleet,
                                          ElasticSpec)

    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    spec = ElasticSpec(
        shape=tuple(shape), target_gens=generations, chunk=chunk,
        rng_seed=seed,
        mesh_shape=None if mesh_shape is None else tuple(mesh_shape),
        gens_per_exchange=gens_per_exchange,
        chunk_sleep_seconds=chunk_sleep,
        heartbeat_deadline_seconds=heartbeat_deadline,
        barrier_deadline_seconds=barrier_deadline)
    events = build_events(seed, processes, generations)
    print(f"chaos plan (seed {seed}): "
          + ", ".join(f"{e.kind}@gen{e.at_gen}->w{e.worker}"
                      for e in events), flush=True)

    env = {**os.environ}
    env["GOLTPU_SANITIZE"] = env.get("GOLTPU_SANITIZE", "1")
    # launcher tape: armed before the fleet so _fire's kill/preempt/corrupt
    # events land on it and show up on the merged fleet timeline
    fr = obs_flight.FlightRecorder(str(out / "launcher-flight.jsonl"))
    fr.install(signals=False)
    obs_flight.arm(fr)
    try:
        fleet = ElasticFleet(out, spec, num_processes=processes, env=env,
                             device=device, backend="gloo")
        report = fleet.run(events)
        fr.dump("chaos launcher done")
    finally:
        obs_flight.disarm()
        fr.uninstall()

    # -- the oracle: same spec, one device, zero faults -----------------------
    oracle = oracle_grid(spec, device)

    checks: List[tuple] = []

    def check(name: str, ok: bool, detail: str = "") -> None:
        checks.append((name, bool(ok), detail))
        print(f"  {'PASS' if ok else 'FAIL'}  {name}"
              + (f"  ({detail})" if detail else ""), flush=True)

    print("chaos drill verdicts:", flush=True)
    check("fleet converged", report["ok"],
          f"{len(report['epochs'])} epochs")
    fired = {f["kind"] for f in report["faults_fired"]}
    check("all fault kinds fired", fired == set(LAUNCHER_FAULTS),
          f"fired: {sorted(fired)}")

    # detection: after every fault, all survivors exited in bounded time
    bound = (spec.heartbeat_deadline_seconds
             + spec.barrier_deadline_seconds + 20.0)
    detections = [(e["epoch"], e["detection_seconds"])
                  for e in report["epochs"] if "detection_seconds" in e]
    check("peer loss detected within deadline",
          len(detections) == len(report["faults_fired"])
          and all(d <= bound for _, d in detections),
          f"{detections} (bound {bound:.0f}s)")

    # preemption: distinct exit status, then a smaller fleet
    pre_epochs = [e for e in report["epochs"]
                  if EXIT_PREEMPTED in (e.get("exit_codes") or [])]
    shrank = any(
        later["num_processes"] < e["num_processes"]
        for e in pre_epochs
        for later in report["epochs"][e["epoch"] + 1:])
    check("preempted worker exited 17 and fleet re-formed smaller",
          bool(pre_epochs) and shrank,
          f"rosters: {[e['num_processes'] for e in report['epochs']]}")
    statuses = [s for e in report["epochs"]
                for s in (e.get("statuses") or []) if s]
    check("preempted status published",
          any(s["status"] == "preempted" for s in statuses))

    # checkpoint rot: some epoch's restore refused a generation by CRC
    refused = []
    for rec in sorted((out / "restore").glob("e*-p*.json")):
        for d, why in json.loads(rec.read_text()).get("skipped", []):
            refused.append((rec.name, d, why))
    check("corrupt generation refused at restore, older one used",
          any("CRC32" in why or "unreadable" in why
              for _rec, _d, why in refused),
          f"{len(refused)} refusals")

    # the 2D ghost-zone pipeline really was the compute core: some
    # epoch's restore records must show the requested mesh with the
    # ghost runner (shrunk epochs legitimately re-tile to other shapes)
    if mesh_shape is not None and gens_per_exchange > 1:
        recs = [json.loads(p.read_text())
                for p in sorted((out / "restore").glob("e*-p*.json"))]
        check("ghost pipeline ran on the requested 2D mesh",
              any(r.get("mesh") == list(mesh_shape)
                  and r.get("runner") == "ghost" for r in recs),
              f"meshes {sorted({tuple(r.get('mesh', [])) for r in recs})}")

    # paper trail: survivors dumped flight tapes; recovery latency landed
    dumps = list((out / "flight").glob("*.jsonl"))
    check("survivor flight dumps on disk", len(dumps) > 0,
          f"{len(dumps)} dumps")
    recov = report["registry"].get("elastic_recovery_seconds", {})
    n_recov = sum(s["n"] for s in recov.get("series", []))
    check("recovery latency histogram populated",
          n_recov >= len(report["faults_fired"]),
          f"{n_recov} observations")

    # -- the merged fleet timeline: ONE clock-aligned chrome trace ------------
    tapes = sorted((out / "flight").glob("*.jsonl"))
    tapes.append(out / "launcher-flight.jsonl")
    timeline_path = obs_aggregate.write_merged_timeline(
        str(out / "timeline.json"),
        flight_dumps=[str(p) for p in tapes if p.exists()])
    timeline = json.loads(Path(timeline_path).read_text())
    problems = obs_aggregate.validate_timeline(timeline)
    check("merged timeline clock-aligned", not problems
          and not timeline.get("unaligned"),
          f"{len(problems)} problems, "
          f"{len(timeline.get('unaligned', []))} unaligned")
    ranks = {int(lbl.rsplit("-p", 1)[1])
             for lbl in timeline.get("flight_headers", {}) if "-p" in lbl}
    check("timeline has tapes from every worker rank plus the launcher",
          ranks == set(range(processes))
          and "launcher-flight" in timeline.get("flight_headers", {}),
          f"ranks {sorted(ranks)}")
    span_tids = {ev.get("args", {}).get("trace_id")
                 for ev in timeline["traceEvents"]
                 if ev.get("ph") == "X"}
    check("worker and launcher spans share the fleet trace id",
          span_tids == {report["trace_id"]},
          f"{len(span_tids)} distinct trace ids in spans")
    fault_kinds = {(ev.get("args") or {}).get("fault")
                   for ev in timeline["traceEvents"]
                   if ev.get("name") == "launcher_fault"}
    check("kill/preempt/corrupt events visible on the timeline",
          set(LAUNCHER_FAULTS) <= fault_kinds,
          f"saw {sorted(k for k in fault_kinds if k)}")
    # aggregated launcher metrics, proc-labeled like a fleet scrape
    (out / "fleet_metrics.prom").write_text(
        obs_aggregate.merge_expositions(
            {"launcher": obs_exporter.render_prometheus(
                REGISTRY.snapshot())}))

    # the one that matters: bit-identical to the unfaulted oracle
    final_path = report.get("final_grid")
    if final_path:
        final = np.load(final_path)
        identical = final.shape == oracle.shape and (final == oracle).all()
        check("final grid bit-identical to single-device oracle", identical,
              f"popcount fleet={int(final.sum())} oracle={int(oracle.sum())}")
    else:
        check("final grid bit-identical to single-device oracle", False,
              "no final grid written")

    ok = all(c[1] for c in checks)
    report["oracle"] = {"checks": [
        {"name": n, "ok": o, "detail": d} for n, o, d in checks]}
    report["ok_with_oracle"] = ok
    tmp = out / f"chaos_report.json.tmp{os.getpid()}"
    tmp.write_text(json.dumps(report, indent=2))
    os.replace(tmp, out / "chaos_report.json")
    print(("CHAOS-MULTIHOST-OK" if ok else "CHAOS-MULTIHOST-FAILED")
          + f" report={out / 'chaos_report.json'}", flush=True)
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="chaos drill for the elastic multi-process runtime")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--processes", type=int, default=4)
    parser.add_argument("--generations", type=int, default=120)
    parser.add_argument("--chunk", type=int, default=20)
    parser.add_argument("--shape", default="96x128",
                        help="grid HxW (default 96x128: 4 packed word "
                        "columns, enough for a 2x2 mesh of ghost tiles)")
    parser.add_argument("--mesh", default="2x2",
                        help="device mesh NXxNY, or 'band' for "
                        "(n, 1) row bands")
    parser.add_argument("--gens-per-exchange", type=int, default=4,
                        help="halo exchange cadence k of the ghost-zone "
                        "pipeline; 1 = lock-step per-gen exchange")
    parser.add_argument("--chunk-sleep", type=float, default=0.3,
                        help="pacing so faults land mid-run")
    parser.add_argument("--heartbeat-deadline", type=float, default=3.0)
    parser.add_argument("--barrier-deadline", type=float, default=15.0)
    parser.add_argument("--out", default="chaos_out")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="where every worker's positions live "
                        "(default: the card)")
    args = parser.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as exc:
        print(f"chaos_multihost: {exc}", file=sys.stderr)
        return 2
    report = run(
        Path(args.out), seed=args.seed, processes=args.processes,
        generations=args.generations, chunk=args.chunk,
        shape=_parse_pair(args.shape, "shape"),
        mesh_shape=(None if args.mesh in ("band", "none")
                    else _parse_pair(args.mesh, "mesh")),
        gens_per_exchange=args.gens_per_exchange,
        chunk_sleep=args.chunk_sleep,
        heartbeat_deadline=args.heartbeat_deadline,
        barrier_deadline=args.barrier_deadline, device=args.device)
    return 0 if report["ok_with_oracle"] else 1


if __name__ == "__main__":
    sys.exit(main())
