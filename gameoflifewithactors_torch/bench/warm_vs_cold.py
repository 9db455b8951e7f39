"""Warm start: a cold and a warm process per spec against one cache root.

Counterpart of the repository's ``scripts/warm_vs_cold.py``. For each
spec the same engine build, stepping of both runner signatures and sync
runs in a fresh process twice against one kernel build cache root
(``GOLTPU_CACHE_DIR``, the port's ``aot/``). On the card the cold process
pays ``nvcc`` for the kernel specs (``cache_miss`` events) and writes
``<root>/cuda``; the warm one loads those libraries and, for the plain
``packed`` spec, serves its runner from the registry record the cold one
wrote in ``<root>/torch_aot`` (``aot_loaded``). On the CPU the specs are
the repository script's three plain ones. A last warm run with
``GOLTPU_AOT=0`` keeps layer 1 alone; its RunReport is kept beside the
record.

:func:`first_step` is the CLI's time to first step (spawn to the end of
its first tick) that ``chip_smoke.py``'s warm start phase runs cold and
warm in turns.

    python -m gameoflifewithactors_torch.bench.warm_vs_cold --device cuda
    python -m gameoflifewithactors_torch.bench.warm_vs_cold --device cpu --keep-cache /tmp/w --out /tmp/w.json
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Optional

from ..utils import provenance
from . import timing
from .run import PACKAGE

_REPO = provenance.repo_root()
# the repository script's three specs: the binary packed path, the
# Generations bit-plane stack, the bit-sliced binary LtL path
PLAIN_SPECS = [
    {"name": "binary-packed",
     "spec": {"rule": "B3/S23", "shape": [512, 512], "backend": "packed"}},
    {"name": "generations-planes (brain)",
     "spec": {"rule": "brain", "shape": [512, 512], "backend": "packed"}},
    {"name": "ltl-bit-sliced (R2 box)",
     "spec": {"rule": "R2,C0,M1,S2..6,B3..5,NM", "shape": [512, 512],
              "backend": "packed"}},
]
# on the card: the same three rules on their kernels (B1, B3, B4: the cold
# process builds each), then the packed spec (a registry record)
KERNEL_SPECS = [
    {"name": f"{kernel} kernel ({s['spec']['rule']})",
     "spec": {**s["spec"], "backend": "cuda"}}
    for kernel, s in zip(("B1", "B3", "B4"), PLAIN_SPECS)]
CHILD_TIMEOUT_S = float(os.environ.get("WARMSTART_CHILD_TIMEOUT_S", "600"))


def specs_for(device: str) -> list:
    return KERNEL_SPECS + PLAIN_SPECS[:1] if device == "cuda" \
        else PLAIN_SPECS


def child(spec_json: str, device: str, report_out: Optional[str]) -> None:
    """One measured process: build the spec's engine under the cache root
    of the environment, step both runner signatures, sync, write the
    registry record, and print wall seconds and the compile attribution
    as one JSON line."""
    from ..aot import EngineSpec, serialize_engine
    from ..aot import cache as aot_cache
    from ..aot import registry as aot_registry
    from ..obs import COMPILE_LOG

    aot_cache.ensure_persistent_cache()
    spec = EngineSpec.from_dict(json.loads(spec_json))
    t0 = time.perf_counter()
    engine = spec.build_engine(device=device)
    engine.step(1)
    engine.step(max(2, engine.gens_per_exchange + 1))
    engine.block_until_ready()
    wall = time.perf_counter() - t0
    try:
        serialize_engine(engine)
    except aot_registry.AotUnsupported:
        pass
    kinds: dict = {}
    for e in COMPILE_LOG.events():
        kinds[e.kind] = kinds.get(e.kind, 0) + 1
    if report_out:
        from ..obs.report import build_run_report

        build_run_report(
            engine=engine,
            config={"warm_vs_cold": True, "spec": spec.canonical()},
        ).save(report_out)
    print(json.dumps({
        "wall_seconds": wall,
        "compile_seconds": COMPILE_LOG.total_compile_seconds(),
        "events": kinds,
        "aot_loaded": engine.aot_loaded,
        "backend": engine.backend,
    }))


def run_child(spec: dict, cache_dir: str, report_out: Optional[str],
              device: str, aot: bool = True) -> dict:
    """One child process against ``cache_dir``; its JSON line."""
    env = {**os.environ, "GOLTPU_CACHE_DIR": cache_dir,
           "GOLTPU_AOT": "1" if aot else "0"}
    cmd = [sys.executable, "-m", "gameoflifewithactors_torch.bench."
           "warm_vs_cold", "--run-child", json.dumps(spec), "--device",
           device]
    if report_out:
        cmd += ["--report-out", report_out]
    r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                       cwd=_REPO, timeout=CHILD_TIMEOUT_S)
    if r.returncode != 0:
        sys.stderr.write(r.stderr)
        raise RuntimeError(f"warm_vs_cold child failed (rc={r.returncode})")
    return json.loads(r.stdout.strip().splitlines()[-1])


def first_step(cli_args, root: str, report: str, *, cwd: str = _REPO,
               timeout: float = 300.0):
    """The CLI's time to first step: ``python -m
    gameoflifewithactors_torch CLI_ARGS --metrics jsonl --cache-dir ROOT
    --telemetry-out REPORT`` from spawn to its first metrics record (the
    end of its first tick). Returns ``(seconds, compile event kinds,
    nvcc seconds)`` from the run's RunReport; raises when the CLI fails."""
    from ..obs.report import RunReport

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "gameoflifewithactors_torch", *cli_args,
         "--metrics", "jsonl", "--cache-dir", root, "--telemetry-out",
         report],
        cwd=cwd, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    first, lines = None, []
    for line in proc.stderr:   # the tick's metrics record ends the tick
        if first is None and line.startswith("{"):
            first = time.perf_counter() - t0
        lines.append(line)
    rc = proc.wait(timeout=timeout)
    if rc != 0 or first is None:
        raise RuntimeError(f"CLI on {root} exited {rc}: {''.join(lines)}")
    rep = RunReport.load(report)
    kinds: dict = {}
    for ev in rep.compile_events:
        kinds[ev["kind"]] = kinds.get(ev["kind"], 0) + 1
    return first, kinds, rep.compile_seconds_total


def run(device: str, cache_dir: str, warm_report: str) -> dict:
    """The cold and warm pair of every spec of ``device``, then the
    layer-1-only warm run; returns the record (without provenance)."""
    rows = []
    for item in specs_for(device):
        name, spec = item["name"], item["spec"]
        sys.stderr.write(f"[cold] {name} ...\n")
        cold = run_child(spec, cache_dir, None, device)
        sys.stderr.write(
            f"    {cold['wall_seconds']:.2f}s "
            f"({cold['compile_seconds']:.2f}s compiling)\n[warm] {name} ...\n")
        warm = run_child(spec, cache_dir, None, device)
        sys.stderr.write(
            f"    {warm['wall_seconds']:.2f}s "
            f"({warm['compile_seconds']:.2f}s compiling), events "
            f"{warm['events']}, aot_loaded={warm['aot_loaded']}\n")
        rows.append({
            "name": name, "spec": spec,
            "resolved_backend": cold["backend"],
            "cold_wall_seconds": cold["wall_seconds"],
            "cold_compile_seconds": cold["compile_seconds"],
            "cold_events": cold["events"],
            "warm_wall_seconds": warm["wall_seconds"],
            "warm_compile_seconds": warm["compile_seconds"],
            "warm_events": warm["events"],
            "warm_aot_loaded": warm["aot_loaded"],
            "warm_over_cold": warm["wall_seconds"] / cold["wall_seconds"],
        })
    plain = PLAIN_SPECS[0]["spec"]
    sys.stderr.write(f"[warm, GOLTPU_AOT=0] {PLAIN_SPECS[0]['name']} ...\n")
    layer1 = run_child(plain, cache_dir, warm_report, device, aot=False)
    total_cold = sum(r["cold_wall_seconds"] for r in rows)
    total_warm = sum(r["warm_wall_seconds"] for r in rows)
    return {
        "metric": f"warm-start: warm-process / cold-process wall time, "
                  f"{len(rows)} representative specs ({device})",
        "value": total_warm / total_cold,
        "unit": "warm/cold wall ratio",
        "ok": total_warm <= 0.5 * total_cold,
        "target": "<= 0.5",
        "total_cold_seconds": total_cold,
        "total_warm_seconds": total_warm,
        "specs": rows,
        "layer1_only_warm": {
            "spec": plain,
            "wall_seconds": layer1["wall_seconds"],
            "compile_seconds": layer1["compile_seconds"],
            "events": layer1["events"],
        },
        "warm_report": warm_report,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--run-child", metavar="SPEC_JSON", default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--report-out", metavar="PATH", default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--keep-cache", metavar="DIR", default=None,
                    help="use (and keep) this cache root instead of a "
                         "throwaway temporary one")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", metavar="PATH", default=None,
                    help="the record (default "
                         "results/warmstart_torch_<device>.json); the warm "
                         "run's RunReport goes beside it")
    args = ap.parse_args(argv)
    if args.run_child:
        child(args.run_child, args.device, args.report_out)
        return 0

    from ..engine import resolve_device

    try:
        dev = resolve_device(args.device)
    except RuntimeError as exc:
        print(f"warm_vs_cold: {exc}", file=sys.stderr)
        return 2
    out = args.out or os.path.join(
        _REPO, "results", f"warmstart_torch_{args.device}.json")
    warm_report = (out[:-5] if out.endswith(".json") else out) \
        + ".warm_report.json"
    cache_dir = args.keep_cache or tempfile.mkdtemp(prefix="goltpu-wvc-")
    try:
        record = run(args.device, cache_dir, warm_report)
    finally:
        if not args.keep_cache:
            shutil.rmtree(cache_dir, ignore_errors=True)
    pkg = PACKAGE
    record.update({
        "device": timing.card(dev), "package": PACKAGE,
        "recorded_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        **provenance.head_stamp(paths=[
            f"{pkg}/aot", f"{pkg}/ops", f"{pkg}/csrc", f"{pkg}/_build.py",
            f"{pkg}/engine.py", f"{pkg}/obs/compile.py",
            f"{pkg}/bench/warm_vs_cold.py"]),
    })
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(json.dumps({k: record[k] for k in ("metric", "value", "unit",
                                             "ok")}))
    sys.stderr.write(f"written: {out}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
