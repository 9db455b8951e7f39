"""Runs one cell of the benchmark once and prints its result line.

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. ``BENCHMARK.json`` names the cell's
configuration and traffic mix; the traffic file's ``driver`` (``batch`` or
``sessions``, :mod:`.drivers`) sets up the program on the cell's cards,
warms what the cell runs, measures for ``--seconds``, and checks what the
timed path produced against the plain reference (:mod:`.check`). Kernel
builds are cached in ``benchmark/_cache`` inside the checkout.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, each read
by ``metrics/<name>.py``), ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``: each number compared, with its limit. The checks are
also the last lines of standard error.

Without CUDA, with fewer cards than the cell asks for, or when JAX or the
JAX package is loaded once the window has closed, it prints no result and
exits non-zero.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()   # set-up is timed from here

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import List  # noqa: E402

from . import manifest  # noqa: E402

CACHE_DIR = os.path.join(manifest.BENCH_DIR, "_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "gameoflifewithactors_tpu")


@dataclasses.dataclass
class RunSpec:
    """What a driver needs to run one cell once."""

    cell: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    devices: List
    t_process: float = T_PROCESS

    def note(self, message: str) -> None:
        print(f"benchmark: {message}", file=sys.stderr, flush=True)


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> List[str]:
    """The JAX modules, or the JAX package, this process holds, by whole
    top-level name."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def pin_cache(path: str = CACHE_DIR) -> None:
    """Build and load every kernel under ``path``, whatever the
    environment says."""
    from gameoflifewithactors_torch.aot import cache

    cache.ensure_persistent_cache(path)


def drive(spec: RunSpec) -> dict:
    driver = importlib.import_module(
        f"{__package__}.drivers.{spec.traffic['driver']}")
    return driver.run(spec)


def result_line(bench: dict, spec: RunSpec, out: dict, device: dict) -> dict:
    """The result line of a run: the cell's metrics read from the run's
    context, each metric's reading noted on standard error."""
    ctx = dict(out["ctx"], traffic=spec.traffic, config=spec.config,
               cell=spec.cell, peaks=out.get("peaks"))
    metrics = {}
    for m in manifest.cell_metrics(bench, spec.cell, spec.trace):
        got = manifest.read_metric(m["name"], ctx)
        if got is None:
            spec.note(f"metric {m['name']}: nothing to read")
            continue
        value, how = got
        spec.note(f"metric {m['name']} = {value!r} {m['unit']} ({how})")
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {name: {"value": value, "limit": limit}
              for name, (value, limit) in out["checks"].items()}
    line = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
            "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device}
    if spec.trace and out.get("trace") is not None:
        line["breakdown"] = out["trace"]["breakdown"]
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    args = parse(argv)
    bench = manifest.load()
    cell = manifest.workload(bench, args.workload)
    config = manifest.config(bench, cell["config"])
    traffic = manifest.traffic(cell["traffic"])

    t_import = time.perf_counter()
    import torch

    t_torch = time.perf_counter()
    if not torch.cuda.is_available():
        print("benchmark: no CUDA device; no result", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible; no result",
              file=sys.stderr)
        return 2
    t_cuda = time.perf_counter()
    pin_cache()
    from .yardstick import peaks, timing

    devices = [torch.device("cuda", i) for i in range(cell["chips"])]
    spec = RunSpec(cell=args.workload, config=config, traffic=traffic,
                   seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace), devices=devices)
    t_driver = time.perf_counter()
    out = drive(spec)
    phases = ", ".join(
        f"{name} {v['seconds']:.3f} s"
        for name, v in out["ctx"]["setup_spans"].items()
        if name.startswith("benchmark."))
    spec.note(f"set-up {out['ctx']['setup_s']:.3f} s: the arguments and "
              f"the manifest {t_import - T_PROCESS:.3f} s, import torch "
              f"{t_torch - t_import:.3f} s, CUDA {t_cuda - t_torch:.3f} s, "
              f"the port and its kernel cache {t_driver - t_cuda:.3f} s, then "
              f"{phases}")
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the process holds {', '.join(bad)}; no result",
              file=sys.stderr)
        return 3
    card = timing.card(0)
    spec.note(f"card {card['name']}, power limit {card['power_limit']}, "
              f"{len(devices)} used")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": len(devices),
              "memory_peak_bytes": out["memory_peak_bytes"]}
    if spec.trace:
        out["peaks"] = peaks.gpu_peaks(0)
        spec.note(f"peaks {out['peaks']}")
        if out.get("trace") is None:
            print("benchmark: the traced window holds no trace; no result",
                  file=sys.stderr)
            return 4
        trace = out["trace"]
        spec.note(f"traced slice {trace['attempt']}: "
                  f"{trace['counters']['launches']} launches counted, "
                  f"{ {n: k['count'] for n, k in trace['kernels'].items()} } "
                  f"recorded; "
                  f"{'whole' if trace['whole'] else 'not whole'}")
        device["busy_s"] = trace["busy_s"]
        device["window_s"] = trace["window_s"]
    line = result_line(bench, spec, out, device)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
