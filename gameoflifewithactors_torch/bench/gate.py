"""The perf gate: a fresh record against a baseline, exit 1 on regression.

Counterpart of the repository's ``scripts/perf_gate.py``, over the
port's differ (``obs/diff.py``) and provenance (``utils/provenance.py``),
with its flags, output and exit codes. Either side may be a RunReport
(``--telemetry-out``) or a bench record (the bench's last line, a store
entry, a weak-scaling ``--out`` record; a ``{"parsed": {...}}`` wrapper
is unwrapped). A record flagged ``needs_recapture``/``stale``, or whose
stamped measured paths changed since its commit, gates as
**"skipped (stale)"**, never "ok". With a profiler section on both sides,
a regression adds the op-class blame (advisory).

    python -m gameoflifewithactors_torch.bench.gate BASELINE.json CURRENT.json
    python -m gameoflifewithactors_torch.bench.gate base.json run.json --tolerance 0.4 --tol phase/=1.0

Exit codes: 0 = ok or skipped (stale), 1 = regression, 2 = unusable
input. ``--informational`` always exits 0 but prints the real verdict.
It touches no device.
"""

from __future__ import annotations

import argparse
import json
import sys


def load_record(path: str) -> dict:
    with open(path) as f:
        rec = json.load(f)
    if not isinstance(rec, dict):
        raise SystemExit(f"{path}: expected a JSON object, got "
                         f"{type(rec).__name__}")
    if "metric" not in rec and isinstance(rec.get("parsed"), dict):
        rec = rec["parsed"]
    return rec


def main(argv=None) -> int:
    from ..obs import diff as diff_lib
    from ..utils import provenance

    ap = argparse.ArgumentParser(
        description=__doc__.split("\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("baseline", help="baseline JSON (RunReport or bench "
                                     "record)")
    ap.add_argument("current", help="fresh artifact to check")
    ap.add_argument("--tolerance", type=float, default=None, metavar="F",
                    help="default relative tolerance band (e.g. 0.3 = "
                         "±30%%); per-metric defaults in obs/diff.py")
    ap.add_argument("--tol", action="append", default=[],
                    metavar="METRIC_PREFIX=F",
                    help="per-metric tolerance override (repeatable), "
                         "e.g. --tol phase/=1.0")
    ap.add_argument("--informational", action="store_true",
                    help="report but never block: exit 0 even on "
                         "regression")
    ap.add_argument("--json", action="store_true",
                    help="emit the verdict + rows as one JSON object")
    args = ap.parse_args(argv)

    overrides = {}
    for item in args.tol:
        if "=" not in item:
            ap.error(f"--tol wants METRIC_PREFIX=F, got {item!r}")
        k, v = item.split("=", 1)
        overrides[k] = float(v)

    try:
        baseline = load_record(args.baseline)
        current = load_record(args.current)
    except (OSError, json.JSONDecodeError) as exc:
        print(f"perf gate: unusable input — {exc}", file=sys.stderr)
        return 2

    kw = {"tolerances": overrides, "provenance": provenance}
    if args.tolerance is not None:
        kw["default_tolerance"] = args.tolerance
    verdict = diff_lib.gate(baseline, current, **kw)

    status = verdict["status"]
    label = {"ok": "ok", "regression": "REGRESSION",
             "skipped": "skipped (stale)"}.get(status, status)
    if args.json:
        print(json.dumps({
            "perf_gate": True, "status": status, "label": label,
            "informational": args.informational,
            "reason": verdict["reason"],
            "baseline": args.baseline, "current": args.current,
            "rows": [r.to_dict() for r in verdict["rows"]],
            "blame": verdict.get("blame", []),
        }, indent=1))
    else:
        if verdict["rows"]:
            print("\n".join(diff_lib.format_rows(verdict["rows"])))
        if verdict.get("blame") and status == "regression":
            print("\n".join(diff_lib.format_blame(verdict["blame"])))
        print(f"perf gate: {label} — {verdict['reason']}")
    if status == "regression" and not args.informational:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
