"""The measured roofline section of a RunReport of the port.

Counterpart of the repository's ``scripts/roofline_report.py``, which
renders the TPU worklist's trace capture: this one reads a RunReport the
port wrote (the CLI's or the bench's ``--telemetry-out`` with
``--profile-sample``) and renders, as markdown, what the profiler's
device tracks measured beside what ``obs/cost.py`` counts:

- device busy time over the profiled windows and the duty cycle (busy
  over the span of the card's work);
- the achieved rate of the run's best tick, and the in-kernel rate: that
  rate over the duty cycle (the rate were the card never idle), where the
  profiled device span is that tick's alone (no longer than its wall,
  within :data:`SPAN_SLACK`); else "not measured";
- the counted work per generation (operations, bytes) and the achieved
  shares of the card's integer-op peak and HBM rate;
- the top device slices by summed duration, and the longest idle gaps.

    python -m gameoflifewithactors_torch.bench.roofline_report REPORT.json
    python -m gameoflifewithactors_torch.bench.roofline_report REPORT.json --check

``--check`` prints nothing and exits 1 when the report has no device track
(a CPU run, or no profiler window), 0 when it has. Without ``--check`` the
section is printed whatever the report holds (exit 0), or exit 1 when the
file is not a readable RunReport. It touches no device.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional


#: the profiled device span may exceed the best tick's wall by this much
#: and still be that tick's alone (the span is measured on the device
#: clock, the wall on the host's)
SPAN_SLACK = 1.1


def has_device_track(report: dict) -> bool:
    prof = report.get("profile") or {}
    return (prof.get("source") == "device_tracks"
            and bool(prof.get("device_busy_seconds")))


def _fmt(v, spec: str = ".4g") -> str:
    return format(v, spec) if isinstance(v, (int, float)) else "not measured"


def render_roofline(report: dict, source: str = "the RunReport") -> str:
    """The markdown section of one RunReport (a dict as saved)."""
    platform = report.get("platform") or {}
    config = report.get("config") or {}
    prof = report.get("profile") or {}
    roof = report.get("roofline") or {}
    achieved = (roof.get("achieved") or {}).get("cell_updates_per_sec")
    rated = [m for m in report.get("step_metrics") or []
             if isinstance(m, dict) and m.get("cell_updates_per_sec")]
    wall = (max(rated, key=lambda m: m["cell_updates_per_sec"])
            .get("wall_seconds") if rated else None)
    card = platform.get("device_kind", platform.get("platform", "?"))
    limit = platform.get("power_limit")
    lines = [
        "## Measured roofline (device trace)",
        "",
        f"From {source} ({report.get('created_at', '?')}): "
        f"{config.get('rule', '?')} "
        f"{'x'.join(map(str, config.get('shape') or [])) or '?'} on "
        f"backend {config.get('backend', '?')}, {card}"
        + (f", {limit}" if limit else "") + ".",
        "",
    ]
    if has_device_track(report):
        busy = prof["device_busy_seconds"]
        duty = prof.get("device_duty_cycle")
        lines.append(
            f"- **Device busy**: {busy * 1e3:.3f} ms over "
            f"{prof.get('windows', 0)} profiler window(s)"
            + (f"; **duty cycle** {duty:.1%} of the span of the card's work"
               if duty else ""))
        span = busy / duty if duty else None
        if achieved and span and wall and span <= SPAN_SLACK * wall:
            lines.append(
                f"- **In-kernel rate**: {achieved / duty:.4e} cell-updates/s "
                f"(the best tick's {achieved:.4e} over the duty cycle)")
        elif achieved and span and wall:
            lines.append(
                f"- **In-kernel rate**: not measured (the profiled device "
                f"span, {span * 1e3:.3f} ms, is longer than the best tick's "
                f"{wall * 1e3:.3f} ms: the windows hold more than that tick)")
    else:
        lines.append(
            f"- **Device activity**: not measured (profile source "
            f"{prof.get('source')!r}: the report has no device track)")
        if achieved:
            lines.append(f"- **Achieved rate** (host clock, best tick): "
                         f"{achieved:.4e} cell-updates/s")
    ca = roof.get("cost_analysis") or {}
    if ca:
        lines.append(
            f"- **Counted work** (`obs/cost.py`): "
            f"{_fmt(ca.get('flops_per_gen'))} {ca.get('ops_kind', 'ops')} "
            f"operations and {_fmt(ca.get('bytes_per_gen'))} bytes per "
            "generation")
    frac = roof.get("achieved_fraction") or {}
    peaks = roof.get("peak_modelled") or {}
    if frac:
        lines.append(
            f"- **Achieved shares**: {_fmt(frac.get('of_int_op_peak'), '.4f')}"
            f" of the integer-op peak ({_fmt(peaks.get('int_ops_per_sec'))} "
            f"ops/s), {_fmt(frac.get('of_hbm_bandwidth'), '.4f')} of HBM "
            f"({_fmt(peaks.get('hbm_gbps'), '.1f')} GB/s)")
    elif roof:
        lines.append("- **Achieved shares**: not measured (no modelled "
                     "peak for this platform)")
    tops = prof.get("top_kernels") or []
    if tops and has_device_track(report):
        lines += ["", "Top device slices by summed duration:", ""]
        lines += [f"- `{name}` — {us / 1e3:.3f} ms" for name, us in tops[:6]]
        gaps = prof.get("idle_gaps_us") or []
        if gaps:
            lines.append("")
            lines.append("Longest idle gaps: " + ", ".join(
                f"{g:.1f} us" for g in gaps[:5]))
    return "\n".join(lines) + "\n"


def _load(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            rec = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    return rec if isinstance(rec, dict) and "step_metrics" in rec else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("report", help="a RunReport JSON of the port")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 (quietly) when the report has no device "
                         "track")
    args = ap.parse_args(argv)
    report = _load(args.report)
    if args.check:
        return 0 if report is not None and has_device_track(report) else 1
    if report is None:
        print(f"roofline_report: {args.report} is not a readable RunReport",
              file=sys.stderr)
        return 1
    print(render_roofline(report, args.report), end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
