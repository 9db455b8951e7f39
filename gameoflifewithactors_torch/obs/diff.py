"""RunReport / bench-record differ: per-metric deltas with tolerance bands.

A copy of ``gameoflifewithactors_tpu.obs.diff`` (stdlib only), so the
two packages diff the same records into the same rows. This module is
the comparator under the ``report --diff`` CLI: it extracts a flat
metric dict from either artifact shape (a RunReport or a bench record),
diffs two of them with per-metric relative tolerance bands, and
classifies each row ``ok`` / ``regression`` / ``improved`` / ``missing``.

Provenance gating: a record flagged ``needs_recapture`` / ``stale`` --
or whose commit-stamped provenance ``staleness()`` (``utils.provenance``)
refuses to certify -- can pass the gate only as **"skipped"**, never as
"ok": comparing against numbers that describe a predecessor of HEAD's
kernel proves nothing either way. Stdlib only (the gate must run while
the device is wedged).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

HIGHER = "higher_is_better"
LOWER = "lower_is_better"

# relative tolerance per metric-name prefix (first match wins; the
# longest prefixes first). Host-side phase timings are noisy — loose
# bands; the headline rates are the contract — tighter bands.
DEFAULT_TOLERANCES = (
    ("bench/value", 0.20),
    ("scaling/single_chip_equivalent_updates_per_sec", 0.25),
    ("step/best_cell_updates_per_sec", 0.25),
    ("step/seconds_per_gen", 0.35),
    ("compile/", 2.0),     # cache state dominates; only gross blowups gate
    ("phase/", 0.60),
    ("stalls/", 0.0),      # any new stall is a regression
)
DEFAULT_TOLERANCE = 0.30

# absolute floors for lower-is-better timing metrics: when BOTH sides
# sit under the floor the delta is scheduler noise (a 5 µs -> 30 µs sync
# is not a regression anyone can act on), so the row reports "ok" with
# the ratio still visible
DEFAULT_FLOORS = (
    ("phase/", 5e-3),
    ("compile/", 0.5),
    ("step/seconds_per_gen", 0.0),
)


def tolerance_for(metric: str, overrides: Optional[dict] = None,
                  default: float = DEFAULT_TOLERANCE) -> float:
    for prefix, tol in tuple((overrides or {}).items()) + DEFAULT_TOLERANCES:
        if metric.startswith(prefix):
            return float(tol)
    return default


def floor_for(metric: str) -> float:
    for prefix, floor in DEFAULT_FLOORS:
        if metric.startswith(prefix):
            return floor
    return 0.0


def extract_metrics(record: dict) -> Dict[str, dict]:
    """Flatten either artifact shape into {name: {value, direction}}.

    Bench records (``{"metric", "value", ...}``) yield one headline row;
    RunReports yield step rates, compile totals, per-phase means, and the
    stall count. Unknown shapes yield {} (the caller reports "nothing
    comparable" instead of crashing on a future schema).
    """
    out: Dict[str, dict] = {}
    if not isinstance(record, dict):
        return out
    if "value" in record and "metric" in record:  # a bench record
        if isinstance(record["value"], (int, float)):
            out["bench/value"] = {"value": float(record["value"]),
                                  "direction": HIGHER,
                                  "label": record["metric"]}
        # weak-scaling COST records (scripts/weak_scaling.py --out) ride
        # the bench shape plus the per-chip-equivalent headline: the
        # fleet's rate per device, in single-chip-bench units, at the
        # largest device count measured
        sceq = record.get("single_chip_equivalent_updates_per_sec")
        if isinstance(sceq, (int, float)):
            out["scaling/single_chip_equivalent_updates_per_sec"] = {
                "value": float(sceq), "direction": HIGHER,
                "label": "per-chip-equivalent updates/sec"}
        return out
    steps = record.get("step_metrics") or []
    rates = [m.get("cell_updates_per_sec") for m in steps
             if isinstance(m, dict) and m.get("cell_updates_per_sec")]
    if rates:
        out["step/best_cell_updates_per_sec"] = {
            "value": max(rates), "direction": HIGHER}
    walls = sum(m.get("wall_seconds", 0.0) for m in steps
                if isinstance(m, dict))
    gens = sum(m.get("generations_stepped", 0) for m in steps
               if isinstance(m, dict))
    if gens:
        out["step/seconds_per_gen"] = {"value": walls / gens,
                                       "direction": LOWER}
    if isinstance(record.get("compile_seconds_total"), (int, float)):
        out["compile/seconds_total"] = {
            "value": float(record["compile_seconds_total"]),
            "direction": LOWER}
    for name, rec in (record.get("phase_seconds") or {}).items():
        if isinstance(rec, dict) and isinstance(rec.get("mean_s"),
                                                (int, float)):
            out[f"phase/{name}/mean_s"] = {"value": float(rec["mean_s"]),
                                           "direction": LOWER}
    if isinstance(record.get("stalls"), list):
        out["stalls/count"] = {"value": float(len(record["stalls"])),
                               "direction": LOWER}
    ach = ((record.get("roofline") or {}).get("achieved") or {})
    if isinstance(ach.get("bytes_per_sec"), (int, float)):
        out["roofline/achieved_bytes_per_sec"] = {
            "value": float(ach["bytes_per_sec"]), "direction": HIGHER}
    return out


# op-class deltas within this band read as "flat" in the blame section
BLAME_FLAT_PCT = 0.02


def extract_attribution(record: dict) -> Optional[dict]:
    """Per-window op-class seconds from a RunReport's ``profile``
    section, or None when the record carries none (sampler
    unarmed, bench record, pre-profiler schema). Normalizing by window
    count makes two runs with different durations comparable."""
    if not isinstance(record, dict):
        return None
    prof = record.get("profile")
    if not isinstance(prof, dict):
        return None
    op = prof.get("op_class_seconds")
    if not isinstance(op, dict) or not op:
        return None
    windows = prof.get("windows") or 1
    per_window = {cls: float(v) / windows for cls, v in op.items()
                  if isinstance(v, (int, float))}
    if not any(per_window.values()):
        return None
    return {"source": prof.get("source"), "windows": windows,
            "per_window_s": per_window}


def attribution_blame(baseline: dict, current: dict) -> List[dict]:
    """Rank op classes by their contribution to the busy-time delta —
    the "why" behind a step-time regression: "collective-permute +31%,
    stencil flat" instead of a bare fail. Empty when either side lacks
    attribution (the gate's exit-code contract never depends on it)."""
    b = extract_attribution(baseline)
    c = extract_attribution(current)
    if not b or not c:
        return []
    classes = sorted(set(b["per_window_s"]) | set(c["per_window_s"]))
    rows = []
    for cls in classes:
        bv = b["per_window_s"].get(cls, 0.0)
        cv = c["per_window_s"].get(cls, 0.0)
        delta = cv - bv
        if bv > 0:
            pct: Optional[float] = delta / bv
        else:
            pct = None if cv > 0 else 0.0  # None = class appeared fresh
        rows.append({"op_class": cls,
                     "baseline_s_per_window": bv,
                     "current_s_per_window": cv,
                     "delta_s_per_window": delta,
                     "delta_pct": pct})
    rows.sort(key=lambda r: (-abs(r["delta_s_per_window"]), r["op_class"]))
    return rows


def format_blame(rows: List[dict]) -> List[str]:
    """The human blame section (printed under a regression)."""
    if not rows:
        return []
    width = max(len(r["op_class"]) for r in rows)
    lines = ["attribution blame (op-class busy s/window, "
             "largest contribution delta first):"]
    for r in rows:
        pct = r["delta_pct"]
        if pct is None:
            label = "new"
        elif abs(pct) <= BLAME_FLAT_PCT:
            label = "flat"
        else:
            label = f"{pct:+.0%}"
        lines.append(
            f"  {r['op_class']:{width}}  {label:>6}  "
            f"({r['baseline_s_per_window']:.4g}s -> "
            f"{r['current_s_per_window']:.4g}s)")
    return lines


@dataclasses.dataclass
class DiffRow:
    metric: str
    baseline: Optional[float]
    current: Optional[float]
    tolerance: float
    status: str                    # ok | regression | improved | missing
    ratio: Optional[float] = None  # current / baseline when both exist

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _classify(base: float, cur: float, direction: str, tol: float):
    if base == 0.0:
        if cur == 0.0:
            return "ok", None
        return ("improved" if direction == HIGHER else "regression"), None
    ratio = cur / base
    worsening = (1.0 - ratio) if direction == HIGHER else (ratio - 1.0)
    if worsening > tol:
        return "regression", ratio
    if -worsening > tol:
        return "improved", ratio
    return "ok", ratio


def diff_records(baseline: dict, current: dict, *,
                 tolerances: Optional[dict] = None,
                 default_tolerance: float = DEFAULT_TOLERANCE
                 ) -> List[DiffRow]:
    """Per-metric delta rows over the union of both records' metrics,
    sorted regressions first (then name) so the table leads with what
    matters."""
    b, c = extract_metrics(baseline), extract_metrics(current)
    rows = []
    for name in sorted(set(b) | set(c)):
        tol = tolerance_for(name, tolerances, default_tolerance)
        bv = b.get(name, {}).get("value")
        cv = c.get(name, {}).get("value")
        if bv is None or cv is None:
            rows.append(DiffRow(name, bv, cv, tol, "missing"))
            continue
        direction = c.get(name, b.get(name, {})).get("direction", LOWER)
        status, ratio = _classify(bv, cv, direction, tol)
        if (status != "ok" and direction == LOWER
                and max(bv, cv) < floor_for(name)):
            status = "ok"  # sub-floor timing churn is noise, not signal
        rows.append(DiffRow(name, bv, cv, tol, status, ratio))
    order = {"regression": 0, "improved": 1, "ok": 2, "missing": 3}
    rows.sort(key=lambda r: (order.get(r.status, 9), r.metric))
    return rows


def record_staleness(record: dict, *, provenance=None) -> Optional[str]:
    """Why this record cannot be trusted as a comparison anchor, or None.

    Honors the flags directly (``needs_recapture`` / ``stale`` with
    their recorded reason) and, when a ``provenance`` module is supplied
    (``utils.provenance``) and the record carries
    a commit stamp, re-checks the measured paths against HEAD — a record
    committed fresh goes stale the moment the kernel under it changes.
    """
    if not isinstance(record, dict):
        return None
    if record.get("needs_recapture") or record.get("stale"):
        return record.get("stale_reason") or "record flagged needs_recapture"
    if provenance is not None and record.get("commit") \
            and "metric" in record:
        st = provenance.staleness(record)
        if st.get("stale"):
            return st.get("reason") or "provenance stale"
    return None


def gate(baseline: dict, current: dict, *,
         tolerances: Optional[dict] = None,
         default_tolerance: float = DEFAULT_TOLERANCE,
         provenance=None) -> dict:
    """The perf-gate verdict: {"status": ok|regression|skipped, "rows",
    "reason"}. ``skipped`` (stale anchor) is its own terminal state —
    the caller must surface it as "skipped (stale)", never fold it into
    "ok" (a stale baseline would wave every regression through)."""
    for which, rec in (("baseline", baseline), ("current", current)):
        why = record_staleness(rec, provenance=provenance)
        if why:
            return {"status": "skipped",
                    "reason": f"{which} record is stale: {why}",
                    "rows": []}
    rows = diff_records(baseline, current, tolerances=tolerances,
                        default_tolerance=default_tolerance)
    comparable = [r for r in rows if r.status != "missing"]
    if not comparable:
        return {"status": "skipped",
                "reason": "no comparable metrics between the two records",
                "rows": rows}
    bad = [r for r in rows if r.status == "regression"]
    verdict = {"status": "regression" if bad else "ok",
               "reason": (f"{len(bad)} metric(s) regressed beyond tolerance"
                          if bad else
                          f"{len(comparable)} metric(s) within tolerance"),
               "rows": rows}
    blame = attribution_blame(baseline, current)
    if blame:
        # advisory only: blame explains a verdict, it never changes one
        # (a gate's exit status reads the status alone)
        verdict["blame"] = blame
    return verdict


def format_rows(rows: List[DiffRow]) -> List[str]:
    """The human delta table (report --diff)."""
    if not rows:
        return ["(no comparable metrics)"]
    name_w = max(len(r.metric) for r in rows)

    def fmt(v):
        return f"{v:.4g}" if isinstance(v, (int, float)) else "-"

    lines = [f"{'metric':{name_w}}  {'baseline':>12}  {'current':>12}"
             f"  {'ratio':>7}  {'tol':>5}  status"]
    for r in rows:
        ratio = f"{r.ratio:.3f}" if r.ratio is not None else "-"
        lines.append(
            f"{r.metric:{name_w}}  {fmt(r.baseline):>12}  "
            f"{fmt(r.current):>12}  {ratio:>7}  {r.tolerance:>5.2f}  "
            f"{r.status.upper() if r.status == 'regression' else r.status}")
    return lines
