"""Perf history: the port's records folded into one queryable curve.

Counterpart of the repository's ``scripts/perf_history.py``. It folds
only what the port wrote:

- the bench store (``results/cuda_best.json``, ``--store``): one entry
  per key, and the RunReport each entry points at (``telemetry_report``);
- every JSON record under ``<repo>/results`` that names this package
  (the ``--out`` records of the bench tools);
- RunReports and records named with ``--record`` (repeatable).

``BENCH_r*.json``, ``results/tpu_*.json`` and ``results/history.jsonl``
(the JAX package's) stay out. Entries go to an **append-only**
``results/history_cuda.jsonl`` (``--history``), deduplicated by content
fingerprint, and a markdown trend table per series flags with median/MAD
anomaly detection: an entry more than 3.5 robust standard deviations from
its series median (30% of the median when the MAD is zero).

    python -m gameoflifewithactors_torch.bench.history            # fold + append + trend
    python -m gameoflifewithactors_torch.bench.history --check --strict

Exit codes: 0 = ok (``--check`` without ``--strict`` is informational),
1 = ``--strict`` and anomalies found, 2 = nothing to fold or unusable
input. It touches no device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time
from typing import Dict, List, Optional

from ..utils import provenance
from .run import marked_records

#: |robust z| above this flags an anomaly (0.6745 * (x - median) / MAD).
ANOMALY_Z = 3.5
#: MAD == 0 fallback: relative deviation from the median above this flags.
ANOMALY_REL = 0.30
#: A series needs at least this many entries before anomalies are called.
MIN_SERIES = 4


# -- entry extraction ----------------------------------------------------------


def _entry(series: str, value, unit=None, recorded_at=None, commit=None,
           stale=None, source: str = "?") -> Optional[dict]:
    if not isinstance(value, (int, float)) or isinstance(value, bool):
        return None
    e = {"series": series, "value": float(value), "source": source}
    if unit:
        e["unit"] = unit
    if recorded_at:
        e["recorded_at"] = recorded_at
    if commit:
        e["commit"] = commit
    if stale:
        e["stale"] = True
    e["id"] = hashlib.sha1(
        f"{series}|{e['value']!r}|{recorded_at or ''}|{source}"
        .encode()).hexdigest()[:16]
    return e


def _from_bench_record(rec: dict, source: str) -> List[dict]:
    out = []
    e = _entry(rec["metric"], rec.get("value"), rec.get("unit"),
               rec.get("recorded_at"), rec.get("commit"),
               rec.get("stale") or rec.get("needs_recapture"), source)
    if e:
        out.append(e)
    sceq = rec.get("single_chip_equivalent_updates_per_sec")
    e = _entry(f"{rec['metric']} [per-chip-equivalent]", sceq,
               rec.get("unit"), rec.get("recorded_at"), rec.get("commit"),
               rec.get("stale"), source)
    if e:
        out.append(e)
    return out


def _from_run_report(rec: dict, source: str) -> List[dict]:
    rates = [m.get("cell_updates_per_sec")
             for m in rec.get("step_metrics") or []
             if isinstance(m, dict)
             and isinstance(m.get("cell_updates_per_sec"), (int, float))]
    if not rates:
        return []
    stem = os.path.splitext(os.path.basename(source))[0]
    e = _entry(f"report/{stem}/best_cell_updates_per_sec", max(rates),
               "cell-updates/sec", rec.get("created_at"), None, None, source)
    return [e] if e else []


def extract_entries(rec, source: str) -> List[dict]:
    """History entries from one loaded JSON artifact (a bench record, a
    RunReport or a store); [] for shapes with nothing to track."""
    if not isinstance(rec, dict):
        return []
    if isinstance(rec.get("parsed"), dict) and "metric" not in rec:
        rec = rec["parsed"]
    if "metric" in rec and "value" in rec:
        return _from_bench_record(rec, source)
    if isinstance(rec.get("step_metrics"), list):
        return _from_run_report(rec, source)
    out: List[dict] = []
    for key, sub in rec.items():
        if isinstance(sub, dict) and "metric" in sub and "value" in sub:
            out.extend(_from_bench_record(sub, f"{source}#{key}"))
    return out


def _load(path: str):
    with open(path) as f:
        return json.load(f)


def port_artifacts(repo: str, store: str, records=()) -> List[str]:
    """The files the port wrote, in fold order: the store, the RunReports
    its entries point at, the records under ``<repo>/results`` that name
    this package, then ``records``."""
    paths: List[str] = []
    if os.path.exists(store):
        paths.append(store)
        try:
            entries = _load(store)
        except (OSError, json.JSONDecodeError):
            entries = {}
        base = os.path.dirname(os.path.dirname(os.path.abspath(store)))
        for sub in (entries.values() if isinstance(entries, dict) else []):
            report = isinstance(sub, dict) and sub.get("telemetry_report")
            if report:
                paths.append(os.path.join(base, report))
    paths += [path for path, _ in marked_records(
        os.path.join(repo, "results"), skip=paths + [store])]
    paths += [p for p in records if p not in paths]
    return paths


def scan(repo: str, store: str, records=()) -> List[dict]:
    """Every history entry of the port's artifacts, sources relative to
    ``repo``; unreadable files are skipped with a note on stderr."""
    entries: List[dict] = []
    for path in port_artifacts(repo, store, records):
        rel = os.path.relpath(path, repo)
        try:
            rec = _load(path)
        except (OSError, json.JSONDecodeError) as exc:
            print(f"history: skipping {rel}: {exc}", file=sys.stderr)
            continue
        entries.extend(extract_entries(rec, rel))
    return entries


# -- the append-only history file ------------------------------------------------


def load_history(path: str) -> List[dict]:
    entries = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # a torn tail line must not kill the scan
                if isinstance(rec, dict) and "series" in rec:
                    entries.append(rec)
    except OSError:
        pass
    return entries


def fold(repo: str, store: str, history_path: str, *, records=(),
         write: bool = True) -> dict:
    """Merge fresh entries into the history; existing lines are never
    rewritten, new ones (by fingerprint) are appended with an
    ``appended_at`` stamp. Returns {"history", "appended"}."""
    history = load_history(history_path)
    seen = {e.get("id") for e in history}
    uniq: Dict[str, dict] = {}
    for e in scan(repo, store, records):
        if e["id"] not in seen:
            uniq.setdefault(e["id"], e)
    fresh = list(uniq.values())
    if fresh:
        stamp = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
        for e in fresh:
            e["appended_at"] = stamp
        if write:
            os.makedirs(os.path.dirname(os.path.abspath(history_path)),
                        exist_ok=True)
            with open(history_path, "a") as f:
                for e in fresh:
                    f.write(json.dumps(e, sort_keys=True) + "\n")
    return {"history": history + fresh, "appended": fresh}


# -- median/MAD anomaly detection -------------------------------------------------


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


def series_stats(entries: List[dict]) -> Dict[str, dict]:
    """Per-series robust stats and anomaly flags, entries in recorded
    order (``recorded_at`` when present, else fold order)."""
    by_series: Dict[str, List[dict]] = {}
    for e in entries:
        by_series.setdefault(e["series"], []).append(e)
    out: Dict[str, dict] = {}
    for series, es in by_series.items():
        es = sorted(es, key=lambda e: e.get("recorded_at") or "")
        values = [e["value"] for e in es]
        med = _median(values)
        mad = _median([abs(v - med) for v in values])
        anomalies = []
        if len(values) >= MIN_SERIES:
            for e in es:
                dev = abs(e["value"] - med)
                if mad > 0:
                    z = 0.6745 * dev / mad
                    if z > ANOMALY_Z:
                        anomalies.append({**e, "robust_z": round(z, 2)})
                elif med != 0 and dev / abs(med) > ANOMALY_REL:
                    anomalies.append({**e, "rel_dev": round(dev / abs(med), 3)})
        out[series] = {
            "count": len(values),
            "min": min(values), "median": med, "max": max(values),
            "mad": mad,
            "latest": values[-1],
            "latest_vs_median": (values[-1] / med) if med else None,
            "anomalies": anomalies,
        }
    return out


def trend_table(stats: Dict[str, dict]) -> List[str]:
    lines = ["| series | n | min | median | max | latest | vs median | flags |",
             "|---|---|---|---|---|---|---|---|"]

    def g(v):
        return f"{v:.4g}" if isinstance(v, (int, float)) else "-"

    for series in sorted(stats):
        s = stats[series]
        vs = (f"{s['latest_vs_median']:.2f}x"
              if s["latest_vs_median"] is not None else "-")
        flags = (f"{len(s['anomalies'])} anomaly(ies)"
                 if s["anomalies"] else "")
        lines.append(
            f"| {series} | {s['count']} | {g(s['min'])} | {g(s['median'])} "
            f"| {g(s['max'])} | {g(s['latest'])} | {vs} | {flags} |")
    return lines


def main(argv=None) -> int:
    from .run import STORE_PATH

    ap = argparse.ArgumentParser(
        description=__doc__.split("\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--repo", default=provenance.repo_root(),
                    help="repository root (default: this checkout)")
    ap.add_argument("--store", default=None, metavar="PATH",
                    help=f"the bench store (default "
                         f"{os.path.relpath(STORE_PATH, provenance.repo_root())}"
                         " under --repo)")
    ap.add_argument("--record", action="append", default=[], metavar="PATH",
                    help="also fold this record or RunReport (repeatable)")
    ap.add_argument("--history", default=None, metavar="PATH",
                    help="history file (default "
                         "<repo>/results/history_cuda.jsonl)")
    ap.add_argument("--check", action="store_true",
                    help="read-only: scan and report anomalies, write nothing")
    ap.add_argument("--strict", action="store_true",
                    help="with --check: exit 1 when anomalies are found")
    ap.add_argument("--markdown", default=None, metavar="PATH",
                    help="also write the trend table to PATH")
    ap.add_argument("--json", action="store_true",
                    help="emit the stats as one JSON object")
    args = ap.parse_args(argv)

    repo = os.path.abspath(args.repo)
    if not os.path.isdir(repo):
        print(f"history: not a directory: {repo}", file=sys.stderr)
        return 2
    store = args.store or os.path.join(repo, "results", "cuda_best.json")
    history_path = args.history or os.path.join(
        repo, "results", "history_cuda.jsonl")
    folded = fold(repo, store, history_path, records=args.record,
                  write=not args.check)
    entries = folded["history"]
    if not entries:
        print("history: no records of the port found — nothing to fold",
              file=sys.stderr)
        return 2
    stats = series_stats(entries)
    n_anom = sum(len(s["anomalies"]) for s in stats.values())
    table = trend_table(stats)
    if args.json:
        print(json.dumps({
            "perf_history": True,
            "history": history_path,
            "entries": len(entries),
            "appended": len(folded["appended"]),
            "series": stats,
            "anomalies": n_anom,
        }, indent=1, sort_keys=True))
    else:
        print("\n".join(table))
        for series in sorted(stats):
            for a in stats[series]["anomalies"]:
                why = (f"robust z {a['robust_z']}" if "robust_z" in a
                       else f"{a['rel_dev']:.0%} off median")
                print(f"ANOMALY: {series} = {a['value']:.4g} "
                      f"({why}; {a.get('source', '?')})")
        verb = "would append" if args.check else "appended"
        print(f"history: {len(entries)} entr(ies) across {len(stats)} "
              f"series, {verb} {len(folded['appended'])}, {n_anom} "
              "anomal(ies)")
    if args.markdown:
        with open(args.markdown, "w") as f:
            f.write("\n".join(table) + "\n")
    if args.strict and n_anom:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
