"""fleet_top: live fleet table over N worker ``/metrics`` endpoints.

    python -m gameoflifewithactors_torch.obs.fleet_top w0=127.0.0.1:9001 w1=127.0.0.1:9002
    python -m gameoflifewithactors_torch.obs.fleet_top --once 127.0.0.1:9001 127.0.0.1:9002

Polls every target through a :class:`FleetAggregator` (TTL-cached, so
pointing several fleet_tops at the same fleet does not multiply scrape
load) and renders one row per worker: lanes and slot occupancy,
sessions and distinct tenants, per-proc steps/sec, device memory in use
against the limit, heartbeat misses, retraces (post-warm
kernel builds), and the
sampling profiler's duty cycle + measured capture overhead (PROF /
PROF-OH, "-" when unarmed).

Rates and HBM are per-chip numbers: each row reads one process's
gauges, and nothing here sums them across rows (the aggregator refuses
that by construction — ``PerChipSumError``).

``--serve PORT`` additionally exposes the merged exposition at
``http://127.0.0.1:PORT/metrics`` (and ``/fleet`` liveness JSON) for an
external scraper. ``--once`` prints a single table and exits 0 if every
target answered — the CI smoke mode.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional

from .aggregate import AggregatorServer, FleetAggregator, base_name

COLUMNS = ("PROC", "UP", "LANES", "SLOTS", "SESS", "TENANTS", "STEPS/S",
           "HBM", "POOL", "HB-MISS", "RETRACE", "STALLS", "PROF",
           "PROF-OH")


def _samples(parsed: Optional[dict], family: str) -> List[tuple]:
    if parsed is None:
        return []
    return [(labels, value) for name, labels, value in parsed["samples"]
            if base_name(name) == family]


def _total(parsed: Optional[dict], family: str) -> float:
    return sum(v for _l, v in _samples(parsed, family))


def _ratio(parsed: Optional[dict], family: str) -> str:
    """A per-chip ratio gauge as a percentage, '-' when unarmed."""
    vals = [v for _l, v in _samples(parsed, family)]
    return f"{max(vals):.1%}" if vals else "-"


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}TiB"


def row_for(proc: str, parsed: Optional[dict]) -> List[str]:
    if parsed is None:
        return [proc, "down"] + ["-"] * (len(COLUMNS) - 2)
    tenants = sorted({labels.get("tenant") for labels, v in
                      _samples(parsed, "sessions_live")
                      if labels.get("tenant") and v > 0})
    slots_live = _total(parsed, "session_lane_slots_live")
    slots_total = _total(parsed, "session_lane_slots_total")
    # per-proc sum over tenants of a same-chip gauge: still one chip's
    # number, so summing here is honest (unlike summing across procs)
    steps = _total(parsed, "tenant_steps_per_sec")
    hbm_use = max((v for _l, v in _samples(parsed, "hbm_bytes_in_use")),
                  default=0.0)
    hbm_lim = max((v for _l, v in _samples(parsed, "hbm_bytes_limit")),
                  default=0.0)
    hbm = (f"{_fmt_bytes(hbm_use)}/{_fmt_bytes(hbm_lim)}"
           if hbm_lim else (_fmt_bytes(hbm_use) if hbm_use else "-"))
    # paged tile pools (memory/pool.py): in-use/capacity summed over
    # this proc's pools — same-chip sums, like the tenant gauges above
    pool_used = _total(parsed, "pool_tiles_in_use")
    pool_free = _total(parsed, "pool_tiles_free")
    pool = (f"{pool_used:.0f}/{pool_used + pool_free:.0f}"
            if (pool_used or pool_free) else "-")
    return [
        proc, "up",
        f"{_total(parsed, 'session_lanes'):.0f}",
        f"{slots_live:.0f}/{slots_total:.0f}",
        f"{_total(parsed, 'sessions_live'):.0f}",
        f"{len(tenants)}",
        f"{steps:.1f}",
        hbm,
        pool,
        f"{_total(parsed, 'elastic_heartbeat_misses_total'):.0f}",
        f"{_total(parsed, 'kernel_builds'):.0f}",
        f"{_total(parsed, 'stalls'):.0f}",
        # sampling-profiler visibility: an armed fleet is
        # visibly armed — configured duty cycle and measured capture
        # overhead, both per-chip ratios (max, never summed)
        _ratio(parsed, "profile_duty_cycle"),
        _ratio(parsed, "profile_overhead_ratio"),
    ]


def render_table(view: Dict[str, Optional[dict]]) -> str:
    rows = [list(COLUMNS)] + [row_for(p, parsed)
                              for p, parsed in sorted(view.items())]
    widths = [max(len(r[c]) for r in rows) for c in range(len(COLUMNS))]
    return "\n".join(
        "  ".join(cell.ljust(w) for cell, w in zip(r, widths)).rstrip()
        for r in rows)


def parse_targets(raw: List[str]) -> Dict[str, str]:
    targets: Dict[str, str] = {}
    for i, item in enumerate(raw):
        if "=" in item:
            proc, url = item.split("=", 1)
        else:
            proc, url = f"w{i}", item
        targets[proc] = url
    return targets


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="live fleet table over worker /metrics endpoints")
    parser.add_argument("targets", nargs="+",
                        help="worker endpoints, 'name=host:port' or "
                        "'host:port' (named w0, w1, ... in order)")
    parser.add_argument("--interval", type=float, default=2.0,
                        help="refresh period in seconds")
    parser.add_argument("--once", action="store_true",
                        help="print one table and exit (0 iff all up)")
    parser.add_argument("--serve", type=int, default=None, metavar="PORT",
                        help="also serve the merged exposition on "
                        "127.0.0.1:PORT (/metrics, /fleet)")
    args = parser.parse_args(argv)

    agg = FleetAggregator(parse_targets(args.targets),
                          ttl_seconds=min(1.0, args.interval / 2))
    server = None
    if args.serve is not None:
        server = AggregatorServer(agg, port=args.serve).start()
        print(f"fleet_top: aggregate endpoint on "
              f"http://127.0.0.1:{server.port}/metrics", flush=True)
    try:
        while True:
            view = agg.view()
            table = render_table(view)
            if args.once:
                print(table, flush=True)
                return 0 if all(v is not None for v in view.values()) else 1
            sys.stdout.write("\x1b[2J\x1b[H" + table + "\n")
            sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0
    finally:
        if server is not None:
            server.stop()


if __name__ == "__main__":
    sys.exit(main())
