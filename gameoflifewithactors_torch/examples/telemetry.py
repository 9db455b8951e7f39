"""Run telemetry end to end: spans, kernel builds, watchdog, RunReport.

Drives a small soup through the coordinator/scheduler stack with a
telemetry session active, then shows all three pillars of obs/:

1. the per-phase host-time table (dispatch vs. sync vs. readback vs.
   subscriber time) and the kernel builds the first tick paid (on the
   card the engine steps through kernel B1);
2. the stall watchdog flagging a deliberately wedged tick (a subscriber
   that sleeps past the deadline) and naming the last-completed span;
3. the RunReport JSON artifact plus a chrome://tracing span file --
   drop the latter into ui.perfetto.dev next to a ``torch.profiler``
   device trace for a combined host+device timeline.

    python -m gameoflifewithactors_torch.examples.telemetry --side 256 --gens 64 --out /tmp/report.json
"""

from __future__ import annotations

import argparse
import sys
import time

from . import add_device_flag


def run(argv=None) -> dict:
    """Print the report's summary; return ``{"report": RunReport,
    "report_path", "trace_path", "stall": StallEvent or None,
    "coordinator"}``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--side", type=int, default=256)
    ap.add_argument("--gens", type=int, default=64)
    ap.add_argument("--ticks", type=int, default=8,
                    help="generations are run in this many ticks")
    ap.add_argument("--out", default="telemetry_report.json",
                    help="RunReport JSON path (a .trace.json chrome-trace "
                         "sibling is written next to it)")
    ap.add_argument("--stall-demo", action="store_true",
                    help="also wedge one tick past a 100 ms deadline to "
                         "show the watchdog diagnostic")
    add_device_flag(ap)
    args = ap.parse_args(argv)

    from .. import GridCoordinator, TickScheduler
    from ..engine import resolve_device
    from ..obs import TRACER, begin_run_telemetry

    device = resolve_device(args.device)
    # -- pillar 1+3: a normal measured run ----------------------------------
    telem = begin_run_telemetry(stall_deadline=60.0)
    coord = GridCoordinator((args.side, args.side), "B3/S23",
                            random_fill=0.5, track_population=True,
                            device=device)
    telem.attach(coord)
    TickScheduler(coord, generations_per_tick=max(1, args.gens // args.ticks)
                  ).run(max_generations=args.gens)
    report = telem.finish(engine=coord.engine,
                          config={"example": "telemetry", "side": args.side,
                                  "gens": args.gens})

    # -- pillar 2: the watchdog catching a wedged tick ----------------------
    ev = None
    if args.stall_demo:
        from ..obs import StallWatchdog, arm, disarm

        stalls = []
        arm(StallWatchdog(0.1, on_stall=stalls.append))
        unsub = coord.subscribe(lambda frame: time.sleep(0.5))  # the wedge
        coord.tick(1)
        disarm()
        unsub()
        ev = stalls[0]
        print(f"watchdog: {ev.label} overran {ev.deadline_seconds:.1f}s "
              f"deadline; last completed span: {ev.last_completed_span}")

    path = report.save(args.out)
    trace_path = TRACER.write_chrome_trace(
        args.out.rsplit(".json", 1)[0] + ".trace.json")
    print("\n".join(report.summary_lines()))
    print(f"report written: {path}")
    print(f"host-span chrome trace written: {trace_path} "
          "(open in ui.perfetto.dev)", file=sys.stderr)
    return {"report": report, "report_path": path, "trace_path": trace_path,
            "stall": ev, "coordinator": coord}


def main(argv=None) -> None:
    run(argv)


if __name__ == "__main__":
    main()
