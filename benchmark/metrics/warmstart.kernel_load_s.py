"""Seconds of the kernel builds and library loads that the program's
compile log records during set-up (nvcc on a checkout's first run, a
library load after)."""


def read(ctx):
    events = ctx["setup_compile_events"]
    if not events:
        return None
    kinds = sorted({e["kind"] for e in events})
    return (sum(e["wall_seconds"] for e in events),
            f"{len(events)} events ({', '.join(kinds)})")
