"""The median of the same per-request times as request_p95_ms."""

import statistics


def read(ctx):
    if ctx["driver"] != "sessions" or not ctx["window"]["latencies_s"]:
        return None
    lat = ctx["window"]["latencies_s"]
    return statistics.median(lat) * 1e3, f"median of {len(lat)} requests"
