"""The 95th percentile of every request completed in the window, from the
client's side: sending the step to holding the frame."""

import statistics


def read(ctx):
    if ctx["driver"] != "sessions":
        return None
    lat = ctx["window"]["latencies_s"]
    if len(lat) < 200:
        return None
    p95 = statistics.quantiles(lat, n=100, method="inclusive")[94] * 1e3
    return p95, f"95th percentile of {len(lat)} requests"
