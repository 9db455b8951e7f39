"""The share of the traced window in which no kernel, copy or fill ran on
the card; none from a trace that lost records of the program's kernels
(the card would read idler than it was)."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or ctx["driver"] != "batch" or not trace["whole"]:
        return None
    return (1.0 - trace["busy_s"] / trace["window_s"],
            f"1 - {trace['busy_s']!r} busy s / {trace['window_s']!r} s")
