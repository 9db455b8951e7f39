"""Kernel launches per 1000 generations of the window (the program's
launch counters), on one card."""


def read(ctx):
    if ctx["driver"] != "batch":
        return None
    w = ctx["window"]
    launches = sum(w["launches"].values())
    if not launches:
        return None
    return (1e3 * launches / w["generations"],
            f"{launches} launches / {w['generations']} generations")
