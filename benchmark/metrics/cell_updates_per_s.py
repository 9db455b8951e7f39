"""A batch universe's rate on one card: all cells x generations of the
window's ticks over the window (host clock, first tick's start to the
last tick's sync)."""


def read(ctx):
    if ctx["driver"] != "batch":
        return None
    w = ctx["window"]
    return (w["cells"] * w["generations"] / w["seconds"],
            f"{w['cells']} cells x {w['generations']} generations "
            f"({w['ticks']} ticks) / {w['seconds']!r} s")
