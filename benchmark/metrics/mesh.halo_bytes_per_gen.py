"""Halo bytes the row exchanges of a mesh moved between cards per
generation of the window: the program's ``halo.exchanged_bytes()`` counter
read before and after the window, over the window's generations."""


def read(ctx):
    w = ctx.get("window") or {}
    if ctx["driver"] != "batch" or "exchanged_bytes" not in w:
        return None
    return (w["exchanged_bytes"] / w["generations"],
            f"{w['exchanged_bytes']} B / {w['generations']} generations")
