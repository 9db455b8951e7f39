"""Tenants' useful rate: the generations that completed requests asked
for and got back, x cells per session, over the window (host clock, the
clients' start to the last frame received). No frozen slot counts."""


def read(ctx):
    if ctx["driver"] != "sessions":
        return None
    w = ctx["window"]
    work = w["requests"] * w["generations_per_request"] * w["cells"]
    return (work / w["seconds"],
            f"{w['requests']} requests x {w['generations_per_request']} "
            f"generations x {w['cells']} cells / {w['seconds']!r} s")
