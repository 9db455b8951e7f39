"""The share of slot-dispatches that only copied their tile: 1 - the live
slots over the lane's capacity, summed over the window's lane.dispatch
spans."""


def read(ctx):
    if ctx["driver"] != "sessions" or not ctx["dispatches"]:
        return None
    cap = ctx["lane_capacity"]
    live = sum(d["slots"] for d in ctx["dispatches"])
    total = sum(cap[d["lane"]] for d in ctx["dispatches"])
    return 1.0 - live / total, f"1 - {live} live / {total} slot-dispatches"
