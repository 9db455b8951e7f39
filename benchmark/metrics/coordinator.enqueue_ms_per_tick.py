"""Mean duration of the program's coordinator.tick span on one card: the
host's enqueue of a tick (the tick does not sync without a metrics
logger)."""


def read(ctx):
    if ctx["driver"] != "batch":
        return None
    span = ctx["spans"].get("coordinator.tick")
    if not span:
        return None
    return (1e3 * span["seconds"] / span["count"],
            f"{span['seconds']!r} s over {span['count']} ticks")
