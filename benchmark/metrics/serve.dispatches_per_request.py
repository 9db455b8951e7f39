"""Lane dispatches (the program's lane.dispatch spans) per completed
request in the window."""


def read(ctx):
    if ctx["driver"] != "sessions" or not ctx["window"]["requests"]:
        return None
    d = len(ctx["dispatches"])
    return (d / ctx["window"]["requests"],
            f"{d} dispatches / {ctx['window']['requests']} requests")
