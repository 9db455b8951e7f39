"""Milliseconds a completed request of the window waited for the
service's lock: the program's serve.lock_wait spans (the step's and the
read's) summed over the window, over its requests."""


def read(ctx):
    if ctx["driver"] != "sessions" or not ctx["window"]["requests"]:
        return None
    span = ctx["spans"].get("serve.lock_wait")
    if span is None:
        return None
    n = ctx["window"]["requests"]
    return (1e3 * span["seconds"] / n,
            f"{span['count']} serve.lock_wait spans, {span['seconds']:.6f} s"
            f" / {n} requests")
