"""Milliseconds a completed request of the window spent writing its
responses (the JSON, the headers and the socket write of the step's and
the read's): the program's serve.respond spans over the window's
requests."""


def read(ctx):
    if ctx["driver"] != "sessions" or not ctx["window"]["requests"]:
        return None
    span = ctx["spans"].get("serve.respond")
    if span is None:
        return None
    n = ctx["window"]["requests"]
    return (1e3 * span["seconds"] / n,
            f"{span['count']} serve.respond spans, {span['seconds']:.6f} s"
            f" / {n} requests")
