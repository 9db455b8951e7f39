"""Milliseconds a completed request of the window waited, under the
service's lock, for the card to finish what was enqueued on the lane it
reads: the program's serve.frame_sync spans over the window's
requests."""


def read(ctx):
    if ctx["driver"] != "sessions" or not ctx["window"]["requests"]:
        return None
    span = ctx["spans"].get("serve.frame_sync")
    if span is None:
        return None
    n = ctx["window"]["requests"]
    return (1e3 * span["seconds"] / n,
            f"{span['count']} serve.frame_sync spans, {span['seconds']:.6f} s"
            f" / {n} requests")
