"""Milliseconds of host work a completed request of the window spent on
its frame under the service's lock: the program's serve.frame_copy (the
slot to a host array) and serve.frame_encode (its hex) spans over the
window's requests."""

NAMES = ("serve.frame_copy", "serve.frame_encode")


def read(ctx):
    if ctx["driver"] != "sessions" or not ctx["window"]["requests"]:
        return None
    spans = [ctx["spans"][name] for name in NAMES if name in ctx["spans"]]
    if not spans:
        return None
    seconds = sum(s["seconds"] for s in spans)
    n = ctx["window"]["requests"]
    return (1e3 * seconds / n,
            f"{sum(s['count'] for s in spans)} serve.frame_copy and "
            f"serve.frame_encode spans, {seconds:.6f} s / {n} requests")
