"""A kernel's share of its roofline, from the traced window.

The bound is the larger of two times: the operations the work needs over
the card's integer-op peak, and the bytes it needs (the state read once
and written once per launch) over the HBM rate (:mod:`.yardstick`). The
share is that bound over the kernel's device time, summed over its
records in the trace. A trace whose records fall short of the launches
the program counted in it gives no share.
"""

from __future__ import annotations

from typing import Optional

from .trace import kernel_time
from .yardstick import cost


def share(ctx: dict, pattern: str, launches: int, ops: float,
          nbytes: float) -> Optional[tuple]:
    """``(percent, how)`` for the kernels named by ``pattern``, whose
    ``launches`` launches in the traced window needed ``ops`` operations
    and ``nbytes`` bytes; None where the window holds none, or where the
    trace is not whole."""
    trace, peaks = ctx.get("trace"), ctx.get("peaks")
    if trace is None or peaks is None or not launches or not trace["whole"]:
        return None
    records, seconds = kernel_time(trace, pattern)
    if records != launches or seconds <= 0:
        return None
    t_ops = ops / peaks["int_ops_per_sec"]
    t_bytes = nbytes / peaks["hbm_bytes_per_sec"]
    bound = max(t_ops, t_bytes)
    return (100.0 * bound / seconds,
            f"bound {bound!r} s ({'ops' if t_ops >= t_bytes else 'bytes'}: "
            f"{ops!r} ops, {nbytes!r} B) / {seconds!r} s over {records} "
            f"records of {launches} launches counted")


def ops_per_word(ctx: dict) -> int:
    return cost.rule_ops_per_word(cost.rule_from_config(ctx["config"]))


def whole_grid(ctx: dict, pattern: str, counter: str) -> Optional[tuple]:
    """The share of a kernel that steps the whole grid: every generation
    of the traced window, every word."""
    trace = ctx.get("trace")
    if trace is None or "generations" not in trace.get("counters", {}):
        return None
    c = trace["counters"]
    launches = c["launches"].get(counter, 0)
    words = ctx["words"]
    return share(ctx, pattern, launches,
                 float(c["generations"]) * words * ops_per_word(ctx),
                 float(launches) * 2 * words * 4)
