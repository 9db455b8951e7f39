"""Bit-packed SWAR stepping for elementary (Wolfram) 1D CA, in plain
PyTorch.

Counterpart of ``gameoflifewithactors_tpu.ops.elementary``, operation for
operation. State is a packed int32 tensor whose LAST axis is the
32-cells-per-word row (:mod:`.bitpack` layout); leading axes, if any, are
independent universes -- an ``(H, Wp)`` tensor steps H separate 1D worlds
in one pass, so an ensemble costs the same calls as one row.

One generation = two neighbour shifts (:func:`.packed.horizontal_planes`,
the one home of the cross-word carries) + the rule's minterm evaluation:
the Wolfram number's set bits select which of the 8 (l, c, r) patterns
produce a live cell, each pattern a 3-term AND over the left/center/right
planes. No TPU kernel serves this family; XLA fuses it in the reference.
"""

from __future__ import annotations

import torch

from ..models.elementary import ElementaryRule
from .packed import horizontal_planes
from .stencil import Topology


def step_elementary(
    p: torch.Tensor, *, rule: ElementaryRule,
    topology: Topology = Topology.TORUS,
) -> torch.Tensor:
    """One generation on a (..., W/32) packed row (or stack of rows)."""
    left, _, right = horizontal_planes(p, topology)
    # each plane's complement is computed once, and only if a minterm
    # reads it
    planes = {}

    def plane(which: int, bit: int) -> torch.Tensor:
        if (which, bit) not in planes:
            base = (left, p, right)[which]
            planes[which, bit] = base if bit else ~base
        return planes[which, bit]

    out = torch.zeros_like(p)
    for k in range(8):
        if not (rule.number >> k) & 1:
            continue
        term = plane(0, (k >> 2) & 1) & plane(1, (k >> 1) & 1)
        out |= term & plane(2, k & 1)
    return out


def multi_step_elementary(
    p: torch.Tensor, n: int, *, rule: ElementaryRule,
    topology: Topology = Topology.TORUS,
) -> torch.Tensor:
    """``n`` generations (a Python int); returns a new tensor."""
    if n < 0:
        raise ValueError(f"cannot step a negative number of generations: {n}")
    s = p.clone()
    for _ in range(int(n)):
        s = step_elementary(s, rule=rule, topology=topology)
    return s


def evolve_spacetime(
    p: torch.Tensor, steps: int, *, rule: ElementaryRule,
    topology: Topology = Topology.TORUS,
) -> torch.Tensor:
    """The (steps+1, ..., W/32) spacetime diagram (row 0 = initial state),
    written into one preallocated tensor -- the canonical way to LOOK at a
    1D CA; feed it to bitpack.unpack and utils/render for the
    Sierpinski-triangle view of rule 90."""
    steps = int(steps)
    out = torch.empty((steps + 1,) + tuple(p.shape), dtype=p.dtype,
                      device=p.device)
    out[0] = p
    for t in range(steps):
        out[t + 1] = step_elementary(out[t], rule=rule, topology=topology)
    return out
