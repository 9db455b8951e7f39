"""A deliberately naive numpy oracle for life-like B/S rules.

A copy of the JAX package's test oracle over the port's own
:class:`~..models.rules.Rule` and :class:`~..ops.stencil.Topology`:
``np.pad`` + slice sums + explicit per-cell rule membership, independent
of every stepper of the package. :class:`Advancer` keeps each grid it has
checked, so that a drill checking one session at several generations
steps it on from the last check instead of replaying from the seed.
"""

from __future__ import annotations

from typing import Dict, Hashable, Tuple

import numpy as np

from ..models.rules import Rule
from ..ops.stencil import Topology


def numpy_step(state: np.ndarray, rule: Rule, topology: Topology) -> np.ndarray:
    mode = "wrap" if topology is Topology.TORUS else "constant"
    p = np.pad(state.astype(np.int32), 1, mode=mode)
    counts = sum(
        p[1 + dr : p.shape[0] - 1 + dr, 1 + dc : p.shape[1] - 1 + dc]
        for dr in (-1, 0, 1)
        for dc in (-1, 0, 1)
        if (dr, dc) != (0, 0)
    )
    out = np.zeros_like(state)
    for n in rule.born:
        out |= ((state == 0) & (counts == n)).astype(state.dtype)
    for n in rule.survive:
        out |= ((state == 1) & (counts == n)).astype(state.dtype)
    return out


def numpy_run(state: np.ndarray, rule: Rule, topology: Topology, n: int) -> np.ndarray:
    for _ in range(n):
        state = numpy_step(state, rule, topology)
    return state


class Advancer:
    """Grids by key, each at the generation it was last asked for.

    ``at(key, start, rule, topology, gens)`` returns the grid ``gens``
    generations after ``start()``: from the kept grid when it is at or
    before ``gens``, else from ``start()`` again."""

    def __init__(self):
        self._kept: Dict[Hashable, Tuple[int, np.ndarray]] = {}

    def at(self, key: Hashable, start, rule: Rule, topology: Topology,
           gens: int) -> np.ndarray:
        have = self._kept.get(key)
        if have is None or have[0] > gens:
            have = (0, start())
        grid = numpy_run(have[1], rule, topology, gens - have[0])
        self._kept[key] = (gens, grid)
        return grid
