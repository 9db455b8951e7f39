"""Dense stepper for the Generations (multi-state) rule family, in plain
PyTorch.

Counterpart of ``gameoflifewithactors_tpu.ops.generations``: the separable
window sum of :mod:`.stencil` over the *alive plane* (state == 1; dying
cells do not excite neighbours), then a branch-free next-state select. One
byte per cell; states up to 256.
"""

from __future__ import annotations

import torch

from ..models.generations import GenRule
from .stencil import Topology, _pad1, neighbor_counts_ext


def decay_select(state: torch.Tensor, born: torch.Tensor, keep: torch.Tensor,
                 states: int) -> torch.Tensor:
    """Branch-free multi-state transition shared by the Generations and
    C>=3 LtL families: dead -> 1 iff born, alive -> 1 iff keep, everything
    else counts up and states-1 wraps to 0 (dying cells decay; an alive
    cell failing survival starts decaying at 2). The increment runs in
    int32 so ``states == 256`` (the uint8 ceiling) cannot overflow."""
    aged = ((state.to(torch.int32) + 1) % states).to(torch.uint8)
    one = torch.ones_like(state)
    return torch.where(
        state == 0,
        torch.where(born, one, torch.zeros_like(state)),
        torch.where((state == 1) & keep, one, aged),
    )


def step_generations_ext(ext: torch.Tensor, rule: GenRule) -> torch.Tensor:
    """One generation from a halo-extended (h+2, w+2) uint8 tile."""
    state = ext[1:-1, 1:-1]
    # only state 1 excites: count over the alive plane with the shared stencil
    counts = neighbor_counts_ext((ext == 1).to(torch.uint8)).to(torch.int32)
    born = ((rule.birth_mask >> counts) & 1).bool()
    keep = ((rule.survive_mask >> counts) & 1).bool()
    return decay_select(state, born, keep, rule.states)


def step_generations(state: torch.Tensor, *, rule: GenRule,
                     topology: Topology = Topology.TORUS) -> torch.Tensor:
    """One generation on an unpacked (H, W) uint8 multi-state grid."""
    return step_generations_ext(_pad1(state, topology), rule)


def multi_step_generations(
    state: torch.Tensor,
    n: int,
    *,
    rule: GenRule,
    topology: Topology = Topology.TORUS,
) -> torch.Tensor:
    """``n`` generations of :func:`step_generations`."""
    for _ in range(int(n)):
        state = step_generations(state, rule=rule, topology=topology)
    return state
