"""Dense (one byte per cell) stencil step, in plain PyTorch.

Counterpart of ``gameoflifewithactors_tpu.ops.stencil``: a separable 3×3
window sum followed by a branch-free rule-mask lookup. It is the debuggable
reference path; the bit-packed path in :mod:`.packed` and the CUDA kernel
in :mod:`.cuda_stencil` must agree with it bit for bit.

Two boundary topologies:

- ``TORUS``: edges wrap.
- ``DEAD``: cells outside the grid are permanently dead (zero padding).
"""

from __future__ import annotations

import enum

import torch

from ..models.rules import Rule
from ._builders import BuiltRunner, register_builder


class Topology(enum.Enum):
    TORUS = "torus"
    DEAD = "dead"


def _pad1(state: torch.Tensor, topology: Topology) -> torch.Tensor:
    """One ring of boundary cells around an (H, W) grid: wrapped copies of
    the opposite edges for TORUS, zeros for DEAD."""
    if topology is Topology.TORUS:
        state = torch.cat([state[-1:], state, state[:1]], dim=0)
        return torch.cat([state[:, -1:], state, state[:, :1]], dim=1)
    return torch.nn.functional.pad(state, (1, 1, 1, 1))


def neighbor_counts(state: torch.Tensor, topology: Topology) -> torch.Tensor:
    """Live Moore-neighbor count (excluding self) of every cell of an
    (H, W) uint8 grid in {0, 1}."""
    return neighbor_counts_ext(_pad1(state, topology))


def neighbor_counts_ext(ext: torch.Tensor) -> torch.Tensor:
    """Neighbor counts for the interior of a halo-extended (h+2, w+2) tile:
    3-row sums, then 3-column sums, minus the cell itself."""
    rows = ext[:-2, :] + ext[1:-1, :] + ext[2:, :]
    win = rows[:, :-2] + rows[:, 1:-1] + rows[:, 2:]
    return win - ext[1:-1, 1:-1]


def apply_rule(state: torch.Tensor, counts: torch.Tensor, rule: Rule) -> torch.Tensor:
    """Select the survive mask for live cells and the birth mask for dead
    ones, then test bit ``count`` of it."""
    # scalar masks: no host-to-device copy, so the step can be captured in
    # a CUDA graph (aot/registry.py)
    mask = torch.where(state.bool(), rule.survive_mask, rule.birth_mask)
    return ((mask >> counts.to(torch.int32)) & 1).to(state.dtype)


def step(state: torch.Tensor, *, rule: Rule, topology: Topology = Topology.TORUS) -> torch.Tensor:
    """One generation on an unpacked (H, W) uint8 grid."""
    return apply_rule(state, neighbor_counts(state, topology), rule)


def multi_step(
    state: torch.Tensor,
    n: int,
    *,
    rule: Rule,
    topology: Topology = Topology.TORUS,
) -> torch.Tensor:
    """``n`` generations of :func:`step`."""
    for _ in range(int(n)):
        state = step(state, rule=rule, topology=topology)
    return state


# -- contract-gate registration (ops/_builders.py BUILDERS) -------------------


@register_builder("ops.multi_step", tags=("ops", "dense"))
def _contract_ops_multi_step(device):
    from ..models.rules import CONWAY
    from .packed import _contract_soup

    return BuiltRunner(
        runner=lambda s, n: multi_step(s, n, rule=CONWAY),
        example_args=(_contract_soup(device), 3),
        expected_halo_bytes=0, halo_model="single device: no exchange")
