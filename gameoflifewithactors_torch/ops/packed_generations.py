"""Bit-plane packed stepper for the Generations (multi-state) family, in
plain PyTorch.

Counterpart of ``gameoflifewithactors_tpu.ops.packed_generations``,
operation for operation. The state number is stored in ``b =
ceil(log2(C))`` bit-planes packed 32 cells per int32 word (the layout of
:mod:`.bitpack`, one plane per bit of the state, LSB plane first):

- the *alive* plane (state == 1: low bit set, all higher bits clear) runs
  through the neighbour count network of :mod:`.packed` (only state 1
  excites neighbours);
- birth/survival masks come from the same count bit-plane equality nets;
- dying cells age by a plane-wise increment (half-adder carry chain, +1
  per generation) with an equality net zeroing cells that reach C — the
  ``(state + 1) % C`` of the dense path, bit-sliced.

It is the ``backend="packed"`` Generations path, and
:func:`step_planes_slab` is the per-generation arithmetic of the CUDA
kernel in :mod:`.cuda_stencil` (``csrc/life_generations.cu``). Planes are
int32, so every right shift is masked (:mod:`.packed`).
"""

from __future__ import annotations

from functools import reduce
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..models.generations import GenRule
from . import bitpack
from .packed import _count_eq, _row_sum_bits, count_bits, count_bits_ext, horizontal_planes
from .stencil import Topology


def n_planes(states: int) -> int:
    """Bit-planes needed to store states 0..C-1."""
    return max(1, (states - 1).bit_length())


def pack_generations_for(grid: torch.Tensor, rule) -> torch.Tensor:
    """(H, W) uint8 state grid -> (b, H, W/32) int32 bit-plane stack.

    The plane count comes from the rule (b = n_planes(rule.states)), not
    from the values present, so the stack shape is fixed per rule."""
    grid = grid.to(torch.uint8)
    b = n_planes(rule.states)
    return torch.stack([bitpack.pack((grid >> i) & 1) for i in range(b)])


def unpack_generations(planes: torch.Tensor) -> torch.Tensor:
    """(b, H, W/32) bit-plane stack -> (H, W) uint8 state grid."""
    out = None
    for i in range(planes.shape[0]):
        part = bitpack.unpack(planes[i]) << i
        out = part if out is None else out | part
    return out


def unpack_generations_np(planes: np.ndarray) -> np.ndarray:
    """Host-side (b, H, W/32) stack (uint32 or int32) -> (H, W) uint8, the
    host twin of :func:`unpack_generations`."""
    out = None
    for i in range(planes.shape[0]):
        part = (bitpack.unpack_np(np.asarray(planes[i])) << i).astype(np.uint8)
        out = part if out is None else out | part
    return out


def _alive_of(plist: Sequence[torch.Tensor]) -> torch.Tensor:
    higher = reduce(torch.bitwise_or, plist[1:], torch.zeros_like(plist[0]))
    return plist[0] & ~higher  # state == 1: low bit set, higher clear


def alive_plane(planes: torch.Tensor) -> torch.Tensor:
    """(H, W/32) plane that is set exactly where state == 1."""
    return _alive_of([planes[i] for i in range(planes.shape[0])])


def _mask_plane(bits: List[torch.Tensor], counts, like: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros_like(like)
    for n in sorted(counts):
        acc = acc | _count_eq(bits, n)
    return acc


def transition_planes(plist, alive, born_p, keep_p, states: int
                      ) -> Tuple[torch.Tensor, ...]:
    """Next-generation planes from precomputed birth/keep masks — the
    decay state machine shared by every plane-stack family: the 3x3
    Generations rules (count-equality masks) and multi-state C >= 3 LtL
    (bit-sliced interval-comparator masks, :mod:`.packed_ltl`).

    ``born_p``/``keep_p`` are raw predicate planes over the window count;
    birth applies only where the state is 0 and keep only where alive —
    the masking happens here so callers can't disagree on it."""
    b = len(plist)
    nonzero = reduce(torch.bitwise_or, plist)

    kept = alive & keep_p
    one = (~nonzero & born_p) | kept     # cells whose next state is 1
    aging = nonzero & ~kept              # state+1 (mod C) for everyone else alive-ish

    # plane-wise +1: half-adder carry chain
    carry = ~torch.zeros_like(plist[0])
    inc: List[torch.Tensor] = []
    for p in plist:
        inc.append(p ^ carry)
        carry = p & carry
    if states != (1 << b):
        # cells that aged to exactly C die (C == 2**b wraps via dropped carry)
        eq_c = reduce(torch.bitwise_and,
                      [inc[i] if (states >> i) & 1 else ~inc[i]
                       for i in range(b)])
        inc = [p & ~eq_c for p in inc]

    out = [aging & inc[i] for i in range(b)]
    out[0] = out[0] | one
    return tuple(out)


def encoded_rule_planes(bits: List[torch.Tensor], alive: torch.Tensor,
                        rule: GenRule, encoding) -> Tuple[torch.Tensor, torch.Tensor]:
    """(birth, keep) predicate planes as kernel B3 looks them up, from the
    rule's encoding (``cuda_stencil._generations_rule_encoding``): on the
    equality path each encoded count's plane, tested on the three low
    count bit-planes alone (its counts lie in 1..7, and count 8's low bits
    are 000), joins the birth and keep planes it belongs to; on the table
    path (``()``) one plane, the birth mask where the cell is not alive and
    the keep mask where it is, serves as both (:func:`transition_planes`
    reads the birth plane only where the state is 0 and the keep plane only
    where it is 1)."""
    if not encoding:
        born = _mask_plane(bits, rule.born, alive)
        keep = _mask_plane(bits, rule.survive, alive)
        either = (alive & keep) | (~alive & born)
        return either, either
    born = keep = torch.zeros_like(alive)
    for n, is_born, is_kept in encoding:
        eq = _count_eq(bits[:3], n)
        if is_born:
            born = born | eq
        if is_kept:
            keep = keep | eq
    return born, keep


def _transition(plist, alive, bits, rule: GenRule, encoding=None):
    """Next-generation planes from (state planes, alive plane, count bits):
    the masks of :func:`_mask_plane`, or with an ``encoding`` those of
    :func:`encoded_rule_planes`."""
    if encoding is None:
        born_p = _mask_plane(bits, rule.born, alive)
        keep_p = _mask_plane(bits, rule.survive, alive)
    else:
        born_p, keep_p = encoded_rule_planes(bits, alive, rule, encoding)
    return transition_planes(plist, alive, born_p, keep_p, rule.states)


def _step_plane_list(plist, rule: GenRule, topology: Topology):
    """One generation on a tuple of b (H, W/32) planes."""
    alive = _alive_of(plist)
    bits = count_bits(alive, topology)
    return _transition(plist, alive, bits, rule)


def step_planes_ext(ext_list, rule: GenRule):
    """One generation from b halo-extended (..., h+2, wp+2) planes ->
    interior (..., h, wp) plane tuple (leading dimensions are a batch).
    Halos come from the caller."""
    alive_ext = _alive_of(ext_list)
    center, bits = count_bits_ext(alive_ext)  # center = interior alive
    interior = tuple(p[..., 1:-1, 1:-1] for p in ext_list)
    return _transition(interior, center, bits, rule)


def step_planes_slab(plist, rule: GenRule, topology: Topology, encoding=None):
    """One generation for the interior rows of b (..., L, Wp) planes -> b
    (..., L-2, Wp) planes — the Generations twin of
    :func:`.packed.step_packed_slab` (rows shrink consuming vertical halos;
    ``topology`` is the horizontal closure across the slab's own width).
    Rows are the second-to-last axis, so a batch of slabs (the CUDA
    kernel's tiles, in its plain version) steps at once. ``encoding``, the
    CUDA kernel's form of the rule, makes the rule lookup the kernel's
    (:func:`encoded_rule_planes`); the result is the same."""
    h = plist[0].shape[-2] - 2
    alive = _alive_of(plist)
    w, c, e = horizontal_planes(alive, topology)
    bits = _row_sum_bits(
        w, c, e,
        lambda p: (p[..., 0:h, :], p[..., 2:h + 2, :]),
        lambda p: p[..., 1:h + 1, :])
    interior = tuple(p[..., 1:h + 1, :] for p in plist)
    return _transition(interior, alive[..., 1:h + 1, :], bits, rule, encoding)


def step_planes(planes: torch.Tensor, rule: GenRule, topology: Topology) -> torch.Tensor:
    """One generation on a (b, H, W/32) bit-plane stack."""
    b = planes.shape[0]
    return torch.stack(_step_plane_list(
        tuple(planes[i] for i in range(b)), rule, topology))


def multi_step_packed_generations(
    planes: torch.Tensor,
    n: int,
    *,
    rule: GenRule,
    topology: Topology = Topology.TORUS,
) -> torch.Tensor:
    """``n`` generations on a (b, H, W/32) stack."""
    plist = tuple(planes[i] for i in range(planes.shape[0]))
    for _ in range(int(n)):
        plist = _step_plane_list(plist, rule, topology)
    return torch.stack(plist)


def population_packed_generations(planes: torch.Tensor) -> int:
    """Live-cell count (state == 1 only, matching Engine.population)."""
    return bitpack.population(alive_plane(planes))
