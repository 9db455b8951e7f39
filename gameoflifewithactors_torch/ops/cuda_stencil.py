"""Temporal-blocked packed stencils: the hand-written Hopper kernels and
their plain PyTorch versions.

Counterpart of the full-grid kernels of
``gameoflifewithactors_tpu.ops.pallas_stencil``:

- B1, ``_make_kernel`` / ``multi_step_pallas``: a 3x3 B/S rule on a
  packed ``(H, W/32)`` int32 grid (:func:`multi_step_kernel`,
  ``csrc/life_packed.cu``);
- B3, ``_make_gen_kernel`` / ``multi_step_pallas_generations``: a
  Generations rule on a ``(b, H, W/32)`` bit-plane stack
  (:func:`multi_step_generations_kernel`, ``csrc/life_generations.cu``);
- B4, ``_make_ltl_kernel`` / ``multi_step_ltl_pallas``: a binary
  radius-r Larger-than-Life rule on a packed grid
  (:func:`multi_step_ltl_kernel`, ``csrc/life_ltl.cu``).

One launch advances ``g`` generations: each CUDA block loads its tile plus
a halo (``g`` rows and one word per side for the 3x3 kernels, ``r*g`` rows
and ``ceil(r*g/32)`` words for LtL) into shared memory, steps it ``g``
times and writes back its interior. The ``n % g`` remainder is one more,
shorter launch. ``_build`` compiles each source with ``nvcc`` at first use.

Each wrapper launches its kernel for a CUDA tensor and runs its plain
version -- the kernel's own algorithm (same tiles, modulo-wrapped halo
gather, DEAD re-zero every generation, shrinking slab steps of
:mod:`.packed`, :mod:`.packed_generations` or :mod:`.packed_ltl`, shorter
last launch) in plain torch -- only for a CPU tensor.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from ..models.generations import GenRule
from ..models.ltl import LtLRule
from ..models.rules import Rule
from .packed import step_packed_slab
from .packed_generations import n_planes, step_planes_slab
from .packed_ltl import step_ltl_packed_slab
from .stencil import Topology

DEFAULT_GENS_PER_CALL = 8
DEFAULT_TILE = (64, 64)   # (rows, words) each CUDA block owns
MAX_GENS_PER_CALL = 32    # one halo word per side covers 32 generations
# Generations and Larger than Life: depth and tile from the sweeps on the
# card (PERF.md)
DEFAULT_GENERATIONS_GENS_PER_CALL = 16
DEFAULT_LTL_GENS_PER_CALL = 2
DEFAULT_LTL_TILE = (128, 32)
MAX_LTL_BOUNDS = 32       # interval boundaries per set the LtL kernel takes
_SMEM_LIMIT = 232448      # bytes of shared memory one Hopper block may use
_MAX_GRID_Y = 65535

# Launches of each CUDA kernel in this process: its wrapper adds one per
# launch, nothing else touches them except a caller resetting them to 0.
KERNEL_LAUNCHES = 0        # B1, life_packed
GENERATIONS_LAUNCHES = 0   # B3, life_generations
LTL_LAUNCHES = 0           # B4, life_ltl

_libs: dict = {}


def _launch_plan(n: int, g: int) -> List[int]:
    """Generations per launch for ``n`` generations: ``n // g`` launches of
    ``g``, then one of ``n % g``."""
    n = int(n)
    if n < 0:
        raise ValueError(f"cannot step a negative number of generations: {n}")
    chunks, rem = divmod(n, g)
    return [g] * chunks + ([rem] if rem else [])


def _depth(gens_per_call: Optional[int], default: int) -> int:
    g = default if gens_per_call is None else int(gens_per_call)
    if not 1 <= g <= MAX_GENS_PER_CALL:
        raise ValueError(
            f"gens_per_call must be in 1..{MAX_GENS_PER_CALL}, got {g}")
    return g


def _fit_tile(tile: Tuple[int, int], smem) -> Tuple[int, int]:
    """``tile`` halved (the longer side first) until ``smem(th, tw)`` bytes
    fit in a block's shared memory."""
    th, tw = tile
    while smem(th, tw) > _SMEM_LIMIT and (th > 1 or tw > 1):
        if th >= tw:
            th = max(1, th // 2)
        else:
            tw = max(1, tw // 2)
    return th, tw


def _checked_tile(tile, smem, what: str) -> Tuple[int, int]:
    th, tw = int(tile[0]), int(tile[1])
    if th < 1 or tw < 1:
        raise ValueError(f"tile must be positive (rows, words), got {(th, tw)}")
    if smem(th, tw) > _SMEM_LIMIT:
        raise ValueError(
            f"tile {(th, tw)} needs {smem(th, tw)} bytes of shared memory "
            f"for {what}; a Hopper block has {_SMEM_LIMIT}")
    return th, tw


def _resolve(gens_per_call: Optional[int], tile: Optional[Tuple[int, int]]
             ) -> Tuple[int, int, int]:
    """(g, th, tw) of the binary 3x3 kernel."""
    g = _depth(gens_per_call, DEFAULT_GENS_PER_CALL)
    # two padded slabs of int32 words
    th, tw = _checked_tile(tile or DEFAULT_TILE,
                           lambda th, tw: 2 * (th + 2 * g) * (tw + 4) * 4,
                           f"{g} generations per call")
    return g, th, tw


def _resolve_generations(planes: int, gens_per_call: Optional[int],
                         tile: Optional[Tuple[int, int]]) -> Tuple[int, int, int]:
    """(g, th, tw) of the Generations kernel for ``planes`` bit-planes: the
    default tile shrinks until the 2*b padded slabs fit."""
    g = _depth(gens_per_call, DEFAULT_GENERATIONS_GENS_PER_CALL)

    def smem(th, tw):
        return 2 * planes * (th + 2 * g) * (tw + 4) * 4

    th, tw = _checked_tile(tile or _fit_tile(DEFAULT_TILE, smem), smem,
                           f"{planes} planes at {g} generations per call")
    return g, th, tw


def _halo_words(radius: int, g: int) -> int:
    return -(-radius * g // 32)


def _resolve_ltl(rule: LtLRule, gens_per_call: Optional[int],
                 tile: Optional[Tuple[int, int]]) -> Tuple[int, int, int]:
    """(g, th, tw) of the LtL kernel: halo ``r*g`` rows and
    ``ceil(r*g/32)`` words per side."""
    g = _depth(gens_per_call, DEFAULT_LTL_GENS_PER_CALL)
    r, hw = rule.radius, _halo_words(rule.radius, g)

    def smem(th, tw):
        return 2 * (th + 2 * r * g) * (tw + 2 * hw + 2) * 4

    th, tw = _checked_tile(tile or _fit_tile(DEFAULT_LTL_TILE, smem), smem,
                           f"radius {r} at {g} generations per call")
    return g, th, tw


def supported(shape, *, tile: Optional[Tuple[int, int]] = None) -> bool:
    """Whether the B/S kernel takes a packed ``(H, Wp)`` grid: any non-empty
    shape whose row tiles fit the launch grid (modulo indexing handles
    every torus, and tiles need not divide the grid)."""
    H, Wp = shape
    th = (tile or DEFAULT_TILE)[0]
    return H >= 1 and Wp >= 1 and -(-H // th) <= _MAX_GRID_Y


def supported_generations(shape, planes: int, *,
                          tile: Optional[Tuple[int, int]] = None,
                          gens_per_call: Optional[int] = None) -> bool:
    """Whether the Generations kernel takes ``planes`` bit-planes of a
    packed ``(H, Wp)`` grid: 2..8 planes (C = 3..256), a tile that fits in
    shared memory, and row tiles that fit the launch grid."""
    H, Wp = shape
    if not 2 <= planes <= 8 or H < 1 or Wp < 1:
        return False
    try:
        _, th, _ = _resolve_generations(planes, gens_per_call, tile)
    except ValueError:
        return False
    return -(-H // th) <= _MAX_GRID_Y


def _boundaries(intervals) -> List[int]:
    """Sorted interval boundaries lo, hi+1, ...: a count lies in the set
    iff an odd number of them are <= it."""
    return [b for lo, hi in intervals for b in (lo, hi + 1)]


def supported_ltl(shape, rule, *, tile: Optional[Tuple[int, int]] = None,
                  gens_per_call: Optional[int] = None) -> bool:
    """Whether the LtL kernel takes ``rule`` on a packed ``(H, Wp)`` grid:
    binary rules (C >= 3 has no kernel) with at most
    ``MAX_LTL_BOUNDS // 2`` intervals per set, a tile that fits in shared
    memory, and row tiles that fit the launch grid."""
    H, Wp = shape
    if (not isinstance(rule, LtLRule) or rule.states != 2 or H < 1 or Wp < 1
            or len(_boundaries(rule.born_intervals)) > MAX_LTL_BOUNDS
            or len(_boundaries(rule.survive_intervals)) > MAX_LTL_BOUNDS):
        return False
    try:
        _, th, _ = _resolve_ltl(rule, gens_per_call, tile)
    except ValueError:
        return False
    return -(-H // th) <= _MAX_GRID_Y


def _check(p: torch.Tensor, dims: int = 2) -> None:
    if not isinstance(p, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(p).__name__}")
    if p.dtype != torch.int32:
        raise TypeError(f"packed words must be int32, got {p.dtype}")
    if p.dim() != dims:
        want = "(H, W/32)" if dims == 2 else "(b, H, W/32)"
        raise ValueError(f"packed grid must be {dims}D {want}, got {tuple(p.shape)}")
    if not p.is_contiguous():
        raise ValueError("packed grid must be contiguous")


# -- plain versions ----------------------------------------------------------


def _tiles(p: torch.Tensor, hr: int, hw: int, th: int, tw: int,
           topology: Topology):
    """Every block's slab at once: ``(..., nty, ntx, th + 2*hr, tw + 2*hw)``
    words gathered with the kernel's indexing (rows and words modulo the
    grid for TORUS; zeros outside it for DEAD), with the in-grid row and
    word masks for DEAD (None for TORUS)."""
    H, Wp = p.shape[-2:]
    nty, ntx = -(-H // th), -(-Wp // tw)
    dev = p.device
    rows = (torch.arange(nty, device=dev) * th)[:, None] - hr \
        + torch.arange(th + 2 * hr, device=dev)           # (nty, L) grid rows
    cols = (torch.arange(ntx, device=dev) * tw)[:, None] - hw \
        + torch.arange(tw + 2 * hw, device=dev)           # (ntx, ww) grid words
    if topology is Topology.DEAD:
        row_in = (rows >= 0) & (rows < H)
        col_in = (cols >= 0) & (cols < Wp)
        slab = p[..., rows.clamp(0, H - 1)[:, None, :, None],
                 cols.clamp(0, Wp - 1)[None, :, None, :]]
        inside = row_in[:, None, :, None] & col_in[None, :, None, :]
        return torch.where(inside, slab, 0), (row_in, col_in)
    return p[..., (rows % H)[:, None, :, None], (cols % Wp)[None, :, None, :]], None


def _rezero(slab: torch.Tensor, masks, shrunk: int) -> torch.Tensor:
    """DEAD: zero the slab's rows and words outside the grid, ``shrunk``
    rows per side having been consumed so far."""
    if masks is None:
        return slab
    row_in, col_in = masks
    L = row_in.shape[1]
    inside = row_in[:, None, shrunk:L - shrunk, None] & col_in[None, :, None, :]
    return torch.where(inside, slab, 0)


def _untile(slab: torch.Tensor, hw: int, tw: int, H: int, Wp: int) -> torch.Tensor:
    """The blocks' ``(..., nty, ntx, th, ww)`` results cropped to their
    ``tw`` interior words and laid back into ``(..., H, Wp)``."""
    out = slab[..., hw:hw + tw]
    *lead, nty, ntx, th, _ = out.shape
    out = out.transpose(-3, -2).reshape(*lead, nty * th, ntx * tw)
    return out[..., :H, :Wp].contiguous()


def _launch_reference(p: torch.Tensor, gens: int, rule: Rule,
                      topology: Topology, th: int, tw: int) -> torch.Tensor:
    """One B1 launch in plain torch: every tile at once as a batch."""
    H, Wp = p.shape
    slab, masks = _tiles(p, gens, 1, th, tw, topology)
    for k in range(gens):
        slab = step_packed_slab(_rezero(slab, masks, k), rule, Topology.DEAD)
    return _untile(slab, 1, tw, H, Wp)


def multi_step_reference(
    p: torch.Tensor,
    n: int,
    *,
    rule: Rule,
    topology: Topology = Topology.TORUS,
    gens_per_call: Optional[int] = None,
    tile: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """``n`` generations by the B1 kernel's algorithm in plain torch, on any
    device: ``n // g`` launches of ``g`` generations, then one of ``n % g``."""
    _check(p)
    g, th, tw = _resolve(gens_per_call, tile)
    for gens in _launch_plan(n, g):
        p = _launch_reference(p, gens, rule, topology, th, tw)
    return p


def _generations_launch_reference(planes: torch.Tensor, gens: int,
                                  rule: GenRule, topology: Topology,
                                  th: int, tw: int) -> torch.Tensor:
    """One B3 launch in plain torch: every tile of every plane at once."""
    b, H, Wp = planes.shape
    slab, masks = _tiles(planes, gens, 1, th, tw, topology)
    for k in range(gens):
        slab = _rezero(slab, masks, k)
        slab = torch.stack(step_planes_slab(
            tuple(slab[j] for j in range(b)), rule, Topology.DEAD))
    return _untile(slab, 1, tw, H, Wp)


def multi_step_generations_reference(
    planes: torch.Tensor,
    n: int,
    *,
    rule: GenRule,
    topology: Topology = Topology.TORUS,
    gens_per_call: Optional[int] = None,
    tile: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """``n`` generations by the B3 kernel's algorithm in plain torch on a
    ``(b, H, W/32)`` stack, on any device."""
    _check_generations(planes, rule)
    g, th, tw = _resolve_generations(planes.shape[0], gens_per_call, tile)
    for gens in _launch_plan(n, g):
        planes = _generations_launch_reference(planes, gens, rule, topology,
                                               th, tw)
    return planes


def _ltl_launch_reference(p: torch.Tensor, gens: int, rule: LtLRule,
                          topology: Topology, th: int, tw: int) -> torch.Tensor:
    """One B4 launch in plain torch: every tile at once as a batch."""
    H, Wp = p.shape
    r, hw = rule.radius, _halo_words(rule.radius, gens)
    slab, masks = _tiles(p, r * gens, hw, th, tw, topology)
    for k in range(gens):
        slab = step_ltl_packed_slab(_rezero(slab, masks, r * k), rule,
                                    Topology.DEAD)
    return _untile(slab, hw, tw, H, Wp)


def multi_step_ltl_reference(
    p: torch.Tensor,
    n: int,
    *,
    rule: LtLRule,
    topology: Topology = Topology.TORUS,
    gens_per_call: Optional[int] = None,
    tile: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """``n`` generations by the B4 kernel's algorithm in plain torch, on
    any device."""
    _check_ltl(p, rule)
    g, th, tw = _resolve_ltl(rule, gens_per_call, tile)
    for gens in _launch_plan(n, g):
        p = _ltl_launch_reference(p, gens, rule, topology, th, tw)
    return p


def _check_generations(planes: torch.Tensor, rule: GenRule) -> None:
    _check(planes, dims=3)
    if planes.shape[0] != n_planes(rule.states):
        raise ValueError(
            f"{rule.notation} needs {n_planes(rule.states)} bit-planes, got "
            f"a stack of {planes.shape[0]}")


def _check_ltl(p: torch.Tensor, rule: LtLRule) -> None:
    _check(p)
    if rule.states != 2:
        raise ValueError(
            f"the LtL kernel is binary (1 bit/cell); {rule.notation} has "
            f"{rule.states} states")


# -- kernels -----------------------------------------------------------------


def _library(name: str, argtypes):
    """The built ``csrc/<name>.cu`` with its launch function typed."""
    lib = _libs.get(name)
    if lib is None:
        from .. import _build

        lib = _build.load(name).lib
        launch = getattr(lib, f"{name}_launch")
        launch.argtypes = argtypes
        launch.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def _raise_on(lib, name: str, err: int) -> None:
    if err != 0:
        message = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {message} (cudaError {err})")


_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(lib, src: torch.Tensor, dst: torch.Tensor, gens: int, rule: Rule,
            topology: Topology, th: int, tw: int) -> None:
    global KERNEL_LAUNCHES
    H, Wp = src.shape
    err = lib.life_packed_launch(
        src.data_ptr(), dst.data_ptr(), H, Wp, gens, th, tw,
        rule.birth_mask, rule.survive_mask, int(topology is Topology.DEAD),
        _stream(src))
    _raise_on(lib, "life_packed", err)
    KERNEL_LAUNCHES += 1


def _launch_generations(lib, src, dst, gens, rule: GenRule, topology, th, tw):
    global GENERATIONS_LAUNCHES
    b, H, Wp = src.shape
    err = lib.life_generations_launch(
        src.data_ptr(), dst.data_ptr(), b, H, Wp, gens, th, tw,
        rule.birth_mask, rule.survive_mask, rule.states,
        int(topology is Topology.DEAD), _stream(src))
    _raise_on(lib, "life_generations", err)
    GENERATIONS_LAUNCHES += 1


def _launch_ltl(lib, src, dst, gens, rule: LtLRule, topology, th, tw):
    global LTL_LAUNCHES
    H, Wp = src.shape
    born = _boundaries(rule.born_intervals)
    surv = _boundaries(rule.survive_intervals)
    err = lib.life_ltl_launch(
        src.data_ptr(), dst.data_ptr(), H, Wp, gens, th, tw,
        _halo_words(rule.radius, gens), rule.radius,
        int(rule.neighborhood == "N"), int(rule.middle),
        len(born), (ctypes.c_int * max(1, len(born)))(*born),
        len(surv), (ctypes.c_int * max(1, len(surv)))(*surv),
        int(topology is Topology.DEAD), _stream(src))
    _raise_on(lib, "life_ltl", err)
    LTL_LAUNCHES += 1


def _run(p: torch.Tensor, plan: List[int], launch) -> torch.Tensor:
    """The launches of ``plan``, ping-ponging between two new buffers on
    the current stream (``p`` itself is left as it was)."""
    if not plan:
        return p
    bufs = (torch.empty_like(p), torch.empty_like(p))
    src = p
    with torch.cuda.device(p.device):
        for i, gens in enumerate(plan):
            dst = bufs[i % 2]
            launch(src, dst, gens)
            src = dst
    return src


def _on_card(p: torch.Tensor, ok: bool, why: str) -> None:
    """A wrapper's device test after its CPU branch: CUDA and a shape the
    kernel takes, or raise."""
    if p.device.type != "cuda":
        raise ValueError(f"no kernel for device {p.device}")
    if not ok:
        raise ValueError(why)


def multi_step_kernel(
    p: torch.Tensor,
    n: int,
    *,
    rule: Rule,
    topology: Topology = Topology.TORUS,
    gens_per_call: Optional[int] = None,
    tile: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Advance the packed int32 grid ``p`` by ``n`` generations of a B/S
    rule.

    On a CUDA tensor: ``n // g`` launches of the Hopper kernel, then one of
    ``n % g`` generations, ping-ponging between two new buffers on the
    current stream (``p`` itself is left as it was). On a CPU tensor: the
    plain version, :func:`multi_step_reference`. Any other device raises."""
    _check(p)
    g, th, tw = _resolve(gens_per_call, tile)
    if p.device.type == "cpu":
        return multi_step_reference(p, n, rule=rule, topology=topology,
                                    gens_per_call=g, tile=(th, tw))
    _on_card(p, supported(p.shape, tile=(th, tw)),
             f"packed shape {tuple(p.shape)} exceeds the kernel's launch grid "
             f"at tile {(th, tw)}")
    plan = _launch_plan(n, g)
    lib = _library("life_packed", [_P, _P, _I, _I, _I, _I, _I, _U, _U, _I, _P]) \
        if plan else None
    return _run(p, plan, lambda src, dst, gens: _launch(
        lib, src, dst, gens, rule, topology, th, tw))


def multi_step_generations_kernel(
    planes: torch.Tensor,
    n: int,
    *,
    rule: GenRule,
    topology: Topology = Topology.TORUS,
    gens_per_call: Optional[int] = None,
    tile: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Advance the ``(b, H, W/32)`` int32 bit-plane stack of a Generations
    rule by ``n`` generations: the counterpart of
    ``multi_step_pallas_generations``.

    On a CUDA tensor: ``n // g`` launches of the Hopper kernel, then one of
    ``n % g`` generations (``planes`` itself is left as it was). On a CPU
    tensor: the plain version, :func:`multi_step_generations_reference`.
    Any other device raises."""
    _check_generations(planes, rule)
    b = planes.shape[0]
    g, th, tw = _resolve_generations(b, gens_per_call, tile)
    if planes.device.type == "cpu":
        return multi_step_generations_reference(
            planes, n, rule=rule, topology=topology, gens_per_call=g,
            tile=(th, tw))
    _on_card(planes, supported_generations(planes.shape[1:], b, tile=(th, tw),
                                           gens_per_call=g),
             f"plane stack {tuple(planes.shape)} exceeds the Generations "
             f"kernel's launch grid at tile {(th, tw)}")
    plan = _launch_plan(n, g)
    lib = _library("life_generations",
                   [_P, _P, _I, _I, _I, _I, _I, _I, _U, _U, _U, _I, _P]) \
        if plan else None
    return _run(planes, plan, lambda src, dst, gens: _launch_generations(
        lib, src, dst, gens, rule, topology, th, tw))


def multi_step_ltl_kernel(
    p: torch.Tensor,
    n: int,
    *,
    rule: LtLRule,
    topology: Topology = Topology.TORUS,
    gens_per_call: Optional[int] = None,
    tile: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Advance the packed int32 grid ``p`` by ``n`` generations of a binary
    Larger-than-Life rule: the counterpart of ``multi_step_ltl_pallas``.

    On a CUDA tensor: ``n // g`` launches of the Hopper kernel, then one of
    ``n % g`` generations (``p`` itself is left as it was). On a CPU
    tensor: the plain version, :func:`multi_step_ltl_reference`. Any other
    device raises."""
    _check_ltl(p, rule)
    g, th, tw = _resolve_ltl(rule, gens_per_call, tile)
    if p.device.type == "cpu":
        return multi_step_ltl_reference(p, n, rule=rule, topology=topology,
                                        gens_per_call=g, tile=(th, tw))
    _on_card(p, supported_ltl(p.shape, rule, tile=(th, tw), gens_per_call=g),
             f"the LtL kernel cannot take {rule.notation} on packed shape "
             f"{tuple(p.shape)} at tile {(th, tw)} (at most "
             f"{MAX_LTL_BOUNDS // 2} intervals per set)")
    plan = _launch_plan(n, g)
    lib = _library("life_ltl", [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                _I, _P, _I, _P, _I, _P]) if plan else None
    return _run(p, plan, lambda src, dst, gens: _launch_ltl(
        lib, src, dst, gens, rule, topology, th, tw))
