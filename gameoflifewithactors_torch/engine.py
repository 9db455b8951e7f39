"""Device-side simulation engine: owns the grid tensor and steps it.

Counterpart of ``gameoflifewithactors_tpu.engine`` for life-like (B/S),
Generations and Larger-than-Life rules, on one device or on a mesh. The
state is one tensor — bit-packed int32 words, a ``(b, H, W/32)`` bit-plane
stack for multi-state rules, or one byte per cell on the dense path — or,
with a mesh, that tensor placed on the mesh (:mod:`.parallel.mesh`),
stepped by a hand-written CUDA kernel (:mod:`.ops.cuda_stencil`; with a
mesh the band runners of :mod:`.parallel.sharded`) or by plain PyTorch.
``step`` only enqueues work on the current CUDA stream; data comes back to
the host only when :meth:`Engine.snapshot` or :meth:`Engine.population`
asks for it. The activity-tiled backends are the exception: ``"sparse"``
(:mod:`.ops.sparse`) reads one candidate count per chunk (with a mesh,
every shard's count in one transfer per generation), ``"paged"``
(:mod:`.memory`) its page flags per chunk, as in the JAX package.

Entry points run on ``"cuda"`` unless the caller passes ``device="cpu"``.
Without a device and without CUDA, the constructor raises: it never runs
on the CPU unasked.
"""

from __future__ import annotations

from typing import Optional, Tuple

import warnings

import numpy as np
import torch

from .analysis import sanitizers
from .aot import cache as aot_cache
from .aot import registry as aot_registry
from .models.elementary import ElementaryRule
from .models.generations import GenRule, parse_any
from .models.ltl import LtLRule
from .models.rules import Rule
from .obs import profiler as obs_profiler
from .obs import spans as obs_spans
from .obs.cost import packed_cost
from .ops import bitpack, cuda_stencil
from .ops.generations import multi_step_generations
from .ops.ltl import multi_step_ltl
from .ops.packed import multi_step_packed
from .ops.packed_generations import (
    multi_step_packed_generations,
    n_planes,
    pack_generations_for,
    population_packed_generations,
    unpack_generations,
)
from .ops.packed_ltl import multi_step_ltl_packed, multi_step_ltl_planes
from .ops.sparse import (
    DEFAULT_TILE_ROWS,
    DEFAULT_TILE_WORDS,
    SparseEngineState,
    _wake_dilation,
    auto_tile,
)
from .ops.stencil import Topology, multi_step
from .parallel import sharded
from .parallel.halo import exchanged_bytes
from .parallel.mesh import (
    COL_AXIS,
    ROW_AXIS,
    Mesh,
    device_put_sharded_grid,
    ghost_fits,
)
from .utils.interop import state_from_numpy

BACKENDS = ("packed", "dense", "cuda", "sparse", "paged")
_TILED_BACKENDS = ("sparse", "paged")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` as given, else CUDA.
    Raises when CUDA is asked for (or defaulted to) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; gameoflifewithactors_torch runs on "
            "the GPU unless told otherwise -- pass device='cpu' (CLI: "
            "--device cpu) to run the plain PyTorch path on the CPU")
    return dev


def placement_device(device=None, mesh: Optional[Mesh] = None) -> torch.device:
    """Where an entry point builds its grid: ``device`` as
    :func:`resolve_device` reads it, or, with a mesh, the mesh's first
    device (``device``, if given, must be of the mesh's type)."""
    if mesh is None:
        return resolve_device(device)
    home = mesh.devices.flat[0]
    if device is not None and torch.device(device).type != home.type:
        raise ValueError(f"device {device} is not where mesh {mesh} lives")
    return home


def _chunked(bulk, pergen, g: int):
    """``(state, n)`` runner: ``n // g`` chunks through ``bulk`` (``(state,
    chunks)``), the ``n % g`` remainder through the per-generation
    ``pergen``."""
    def run(state, n):
        chunks, rem = divmod(int(n), g)
        if chunks:
            state = bulk(state, chunks)
        if rem:
            state = pergen(state, rem)
        return state
    return run


def _kernels_run_on(device: torch.device) -> bool:
    """Whether the CUDA kernels can step a state that lives on
    ``device``."""
    return device.type == "cuda"


def _kernel_takes(rule, h: int, wp: int) -> bool:
    """Whether a CUDA kernel serves ``rule`` on a packed (h, wp) grid."""
    if isinstance(rule, GenRule):
        return cuda_stencil.supported_generations((h, wp), n_planes(rule.states))
    if isinstance(rule, LtLRule):
        return cuda_stencil.supported_ltl((h, wp), rule)
    return cuda_stencil.supported((h, wp))


def default_gens_per_exchange(rule) -> int:
    """The band runners' default chunk: the rule family's kernel default
    from the sweeps on the card (8 for B/S, 16 for Generations, 4 for
    Larger than Life)."""
    if isinstance(rule, GenRule):
        return cuda_stencil.DEFAULT_GENERATIONS_GENS_PER_CALL
    if isinstance(rule, LtLRule):
        return cuda_stencil.DEFAULT_LTL_GENS_PER_CALL
    return cuda_stencil.DEFAULT_BAND_GENS_PER_CALL


def _band_kernel_takes(rule, h: int, wp: int, mesh: Mesh, g: int,
                       depth_fits: bool = True) -> bool:
    """Whether the slab kernel of ``rule``'s family takes the bands of a
    packed (h, wp) grid over the flattened ``mesh`` at ``g`` generations
    per chunk: whole bands, a chunk's exchange no deeper than a band
    (unless ``depth_fits`` is False) and the kernel's limits on the
    extended band batch each device launches."""
    nb = mesh.size
    if h % nb:
        return False
    rows = h // nb
    depth = g * (rule.radius if isinstance(rule, LtLRule) else 1)
    if depth_fits and depth > rows:
        return False
    ext = (rows + 2 * depth, wp)
    batch = max(len(positions) for _, positions in mesh.groups)
    if isinstance(rule, GenRule):
        return cuda_stencil.supported_generations_slab(
            ext, n_planes(rule.states), g, batch=batch)
    if isinstance(rule, LtLRule):
        return cuda_stencil.supported_ltl_slab(ext, rule, g, batch=batch)
    return cuda_stencil.supported_slab(ext, g, batch=batch)


class Engine:
    """Steps a cellular-automaton grid on one device.

    Parameters
    ----------
    grid: (H, W) uint8 array-like or tensor -- the initial universe, with
        states 0..C-1 (0 or 1 for binary rules). It is copied: the engine
        never aliases the caller's buffer.
    rule: a rule or rule string: life-like ("B3/S23", "highlife", ...),
        Generations ("B2/S/C3", "brain", ...) or Larger than Life
        ("R5,C0,M1,S34..58,B34..45", "bosco", ...).
    topology: TORUS (wrap) or DEAD (all-dead boundary).
    backend: "auto" (default: on CUDA the rule's kernel for widths that
        pack into 32-cell words, except multi-state LtL, which no kernel
        serves and which takes "packed"; "dense" for other widths. On the
        CPU what the JAX package picks off its TPU: "packed" for B/S and
        Generations, "dense" for binary LtL, "packed" for multi-state LtL
        with a diamond or a box of radius <= 3; "dense" for widths that do
        not pack), "cuda" (the temporal-blocked Hopper kernel of the
        rule's family), "packed" (32 cells/word SWAR in plain torch; a
        bit-plane stack for multi-state rules) or "dense" (1 byte/cell).
        "sparse" (activity-tiled: only the tiles whose neighbourhood
        changed step, :mod:`.ops.sparse`) and "paged" (page-table grids over
        a tile pool, :mod:`.memory`) store the packed layout and step it in
        plain torch; "auto" never picks them. With a mesh: "cuda" is the
        band runner of the rule's family
        (full-width row bands over the flattened mesh, one slab-kernel
        launch per device and chunk), which "auto" picks on CUDA wherever
        the slab kernel takes the band shape; asked for by name on a mesh
        of CPU positions, the band runner's wrappers run the kernels'
        plain versions (single-grid "cuda" needs a CUDA device); "packed" and "dense" step 2D
        tiles in plain torch, one halo exchange per generation ("packed"
        with ``gens_per_exchange`` G > 1: one per G generations, through
        the ghost-zone pipeline where the tile holds its rings, else the
        deep runner); "sparse" steps the active tiles of every shard
        (tiles fitted to the local shard).
    device: "cuda" (default) or "cpu"; with a mesh, the mesh's devices
        (``device``, if given, must be of their type).
    mesh: a :class:`.parallel.mesh.Mesh` to shard the grid over, or None.
    gens_per_exchange: with a mesh and backend "cuda", generations per
        chunk (one row exchange and one kernel launch each), 1..32; None is
        the family's kernel default (8 B/S, 16 Generations, 4 LtL). With a
        mesh, backend "packed" and a B/S rule, generations per halo
        exchange (default 1).
    sparse_opts: for "sparse" and "paged", the tiling: ``tile_rows``,
        ``tile_words``, ``capacity`` and ``chunk_gens`` (the JAX engine's
        keys and defaults).
    """

    def __init__(
        self,
        grid,
        rule: "Rule | GenRule | LtLRule | str",
        *,
        topology: Topology = Topology.TORUS,
        backend: str = "auto",
        device=None,
        mesh: Optional[Mesh] = None,
        gens_per_exchange: Optional[int] = None,
        sparse_opts: Optional[dict] = None,
    ):
        shape = tuple(grid.shape) if isinstance(grid, torch.Tensor) \
            else np.shape(grid)
        if len(shape) != 2:
            raise ValueError(f"grid must be 2D, got shape {shape}")
        # warm start (aot/): every kernel built below lands in the cache
        # root (GOLTPU_CACHE_DIR; default gameoflifewithactors_torch/_build)
        aot_cache.ensure_persistent_cache()
        self._configure(rule, topology, backend, device, mesh, shape,
                        gens_per_exchange, sparse_opts)
        self._adopt(self._encode(self._cells(grid)))
        self._warm_start()

    @classmethod
    def from_packed(
        cls,
        words,
        rule: "Rule | GenRule | LtLRule | str",
        *,
        topology: Topology = Topology.TORUS,
        backend: str = "auto",
        device=None,
        mesh: Optional[Mesh] = None,
        sparse_opts: Optional[dict] = None,
    ) -> "Engine":
        """An engine whose state is the given packed words: a host
        ``(H, W/32)`` uint32 array such as ``np.asarray(jax_engine.state)``,
        or a ``(b, H, W/32)`` bit-plane stack for a multi-state rule, or an
        int32 tensor of either shape, placed on ``mesh`` if one is given.
        A run handed over mid-way (or read back from a checkpoint)
        continues bit for bit."""
        if isinstance(words, torch.Tensor):
            if words.dtype != torch.int32 or words.dim() not in (2, 3):
                raise TypeError("packed words must be a 2D or 3D int32 tensor")
            packed = words
        else:
            packed = state_from_numpy(words)
        aot_cache.ensure_persistent_cache()
        self = cls.__new__(cls)
        h, wp = packed.shape[-2:]
        self._configure(rule, topology, backend, device, mesh,
                        (h, wp * bitpack.WORD), sparse_opts=sparse_opts)
        want = n_planes(self._states) if self._states > 2 else None
        have = packed.shape[0] if packed.dim() == 3 else None
        if want != have:
            raise ValueError(
                f"{self.rule.notation} takes "
                + (f"a ({want}, H, W/32) bit-plane stack" if want
                   else "(H, W/32) words")
                + f", got shape {tuple(packed.shape)}")
        packed = packed.to(self.device, copy=True)
        if self._layout == "dense":
            packed = unpack_generations(packed) if want else \
                bitpack.unpack(packed)
        self._adopt(packed)
        self._warm_start()
        return self

    def _configure(self, rule, topology: Topology, backend: str, device,
                   mesh: Optional[Mesh], shape: Tuple[int, int],
                   gens_per_exchange: Optional[int] = None,
                   sparse_opts: Optional[dict] = None) -> None:
        self.rule = parse_any(rule)
        if isinstance(self.rule, ElementaryRule):
            raise ValueError(
                f"{self.rule.notation} is a 1D (elementary) rule; the Engine "
                "drives 2D grids. Use the CLI spacetime route "
                "(python -m gameoflifewithactors_torch --rule "
                f"{self.rule.notation} --render final), or ops.elementary "
                "directly: multi_step_elementary / evolve_spacetime on a "
                "packed row (see examples/wolfram.py)")
        if mesh is not None and backend == "paged":
            raise ValueError(
                "the paged backend is single-device (its page tables are "
                "host bookkeeping over one pool slab); use backend="
                "'sparse' for sharded activity skipping")
        if backend not in BACKENDS and backend != "auto":
            raise ValueError(
                f"backend must be 'auto' or one of {BACKENDS}, got {backend!r}")
        if gens_per_exchange is not None and gens_per_exchange < 1:
            raise ValueError(
                f"gens_per_exchange must be >= 1, got {gens_per_exchange}")
        self.device = placement_device(device, mesh)
        self.mesh = mesh
        self._states = getattr(self.rule, "states", 2)
        h, w = shape
        # with a mesh, 2D tiles shard the width: whole words per mesh column
        ny = 1 if mesh is None else mesh.shape[COL_AXIS]
        packs = w % (bitpack.WORD * ny) == 0
        ltl_planes = isinstance(self.rule, LtLRule) and self._states > 2
        g = gens_per_exchange or default_gens_per_exchange(self.rule)
        if backend == "auto":
            backend = self._resolve_auto(h, w, packs, ltl_planes, g)
        binary3 = not isinstance(self.rule, (GenRule, LtLRule))
        if gens_per_exchange not in (None, 1) and not (
                mesh is not None
                and (backend == "cuda" or (backend == "packed" and binary3))):
            raise ValueError(
                "gens_per_exchange applies to the sharded packed and cuda "
                "backends only (mesh + backend='packed'/'cuda'/'auto' for "
                "3x3 binary rules, mesh + backend='cuda' for Generations "
                "and LtL)")
        if backend in _TILED_BACKENDS:
            self._check_tiled(backend, h, w, packs, sparse_opts, ny)
        if mesh is not None:
            self._check_mesh(h, w, backend)
        if backend == "cuda":
            # on a mesh of CPU positions the band runner's kernel wrappers
            # run their plain versions, as the JAX engine runs "pallas" in
            # interpret mode off its TPU; a single grid asks for the card
            if mesh is None and not _kernels_run_on(self.device):
                raise ValueError(
                    "backend 'cuda' launches the CUDA kernel and needs a CUDA "
                    f"device, got {self.device}")
            if ltl_planes:
                raise ValueError(
                    f"backend 'cuda' has no kernel for {self.rule.notation}: "
                    "multi-state Larger than Life runs on 'packed' or 'dense'")
            wp = w // bitpack.WORD
            if mesh is not None:
                # a chunk deeper than a band raises when it runs, as the
                # JAX runner does at trace time
                ok = _band_kernel_takes(self.rule, h, wp, mesh, g,
                                        depth_fits=False)
            else:
                ok = w % bitpack.WORD == 0 and _kernel_takes(self.rule, h, wp)
            if not ok:
                raise ValueError(
                    f"backend 'cuda' cannot take {self.rule.notation} on a "
                    f"{h}x{w} grid (the width must be a multiple of "
                    f"{bitpack.WORD})")
        if backend == "packed" and not packs and mesh is None:
            raise ValueError(
                f"backend 'packed' needs a width that is a multiple of "
                f"{bitpack.WORD}, got {w}")
        self._sparse_opts = dict(sparse_opts or {})
        self.topology = topology
        self.backend = backend
        self.gens_per_exchange = g if mesh is not None and backend == "cuda" \
            else (gens_per_exchange or 1)
        self.shape: Tuple[int, int] = (int(h), int(w))
        self.generation = 0
        # "words": (H, W/32) bits; "planes": (b, H, W/32) state bit-planes
        if backend == "dense":
            self._layout = "dense"
        else:
            self._layout = "planes" if self._states > 2 else "words"
        self._sparse = None   # the "sparse"/"paged" state, once adopted
        self._flags = None    # a mesh "sparse" engine's placed tile map
        self._sparse_tiles = None
        self._ghost_pipeline = False   # the width-G ghost-zone runner in use
        self._one_chunk = None   # mesh "packed" G > 1: one unaccounted chunk
        self._halo_measured = None
        self._runner = None if mesh is None else self._mesh_runner()

    def _check_tiled(self, backend: str, h: int, w: int, packs: bool,
                     sparse_opts: Optional[dict], ny: int) -> None:
        """The JAX engine's width and tile checks of the activity-tiled
        backends, in cell units, with its messages (a mesh's ``ny``
        columns shard the words; its divisibility and the shard's tiles
        are checked by :meth:`_check_mesh` and :meth:`_mesh_sparse_tiles`)."""
        if not packs:
            if isinstance(self.rule, GenRule):
                raise ValueError(
                    f"the {backend} backend stores Generations universes as "
                    f"bit-plane stacks: width {w} must shard into whole "
                    f"32-cell words over {ny} mesh column(s) (divisible by "
                    f"{bitpack.WORD * ny})")
            if isinstance(self.rule, LtLRule):
                raise ValueError(
                    f"{backend} LtL needs a width divisible by "
                    f"{bitpack.WORD * ny} (32-cell words must shard whole "
                    f"over {ny} mesh column(s)), got {self.rule.notation} on "
                    f"{(h, w)}; use backend='dense'")
            if self.mesh is None:
                raise ValueError(
                    f"backend {backend!r} needs a width that is a multiple "
                    f"of {bitpack.WORD}, got {w}")
        opts = dict(sparse_opts or {})
        if self.mesh is None and backend == "sparse" and (
                "tile_rows" in opts or "tile_words" in opts):
            # without explicit tiles SparseEngineState auto-tiles divisibly
            tr = opts.get("tile_rows", DEFAULT_TILE_ROWS)
            tw = opts.get("tile_words", DEFAULT_TILE_WORDS)
            if h % tr or w % (bitpack.WORD * tw):
                raise ValueError(
                    f"grid {(h, w)} not divisible into sparse tiles of "
                    f"{tr} x {bitpack.WORD * tw} cells; pass sparse_opts="
                    f"dict(tile_rows=..., tile_words=...) that divide it")

    def _check_mesh(self, h: int, w: int, backend: str) -> None:
        """The JAX engine's divisibility and radius checks, in cell units,
        with its messages."""
        nx, ny = self.mesh.shape[ROW_AXIS], self.mesh.shape[COL_AXIS]
        nb = nx * ny
        if backend == "cuda":
            # band path: nx*ny full-width bands; the width is not sharded
            if h % nb or w % bitpack.WORD:
                raise ValueError(
                    f"grid {(h, w)} not divisible into {nb} full-width row "
                    f"bands over mesh ({nx}, {ny}): need height % {nb} == 0 "
                    f"and width % {bitpack.WORD} == 0 (band-kernel path)")
        else:
            packed = backend in ("packed", "sparse")
            wq = bitpack.WORD * ny if packed else ny
            if h % nx or w % wq:
                raise ValueError(
                    f"grid {(h, w)} not divisible over mesh ({nx}, {ny}): "
                    f"need height % {nx} == 0 and width % {wq} == 0"
                    + (" (bit-packed backends shard 32-cell words)"
                       if packed and self._states == 2 else ""))
        if isinstance(self.rule, LtLRule):
            r = self.rule.radius
            if backend == "cuda":
                if h // nb < r:
                    raise ValueError(
                        f"{h // nb}-row bands over the flattened ({nx}, {ny}) "
                        f"mesh are smaller than the rule radius {r}: halo "
                        "exchange needs depth <= band height; use fewer "
                        "devices")
            elif h // nx < r or w // ny < r:
                raise ValueError(
                    f"mesh tiles {h // nx}x{w // ny} smaller than the rule "
                    f"radius {r}: halo exchange needs depth <= tile size; use "
                    "fewer devices")

    def _mesh_sparse_tiles(self) -> Tuple[int, int]:
        """The per-shard sparse tiles: ``sparse_opts`` or
        :func:`.ops.sparse.auto_tile` of the LOCAL shard, which they must
        divide (the JAX engine's check and message)."""
        nx, ny = self.mesh.shape[ROW_AXIS], self.mesh.shape[COL_AXIS]
        local_h = self.shape[0] // nx
        local_w = self.shape[1] // bitpack.WORD // ny
        auto_tr, auto_tw = auto_tile(local_h, local_w)
        tr = self._sparse_opts.get("tile_rows", auto_tr)
        tw = self._sparse_opts.get("tile_words", auto_tw)
        if local_h % tr or local_w % tw:
            raise ValueError(
                f"per-device shard {local_h}x{local_w * bitpack.WORD} cells "
                f"not divisible into sparse tiles of {tr}x"
                f"{tw * bitpack.WORD} cells; pick sparse tile dims that "
                "divide the shard (or omit them to auto-tile)")
        return tr, tw

    def _tiled_sparse_runner(self):
        """A new per-tile sharded sparse runner at the engine's tiles (one
        maker serves words and plane stacks)."""
        tr, tw = self._sparse_tiles
        return sharded.make_multi_step_packed_sparse_tiled(
            self.mesh, self.rule, self.topology, tile_rows=tr, tile_words=tw,
            capacity=self._sparse_opts.get("capacity"))

    def _mesh_runner(self):
        """The sharded runner of the backend and the rule's family."""
        mesh, rule, topology = self.mesh, self.rule, self.topology
        if self.backend == "sparse":
            self._sparse_tiles = self._mesh_sparse_tiles()
            run2 = self._tiled_sparse_runner()

            def run(state, n):
                state, self._flags = run2(state, self._flags, n)
                return state
            run.stats = run2.stats   # host reads, per-shard capacity
            return run
        if self.backend == "cuda":
            if isinstance(rule, GenRule):
                make = sharded.make_multi_step_generations_kernel
            elif isinstance(rule, LtLRule):
                make = sharded.make_multi_step_ltl_kernel
            else:
                make = sharded.make_multi_step_kernel
            return make(mesh, rule, topology, self.gens_per_exchange)
        dense = self._layout == "dense"
        if isinstance(rule, GenRule):
            make = (sharded.make_multi_step_generations if dense
                    else sharded.make_multi_step_generations_packed)
        elif isinstance(rule, LtLRule):
            make = (sharded.make_multi_step_ltl if dense
                    else sharded.make_multi_step_ltl_planes if self._states > 2
                    else sharded.make_multi_step_ltl_packed)
        else:
            make = (sharded.make_multi_step_dense if dense
                    else sharded.make_multi_step_packed)
        pergen = make(mesh, rule, topology)
        g = self.gens_per_exchange
        if self.backend != "packed" or g == 1:
            return pergen
        # communication-avoiding: bulk chunks through the width-G ghost-zone
        # pipeline where the tile holds its rings, else the depth-G runner
        nx, ny = mesh.shape[ROW_AXIS], mesh.shape[COL_AXIS]
        h, wp = self.shape[0] // nx, self.shape[1] // bitpack.WORD // ny
        if ghost_fits(h, wp, g):
            bulk = sharded.make_multi_step_packed_ghost(
                mesh, rule, topology, gens_per_exchange=g)
            self._ghost_pipeline = True
            self._one_chunk = sharded.make_multi_step_packed_ghost(
                mesh, rule, topology, gens_per_exchange=g, unroll_chunks=1)
        else:
            bulk = sharded.make_multi_step_packed_deep(
                mesh, rule, topology, gens_per_exchange=g)
            self._one_chunk = lambda state: bulk(state, 1)
        return _chunked(bulk, pergen, g)

    def _resolve_auto(self, h: int, w: int, packs: bool,
                      ltl_planes: bool, g: int) -> str:
        on_card = _kernels_run_on(self.device)
        if self.mesh is not None:
            if (on_card and not ltl_planes and w % bitpack.WORD == 0
                    and _band_kernel_takes(self.rule, h, w // bitpack.WORD,
                                           self.mesh, g)):
                return "cuda"
            if on_card or not isinstance(self.rule, LtLRule):
                return "packed" if packs else "dense"
        if not packs:
            return "dense"
        if on_card:
            if ltl_planes:   # no kernel serves multi-state LtL
                return "packed"
            return "cuda" if _kernel_takes(self.rule, h, w // bitpack.WORD) \
                else "dense"
        if isinstance(self.rule, LtLRule):
            # the JAX package's choice off its TPU: binary LtL on the byte
            # path; C >= 3 on the plane stack for diamonds and box radius
            # <= 3, else the byte path
            if ltl_planes and (self.rule.neighborhood == "N"
                               or self.rule.radius <= 3):
                return "packed"
            return "dense"
        return "packed"

    def _cells(self, grid) -> torch.Tensor:
        """The grid as a new uint8 tensor on the engine's device, checked."""
        if isinstance(grid, torch.Tensor):
            cells = grid.to(self.device, torch.uint8, copy=True)
        else:
            # copy: torch.from_numpy aliases the caller's buffer
            host = np.array(grid, dtype=np.uint8, copy=True)
            cells = torch.from_numpy(host).to(self.device)
        if tuple(cells.shape) != self.shape:
            raise ValueError(
                f"grid shape {tuple(cells.shape)} != engine shape {self.shape}")
        top = int(cells.max()) if cells.numel() else 0
        if top >= self._states:
            raise ValueError(
                f"grid holds state {top} but rule {self.rule.notation} "
                + (f"has only states 0..{self._states - 1}" if self._states > 2
                   else "is binary: cells must be 0 or 1"))
        return cells

    def _encode(self, cells: torch.Tensor) -> torch.Tensor:
        if self._layout == "planes":
            return pack_generations_for(cells, self.rule)
        return bitpack.pack(cells) if self._layout == "words" else cells

    def _adopt(self, state: torch.Tensor) -> None:
        """Make the encoded ``state`` the engine's: placed on the mesh (a
        mesh "sparse" engine seeds its tile map from it), or held by the
        sparse or paged state."""
        if self.mesh is not None:
            self._state = self._place(state)
            if self.backend == "sparse":
                self._flags = sharded.initial_tile_activity(
                    self._state, self.mesh, *self._sparse_tiles)
            return
        if self.backend == "sparse":
            self._sparse = SparseEngineState(
                state, self.rule, topology=self.topology, **self._sparse_opts)
        elif self.backend == "paged":
            from .memory import PagedEngineState

            self._sparse = PagedEngineState(
                state, self.rule, topology=self.topology, **self._sparse_opts)
        else:
            self._state = self._place(state)
            return
        self._state = None

    def _warm_start(self) -> None:
        """Warm-start layer 2: when the registry holds a record for this
        exact (spec, environment), serve the plain runner from it (CUDA
        graphs on the card). One hash and one stat when nothing is
        registered; any load problem warns and keeps the normal runner.
        With ``GOLTPU_SANITIZE=1`` a registry-served engine, which claims
        no build cost, arms a retrace sentinel checked after every step
        (cold engines are exempt: their first steps legitimately build)."""
        self.aot_loaded = False
        self._aot_run = None
        self._retrace_sentinel = None
        if self.mesh is None and self.backend not in _TILED_BACKENDS:
            self._aot_run = aot_registry.maybe_load_for_engine(self)
            self.aot_loaded = self._aot_run is not None
        if self.aot_loaded and sanitizers.enabled():
            self._retrace_sentinel = sanitizers.RetraceSentinel(
                context=f"warm-started engine ({self.rule.notation} "
                        f"{self.shape[0]}x{self.shape[1]} "
                        f"{self.backend})").arm()

    def _place(self, state: torch.Tensor):
        """The encoded state on the mesh (full-width bands for the band
        runners, 2D tiles otherwise), or as it is without a mesh."""
        if self.mesh is None:
            return state
        return device_put_sharded_grid(state, self.mesh,
                                       banded=self.backend == "cuda")

    def _run(self, state, n: int):
        if self._runner is not None:
            return self._runner(state, n)
        if self._aot_run is not None:
            return self._aot_run(state, n)
        rule, topology = self.rule, self.topology
        if isinstance(rule, GenRule):
            if self.backend == "cuda":
                return cuda_stencil.multi_step_generations_kernel(
                    state, n, rule=rule, topology=topology)
            if self.backend == "packed":
                return multi_step_packed_generations(state, n, rule=rule,
                                                     topology=topology)
            return multi_step_generations(state, n, rule=rule, topology=topology)
        if isinstance(rule, LtLRule):
            if self.backend == "cuda":
                return cuda_stencil.multi_step_ltl_kernel(
                    state, n, rule=rule, topology=topology)
            if self.backend == "packed":
                step = multi_step_ltl_planes if self._states > 2 \
                    else multi_step_ltl_packed
                return step(state, n, rule=rule, topology=topology)
            return multi_step_ltl(state, n, rule=rule, topology=topology)
        if self.backend == "cuda":
            return cuda_stencil.multi_step_kernel(
                state, n, rule=rule, topology=topology)
        if self.backend == "packed":
            return multi_step_packed(state, n, rule=rule, topology=topology)
        return multi_step(state, n, rule=rule, topology=topology)

    # -- stepping ------------------------------------------------------------

    def step(self, n: int = 1) -> None:
        """Advance ``n`` generations (enqueued on the device; no sync).

        The ``engine.step`` span is dispatch time only (the kernels run on
        after it closes); the wait shows under ``engine.sync`` and the
        readback under ``engine.snapshot``, the separation the telemetry
        report keys on. While a sampling profiler is armed, the dispatch
        is a ``goltpu.dispatch[<backend>]`` range on the profiler's
        timeline."""
        if n < 0:
            raise ValueError(f"cannot step a negative number of generations: {n}")
        if n == 0:
            return
        # sanitizer (GOLTPU_SANITIZE=1): on the card every host sync of
        # the dispatch raises unless declared (the sparse and paged
        # engines declare their per-chunk reads inside)
        with obs_spans.span("engine.step", generations=n,
                            backend=self.backend), \
                obs_profiler.dispatch_annotation(
                    f"goltpu.dispatch[{self.backend}]"), \
                sanitizers.no_implicit_host_transfers(self.device):
            if self._sparse is not None:
                self._sparse.step(n)
            else:
                self._state = self._run(self._state, n)
        self.generation += n
        if self._retrace_sentinel is not None:
            self._retrace_sentinel.check()

    def block_until_ready(self) -> None:
        """Wait until the device (every device of the mesh) has finished
        every step enqueued."""
        devices = [self.device] if self.mesh is None else \
            [d for d, _ in self.mesh.groups]
        with obs_spans.span("engine.sync"):
            for device in devices:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)

    # -- observation ---------------------------------------------------------

    @property
    def state(self) -> torch.Tensor:
        """The raw device tensor (packed int32 words, a bit-plane stack, or
        uint8 cells). A step replaces it; use :meth:`snapshot` for a stable
        host copy. With a mesh, a new tensor gathered from the shards onto
        the mesh's first device (:attr:`sharded_state` is the placed
        state itself). For "sparse" a view of the padded buffer's interior,
        for "paged" a new tensor assembled from the pool's pages."""
        if self.mesh is not None:
            return self._state.gather()
        if self._sparse is not None:
            return self._sparse.packed
        return self._state

    @property
    def sharded_state(self):
        """With a mesh, the :class:`.parallel.mesh.ShardedGrid` the runners
        step; None without one."""
        return self._state if self.mesh is not None else None

    def snapshot(self, max_shape: Optional[Tuple[int, int]] = None) -> np.ndarray:
        """The full grid as host uint8 (H, W); optionally block-max
        downsampled *on device* to fit within ``max_shape`` before the
        transfer, so rendering a 16384² universe to a console ships a few
        KB."""
        with obs_spans.span("engine.snapshot"), \
                sanitizers.allow_host_transfers(
                    "snapshot IS the designated host readback (renderers, "
                    "checkpoints, reports fetch here, not in the loop)"):
            state = self.state
            if self._layout == "planes":
                dense = unpack_generations(state)
            elif self._layout == "words":
                dense = bitpack.unpack(state)
            else:
                dense = state
            if max_shape is not None:
                dense = _downsample_max(dense, max_shape)
            # a copy: for a CPU tensor .numpy() would be a view of live state
            return np.array(dense.cpu().numpy(), dtype=np.uint8, copy=True)

    def population(self) -> int:
        """Exact live-cell count (device-side count, host-side total). For
        multi-state rules only state 1 is alive: dying states occupy space
        but are not population. With a mesh, each position's block is
        counted on its own device."""
        with sanitizers.allow_host_transfers(
                "population is an explicit scalar readback (device-side "
                "count, one host total)"):
            if self.mesh is None:
                return self._population(self.state)
            return sum(self._population(block)
                       for block in self._state.blocks())

    def _population(self, state: torch.Tensor) -> int:
        if self._layout == "planes":
            return population_packed_generations(state)
        if self._layout == "words":
            return bitpack.population(state)
        return int((state == 1).sum(dtype=torch.int64))

    def active_tiles(self) -> Optional[int]:
        """The "sparse" backend's changed tiles (its activity map's count;
        with a mesh, the count over every shard's map) or the pages the
        "paged" backend holds; None for the other backends."""
        with sanitizers.allow_host_transfers(
                "active-tile count is an explicit observability readback"):
            if self._flags is not None:
                return sum(int(p.sum()) for p in self._flags.parts)
            if self._sparse is None:
                return None
            return self._sparse.active_tiles()

    def runner_cost_analysis(self, gens: int = 8) -> Optional[dict]:
        """The work one ``gens``-generation dispatch of this engine's rule
        on its grid does, counted in the packed formulation
        (:func:`.obs.cost.packed_cost`): ``generations``, ``flops``
        (bitwise operations on 32-bit words, not floating point;
        ``ops_kind="bitwise"``) and ``bytes_accessed`` (the packed state
        read and written once per dispatch). The JAX engine asks XLA's cost
        analysis of its compiled runner; this package has no compiler to
        ask, so it counts from the rule and the shape: the same figures for
        every backend that steps the same rule on the same grid (``cuda``,
        ``packed``, ``dense``, with or without a mesh), so a faster
        backend raises the achieved share instead of moving the
        denominator. Feeds the RunReport's roofline (:mod:`.obs.device`).
        None for the activity-tiled backends (their work depends on the
        activity: a static figure would lie) and for multi-state Larger
        than Life (no count of its plane-stack formulation)."""
        if self.backend in _TILED_BACKENDS:
            return None
        return packed_cost(self.rule, self.shape, gens)

    def halo_bytes_per_gen(self, source: str = "auto") -> int:
        """Bytes one generation moves between mesh positions in halo
        strips, amortised over the chunk when one exchange serves several
        generations; 0 without a mesh.

        ``source``: "measured" runs one generation (one chunk of a chunked
        runner, amortised, ceil) of the engine's runner on a copy of the
        state and reads :func:`.parallel.halo.exchanged_bytes` (measured
        once, then cached); "model" is the JAX engine's arithmetic, the
        activity map's strips of a mesh "sparse" engine included; "auto"
        serves the measured figure, and the model with a
        ``RuntimeWarning`` only if measuring fails."""
        if source not in ("auto", "measured", "model"):
            raise ValueError(
                f"source must be 'auto', 'measured', or 'model', got {source!r}")
        if self.mesh is None:
            return 0
        if source != "model":
            if self._halo_measured is None:
                try:
                    self._halo_measured = (self._measure_halo_bytes(), None)
                except Exception as exc:
                    self._halo_measured = (None, exc)
                    warnings.warn(
                        "halo_bytes_per_gen: measurement failed "
                        f"({type(exc).__name__}: {exc}); serving the "
                        "arithmetic model", RuntimeWarning, stacklevel=2)
            value, err = self._halo_measured
            if value is not None:
                return value
            if source == "measured":
                raise RuntimeError(
                    "measuring the halo bytes of one generation failed; "
                    "use source='model'") from err
        return self._halo_model()

    def _measure_halo_bytes(self) -> int:
        state = self._state.with_parts(p.clone() for p in self._state.parts)
        before = exchanged_bytes()
        if self.backend == "sparse":
            # a runner of its own: the engine's keeps its buffers
            flags = self._flags.with_parts(p.clone() for p in self._flags.parts)
            self._tiled_sparse_runner()(state, flags, 1)
            return exchanged_bytes() - before
        g = self.gens_per_exchange
        if self._one_chunk is not None:
            self._one_chunk(state)
        elif self.backend == "cuda":
            self._runner(state, g)
        else:
            self._runner(state, 1)
            g = 1
        return -(-(exchanged_bytes() - before) // g)

    def _halo_model(self) -> int:
        """The JAX engine's ``halo_bytes_per_gen(source="model")``."""
        nx, ny = self.mesh.shape[ROW_AXIS], self.mesh.shape[COL_AXIS]
        h, w = self.shape
        depth = self.rule.radius if isinstance(self.rule, LtLRule) else 1
        g = self.gens_per_exchange
        if self.backend == "cuda":
            # full-width bands over the flattened mesh: depth-(r*g) row
            # strips of every plane per chunk, no column phase
            nb = nx * ny
            if nb == 1:
                return 0
            b = n_planes(self._states) if self._layout == "planes" else 1
            strip = b * depth * g * (w // bitpack.WORD) * 4
            sends = 2 * (nb if self.topology is Topology.TORUS else nb - 1)
            return -(-sends * strip // g)
        if g > 1:
            # the packed B/S chunk runners: one exchange per g generations
            per_exchange = (sharded.ghost_exchange_bytes if self._ghost_pipeline
                            else sharded.deep_exchange_bytes)
            return -(-per_exchange((h, w // bitpack.WORD), self.mesh,
                                   self.topology, g) // g)
        # one exchange per generation: depth-row strips of every plane, and
        # column strips one word (packed) or depth bytes (dense) wide
        if self._layout == "dense":
            b, wq, itemsize, col_width = 1, w, 1, depth
        else:
            b = n_planes(self._states) if self._layout == "planes" else 1
            wq, itemsize, col_width = w // bitpack.WORD, 4, 1
        row_strip = b * depth * (wq // ny) * itemsize
        col_strip = b * col_width * (h // nx + 2 * depth) * itemsize
        row_sends, col_sends = sharded.halo_sends(self.mesh, self.topology)
        total = row_sends * row_strip + col_sends * col_strip
        if self._flags is not None:
            # the tile map's strips: tile-ring deep, 4-byte flags
            fy, fx = (p * n for p, n in zip(self._flags.parts[0].shape[-2:],
                                            (nx, ny)))
            dy, dx = _wake_dilation(self.rule, *self._sparse_tiles)
            total += (row_sends * dy * (fx // ny) * 4
                      + col_sends * dx * (fy // nx + 2 * dy) * 4)
        return total

    # -- state injection -----------------------------------------------------

    def set_grid(self, grid, generation: Optional[int] = None) -> None:
        state = self._encode(self._cells(grid))
        if self._sparse is not None:
            # the same configuration, adaptive capacity included
            self._sparse = self._sparse.reseed(state)
        else:
            # a mesh "sparse" engine re-seeds its tile map from the grid
            self._adopt(state)
        if generation is not None:
            self.generation = generation


def _downsample_max(dense: torch.Tensor, max_shape: Tuple[int, int]) -> torch.Tensor:
    """Block-max pool so any live cell keeps its block lit (a renderer that
    averaged would fade sparse patterns like a lone glider to nothing).
    Edge rows and columns land in a zero-padded partial block."""
    h, w = dense.shape
    mh, mw = max_shape
    fh, fw = max(1, -(-h // mh)), max(1, -(-w // mw))
    if fh == 1 and fw == 1:
        return dense
    ph, pw = -h % fh, -w % fw
    if ph or pw:
        dense = torch.nn.functional.pad(dense, (0, pw, 0, ph))
    return dense.reshape((h + ph) // fh, fh, (w + pw) // fw, fw).amax(dim=(1, 3))
