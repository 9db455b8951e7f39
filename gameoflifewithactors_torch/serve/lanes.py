"""Lanes: few physical executors for many logical sessions.

Counterpart of ``gameoflifewithactors_tpu.serve.lanes`` for the capacity
ladder (paged lanes wait for ROADMAP A10). A lane is one batched dispatch
surface: a ``(capacity, H, W/32)`` int32 batch of packed words driven by
a masked batched runner (:mod:`..parallel.batched`). Sessions of the same
:class:`SpecFamily` (rule × shape × topology × backend) share lanes; each
owns one batch slot, and the occupancy mask freezes the slots that owe
no generations.

- **Backends.** ``"cuda"`` steps the batch through kernel B2
  (:func:`..parallel.batched.multi_step_kernel_batched`, one launch per
  chunk of ``g`` generations for the whole lane; its plain version when
  the lane lives on the CPU) and is the counterpart of the JAX
  ``"pallas"`` lane; ``"packed"`` runs the plain-torch masked runner.
  ``"auto"`` is ``"cuda"`` on the card wherever the kernel takes the
  shape (``H >= g`` and its launch limits), else ``"packed"``; on the
  CPU it is ``"packed"``, as in the JAX package.
- **Exact steps.** ``Lane.step(n, mask)`` advances exactly ``n``
  generations on every backend: ``n // g`` kernel chunks and one shorter
  chunk of ``n % g``.
- **Device-resident state.** The lane's words live on its device; place,
  release, read and write are indexed copies of one slot, and ``read``
  returns a host ``'<u4'`` array. (The JAX lanes keep their words in host
  numpy so that XLA does not retrace; PyTorch has no trace to protect, and
  a host-resident 256 × 1024² lane would cross PCIe twice per dispatch.)
- **Fixed capacity ladder** (:data:`LANE_LADDER`, default 1/8/64/256):
  growth and compaction repack the live sessions into the smallest ladder
  multiset that holds them (greedy from the largest rung), slot to slot
  on the device.

The per-lane memory model admission control prices against is
:meth:`SpecFamily.slot_bytes` × capacity, as in the JAX package.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.generations import parse_any
from ..models.rules import Rule
from ..obs import spans as obs_spans
from ..ops import bitpack, cuda_stencil
from ..ops.stencil import Topology
from ..parallel import batched
from ..utils.interop import state_from_numpy, state_to_numpy

# capacities a lane may have. Sorted ascending; 1 keeps singleton tenants
# cheap, the top rung bounds lanes per family at ~N/256.
LANE_LADDER = (1, 8, 64, 256)
LANE_BACKENDS = ("packed", "cuda")
# generations per B2 launch on a "cuda" lane (the JAX lane's
# gens_per_exchange default)
LANE_GENS_PER_CALL = cuda_stencil.DEFAULT_GENS_PER_CALL


def kernel_takes(height: int, wq: int) -> bool:
    """Whether a ``"cuda"`` lane serves ``height`` × ``wq``-word grids:
    each grid is one band with a depth-``g`` exchange, so ``height >= g``,
    and the extended band must fit B2's launch limits."""
    g = LANE_GENS_PER_CALL
    return height >= g and cuda_stencil.supported_slab(
        (height + 2 * g, wq), g, batch=LANE_LADDER[-1])


class SpecFamily:
    """The lane-sharing equivalence class of a session spec.

    Two sessions share lanes iff rule notation, grid shape, topology and
    lane backend all match (batch capacity is the one shape axis the
    ladder varies).
    """

    def __init__(self, rule: str, height: int, width: int,
                 topology: str = "torus", backend: str = "packed"):
        parsed = parse_any(rule)
        if not isinstance(parsed, Rule):
            raise ValueError(
                f"lanes serve binary life-like rules only, got {rule!r} "
                f"({type(parsed).__name__}); multi-state families need "
                "their own engine")
        if backend == "pallas":
            raise ValueError(
                "lane backend 'pallas' is the JAX package's TPU kernel; "
                "this package's kernel lane backend is 'cuda'")
        if backend not in LANE_BACKENDS:
            raise ValueError(
                f"lane backend must be 'packed' or 'cuda', got {backend!r}")
        self.rule = parsed
        self.height = int(height)
        self.width = int(width)
        self.wq = bitpack.packed_width(self.width)  # validates width % 32
        self.topology = Topology(topology)
        self.backend = backend
        if backend == "cuda" and not kernel_takes(self.height, self.wq):
            raise ValueError(
                f"lane backend 'cuda' cannot take a {self.height}x{self.width} "
                f"grid: the slab kernel needs at least {LANE_GENS_PER_CALL} "
                "rows and a band within its launch grid")
        self.key = (f"{self.rule.notation}|{self.height}x{self.width}"
                    f"|{self.topology.value}|{self.backend}")

    @classmethod
    def from_spec(cls, spec: dict, device="cpu") -> "SpecFamily":
        """From a session-spec dict (the create-request body). ``backend``
        'auto' resolves for ``device``: ``"cuda"`` on a CUDA device where
        the kernel takes the shape, else ``"packed"``. Sharded meshes are
        refused: lanes are single-device."""
        d = dict(spec)
        if d.get("mesh"):
            raise ValueError(
                "lane sessions are single-device (the batch axis IS the "
                "parallelism); drop 'mesh' from the session spec")
        if "shape" in d:
            height, width = d["shape"]
        else:
            height, width = d["height"], d["width"]
        backend = d.get("backend", "auto")
        if backend == "auto":
            backend = "packed"
            if torch.device(device).type == "cuda" and kernel_takes(
                    int(height), int(width) // bitpack.WORD):
                backend = "cuda"
        return cls(d.get("rule", "B3/S23"), height, width,
                   d.get("topology", "torus"), backend)

    def canonical_spec(self) -> dict:
        """The JSON-able spec stored on sessions and in checkpoints."""
        return {"rule": self.rule.notation, "height": self.height,
                "width": self.width, "topology": self.topology.value,
                "backend": self.backend}

    def slot_bytes(self) -> int:
        """Modelled device cost of one occupied batch slot: packed words,
        double-buffered (a dispatch's input and output live together)."""
        return 2 * self.height * self.wq * 4


def lane_runner(family: SpecFamily) -> Callable:
    """The masked batched runner of a family: ``(state, n, mask) -> state``
    advancing the masked slots of a ``(capacity, H, W/32)`` batch exactly
    ``n`` generations."""
    if family.backend == "cuda":
        def run(state, n, mask):
            return batched.multi_step_kernel_batched(
                state, n, mask, rule=family.rule, topology=family.topology,
                gens_per_exchange=LANE_GENS_PER_CALL)
        return run
    return batched.make_multi_step_packed_batched(
        family.rule, family.topology, masked=True)


def warm_family(family: SpecFamily, device) -> None:
    """Build (or load) the kernel a family's lanes launch on ``device``,
    so that no dispatch pays for ``nvcc``: the port's counterpart of the
    JAX package's pre-tracing of every ladder shape (PyTorch does not
    trace, so capacity needs no warming)."""
    if family.backend == "cuda" and torch.device(device).type == "cuda":
        cuda_stencil.load_slab_kernel()


def _words(words, device) -> torch.Tensor:
    """A slot's ``(H, W/32)`` words on ``device``: a host uint32 array or an
    int32 tensor (a device-to-device copy when repacking)."""
    if isinstance(words, torch.Tensor):
        return words.to(device)
    return state_from_numpy(words, device)


class Lane:
    """One batch executor: capacity slots of a family + occupancy."""

    def __init__(self, lane_id: str, family: SpecFamily, capacity: int,
                 device="cpu"):
        self.lane_id = lane_id
        self.family = family
        self.capacity = int(capacity)
        self.device = torch.device(device)
        self.slots: List[Optional[str]] = [None] * self.capacity
        self.state = torch.zeros((self.capacity, family.height, family.wq),
                                 dtype=torch.int32, device=self.device)
        self._runner = lane_runner(family)
        self.steps_dispatched = 0
        self.fail_next = False  # test seam: inject one lane crash

    # -- slot surgery (indexed copies of one slot) ---------------------------

    def live_count(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def place(self, sid: str, words) -> int:
        slot = self.free_slot()
        if slot is None:
            raise ValueError(f"lane {self.lane_id} is full")
        self.slots[slot] = sid
        self.write(slot, words)
        return slot

    def release(self, slot: int) -> None:
        self.slots[slot] = None
        self.state[slot] = 0  # freed slots must not leak grids into dumps

    def read(self, slot: int) -> np.ndarray:
        """The slot's words as a new host ``'<u4'`` array."""
        return state_to_numpy(self.state[slot])

    def write(self, slot: int, words) -> None:
        self.state[slot] = _words(words, self.device)

    # -- the dispatch --------------------------------------------------------

    def step(self, n: int, mask: np.ndarray) -> None:
        """Advance masked slots exactly ``n`` generations in one dispatch
        (enqueued on the device; no sync)."""
        if self.fail_next:
            self.fail_next = False
            raise RuntimeError(f"injected lane fault ({self.lane_id})")
        # same span name as a dedicated engine's step: a lane batch IS the
        # engine step of its slots
        with obs_spans.span("engine.step", generations=int(n),
                            lane=self.lane_id, capacity=self.capacity):
            self.state = self._runner(self.state, int(n), mask)
        self.steps_dispatched += int(n)

    def stats(self) -> dict:
        return {"lane": self.lane_id, "family": self.family.key,
                "capacity": self.capacity, "live": self.live_count()}


class LanePool:
    """All lanes of one family + the ladder placement/compaction policy.

    Placement: first free slot in lane-creation order. Growth and
    compaction both route through :meth:`repack` — compute the ideal
    ladder multiset for the live-session count (greedy from the largest
    rung), rebuild lanes at those capacities, and re-place every live
    session. The pool returns the new ``sid -> (lane_id, slot)`` map;
    the caller (serve/service.py) owns updating Session records.
    """

    def __init__(self, family: SpecFamily,
                 ladder: Tuple[int, ...] = LANE_LADDER, device="cpu"):
        if not ladder:
            raise ValueError("lane ladder cannot be empty")
        self.family = family
        self.ladder = tuple(sorted(set(int(c) for c in ladder)))
        self.device = torch.device(device)
        self.lanes: Dict[str, Lane] = {}
        self._seq = itertools.count(1)
        self.compactions = 0
        self.warmed = False

    # -- policy --------------------------------------------------------------

    def plan(self, count: int) -> List[int]:
        """The ideal capacity multiset for ``count`` live sessions:
        largest rungs first, one smallest-fitting rung for the tail."""
        caps: List[int] = []
        top = self.ladder[-1]
        remaining = int(count)
        while remaining >= top:
            caps.append(top)
            remaining -= top
        if remaining > 0:
            caps.append(min(c for c in self.ladder if c >= remaining))
        return caps

    def total_capacity(self) -> int:
        return sum(lane.capacity for lane in self.lanes.values())

    def live_count(self) -> int:
        return sum(lane.live_count() for lane in self.lanes.values())

    def warm(self) -> None:
        if not self.warmed:
            warm_family(self.family, self.device)
            self.warmed = True

    # -- placement -----------------------------------------------------------

    def _new_lane(self, capacity: int) -> Lane:
        lane_id = f"{self.family.key}#{next(self._seq)}"
        lane = Lane(lane_id, self.family, capacity, self.device)
        self.lanes[lane_id] = lane
        return lane

    def _first_free(self, sid: str, words) -> Optional[Tuple[str, int]]:
        for lane in self.lanes.values():
            if lane.free_slot() is not None:
                return lane.lane_id, lane.place(sid, words)
        return None

    def place(self, sid: str, words) -> Tuple[str, int, dict]:
        """Claim a slot for ``sid``; returns (lane_id, slot, moves) where
        ``moves`` maps any *other* sessions a growth-repack relocated to
        their new (lane_id, slot)."""
        placed = self._first_free(sid, words)
        if placed is not None:
            return placed + ({},)
        # no free slot anywhere: grow through a repack sized for +1, onto
        # the same ladder shapes compaction uses
        moves = self.repack(self.live_count() + 1)
        placed = self._first_free(sid, words)
        if placed is None:
            raise RuntimeError(
                f"repack for {self.live_count() + 1} sessions left no free "
                f"slot (ladder {self.ladder})")
        return placed + (moves,)

    def release(self, lane_id: str, slot: int) -> None:
        self.lanes[lane_id].release(slot)

    def compact(self) -> dict:
        """Repack iff the ideal multiset is strictly smaller than what
        is allocated. Returns the relocation map (empty = no-op)."""
        live = self.live_count()
        ideal = self.plan(live)
        if sum(ideal) >= self.total_capacity() and len(
                ideal) >= len(self.lanes):
            return {}
        return self.repack(live)

    def repack(self, target_count: int) -> dict:
        """Rebuild lanes at ``plan(target_count)`` capacities and re-place
        every live session (deterministic order: old lane creation order,
        then slot order), each slot copied on the device."""
        entries: List[Tuple[str, torch.Tensor]] = []
        for lane in self.lanes.values():
            for slot, sid in enumerate(lane.slots):
                if sid is not None:
                    entries.append((sid, lane.state[slot]))
        target_count = max(target_count, len(entries))
        self.lanes.clear()
        moves: Dict[str, Tuple[str, int]] = {}
        for cap in self.plan(target_count):
            self._new_lane(cap)
        lanes = list(self.lanes.values())
        li = 0
        for sid, words in entries:
            while lanes[li].free_slot() is None:
                li += 1
            slot = lanes[li].place(sid, words)
            moves[sid] = (lanes[li].lane_id, slot)
        self.compactions += 1
        return moves

    def stats(self) -> List[dict]:
        return [lane.stats() for lane in self.lanes.values()]

    # -- admission pricing ----------------------------------------------------

    def admission_cost(self) -> int:
        """Modelled bytes one create claims: a full dense slot, whatever
        the seed looks like."""
        return self.family.slot_bytes()

    def bytes_held(self) -> int:
        """Modelled device bytes this family's lanes hold."""
        return self.total_capacity() * self.family.slot_bytes()
