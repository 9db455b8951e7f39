"""Fault injection + checkpoint-based recovery.

Counterpart of ``gameoflifewithactors_tpu.utils.fault``. The reference's
fault story is Akka supervision restarting a crashed cell actor -- which
silently loses that cell's state. The sharded equivalent of "a crashed
actor" is a corrupted/lost shard, and the honest recovery story is
checkpoint-based restart: GuardedRun snapshots every k generations and,
when a validator rejects the state (or stepping raises), rolls back to
the last good checkpoint and replays. Tests use the injectors to corrupt
state mid-run and prove recovery is bit-exact. The region injectors draw
their bits from ``np.random.default_rng(seed)`` as the JAX package's do,
so a fault is the same in both packages.
"""

from __future__ import annotations

import tempfile
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from ..engine import Engine
from ..obs import flight as obs_flight
from ..obs.registry import REGISTRY
from . import checkpoint as ckpt_lib

Validator = Callable[[Engine], bool]


def _record_injection(kind: str, **detail) -> None:
    """Every induced fault shows up in /metrics
    (``goltpu_faults_injected_total{kind=...}``) and on the flight tape --
    a crash dump that doesn't say "someone corrupted the grid at t-2s"
    sends the post-mortem chasing a phantom engine bug."""
    REGISTRY.counter("faults_injected_total",
                     "induced faults, by injector kind").inc(kind=kind)
    obs_flight.note_event("fault_injected", {"fault": kind, **detail})


# -- injectors (test hooks) --------------------------------------------------

def corrupt_region(engine: Engine, top: int, left: int, h: int, w: int, seed: int = 0) -> None:
    """Overwrite a rectangle with random bits -- a 'shard went bad' fault."""
    grid = engine.snapshot().copy()
    rng = np.random.default_rng(seed)
    grid[top : top + h, left : left + w] = rng.integers(0, 2, size=(h, w), dtype=np.uint8)
    engine.set_grid(grid)
    _record_injection("corrupt_region", top=top, left=left, h=h, w=w,
                      at_gen=engine.generation)


def drop_region(engine: Engine, top: int, left: int, h: int, w: int) -> None:
    """Zero a rectangle -- a 'lost shard / restarted actor' fault (what Akka
    supervision's restart would leave behind: default-initialized state)."""
    grid = engine.snapshot().copy()
    grid[top : top + h, left : left + w] = 0
    engine.set_grid(grid)
    _record_injection("drop_region", top=top, left=left, h=h, w=w,
                      at_gen=engine.generation)


def _rewrite_shard(engine: Engine, shard_index: int, fn) -> None:
    """Replace one mesh position's block of a sharded engine's state
    (``Engine.sharded_state``) with ``fn(block)``, a host array, leaving
    every other block untouched.

    Unlike the region injectors above (which round-trip the WHOLE grid
    through the host via snapshot/set_grid), this touches one block and
    keeps the other positions' tensors -- one device's state going bad
    *in flight* while the rest of the mesh is still good.
    ``shard_index`` is the position in flat x-major order."""
    if engine.mesh is None:
        raise ValueError("shard injectors need a sharded engine (mesh=None)")
    if engine.backend == "sparse":
        # sparse-tiled state pairs the grid with an activity map; mutating
        # the grid behind the map's back would "corrupt" cells inside
        # sleeping tiles that then never evolve -- not a recoverable-fault
        # model but an engine-invariant violation
        raise ValueError("shard injectors do not support the sparse backend")
    state = engine.sharded_state
    if not 0 <= shard_index < engine.mesh.size:
        raise IndexError(
            f"shard_index {shard_index} out of range ({engine.mesh.size} shards)")
    g, slot = engine.mesh.slot_of[shard_index]
    part = state.parts[g].clone()
    block = fn(part[slot].cpu().numpy())
    part[slot] = torch.from_numpy(np.ascontiguousarray(block)).to(part.device)
    parts = list(state.parts)
    parts[g] = part
    # Engine.sharded_state is a read-only view; the injector is a
    # privileged test hook and writes the backing attribute directly --
    # set_grid would defeat the point (a full-grid host round trip)
    engine._state = state.with_parts(parts)


def drop_shard(engine: Engine, shard_index: int) -> None:
    """Zero one mesh position's block in flight -- the 'device lost its
    state' fault. All-dead is a valid state in every grid representation,
    so this works on packed, dense, and bit-plane engines alike."""
    _rewrite_shard(engine, shard_index, np.zeros_like)
    _record_injection("drop_shard", shard=shard_index,
                      at_gen=engine.generation)


def corrupt_shard(engine: Engine, shard_index: int, seed: int = 0) -> None:
    """Overwrite one mesh position's block with random words in flight.
    Packed binary ((H, W/32) words) engines only: arbitrary bits are a
    valid state there, while dense bytes or bit-plane stacks would need
    representation-aware noise to stay in-domain."""
    if engine._layout != "words":
        raise ValueError(
            "corrupt_shard supports 2D packed word state only; "
            "use drop_shard for other representations")
    rng = np.random.default_rng(seed)

    def scramble(data: np.ndarray) -> np.ndarray:
        return rng.integers(0, 2 ** 32, size=data.shape,
                            dtype=np.uint32).view(np.int32)

    _rewrite_shard(engine, shard_index, scramble)
    _record_injection("corrupt_shard", shard=shard_index,
                      at_gen=engine.generation)


def corrupt_checkpoint_file(path: "str | Path", *, seed: int = 0,
                            nbytes: int = 64) -> None:
    """Flip ``nbytes`` bytes of an on-disk checkpoint file in place -- the
    torn-write/bitrot model for the durability layer (deliberately NOT
    temp+replace: damaged-in-place is the fault). A sharded-v2 restore
    must refuse the file (CRC mismatch / unreadable archive ->
    ``CheckpointCorruptError``) and fall back to the previous complete
    generation; a single-file load must surface the same clean error."""
    path = Path(path)
    data = bytearray(path.read_bytes())
    if not data:
        raise ValueError(f"{path} is empty; nothing to corrupt")
    rng = np.random.default_rng(seed)
    for i in rng.integers(0, len(data), size=min(int(nbytes), len(data))):
        data[i] ^= 0xFF
    path.write_bytes(bytes(data))
    _record_injection("checkpoint_corrupt", path=str(path))


# -- validators --------------------------------------------------------------

def population_bounds_validator(min_pop: int = 0, max_pop: Optional[int] = None) -> Validator:
    """Reject states whose population leaves [min_pop, max_pop] -- the cheap
    invariant check (exact popcount is one device reduction)."""

    def validate(engine: Engine) -> bool:
        pop = engine.population()
        if pop < min_pop:
            return False
        if max_pop is not None and pop > max_pop:
            return False
        return True

    return validate


# -- guarded execution -------------------------------------------------------

class GuardedRun:
    """Checkpoint-every-k stepping with rollback-and-replay on failure.

    ``validator`` is consulted after each chunk; a False verdict (or an
    exception from the engine) triggers restore from the last good
    checkpoint. ``on_recover`` is called with the generation rolled back
    to (observability hook).
    """

    def __init__(
        self,
        engine: Engine,
        *,
        checkpoint_every: int = 100,
        checkpoint_path: Optional[str] = None,
        validator: Optional[Validator] = None,
        on_recover: Optional[Callable[[int], None]] = None,
        max_retries: int = 3,
    ):
        self.engine = engine
        self.checkpoint_every = checkpoint_every
        self.validator = validator
        self.on_recover = on_recover
        self.max_retries = max_retries
        self.recoveries = 0
        if checkpoint_path is None:
            self._tmp = tempfile.TemporaryDirectory(prefix="gol_guard_")
            checkpoint_path = str(Path(self._tmp.name) / "guard.npz")
        self.checkpoint_path = checkpoint_path
        ckpt_lib.save(self.engine, self.checkpoint_path)  # gen-0 restore point

    def _restore(self) -> None:
        grid, meta = ckpt_lib.load_grid(self.checkpoint_path)
        self.engine.set_grid(grid, generation=meta["generation"])
        self.recoveries += 1
        obs_flight.note_event("guard_restore",
                              {"to_gen": self.engine.generation})
        if self.on_recover is not None:
            self.on_recover(self.engine.generation)

    def run(self, generations: int) -> None:
        target = self.engine.generation + generations
        retries = 0
        while self.engine.generation < target:
            chunk = min(self.checkpoint_every, target - self.engine.generation)
            last_exc: Optional[Exception] = None
            try:
                self.engine.step(chunk)
                ok = self.validator(self.engine) if self.validator else True
            except Exception as exc:  # surfaced at sync time: dispatch is async
                last_exc = exc
                ok = False
            if ok:
                ckpt_lib.save(self.engine, self.checkpoint_path)
                retries = 0
            else:
                if last_exc is None:
                    REGISTRY.counter(
                        "validator_trips_total",
                        "state-validator rejections (guard + supervisor)"
                    ).inc(where="guard")
                    obs_flight.note_event(
                        "validator_trip",
                        {"where": "guard", "at_gen": self.engine.generation})
                if retries >= self.max_retries:
                    raise RuntimeError(
                        f"state validation failed {retries + 1}x in a row at "
                        f"generation {self.engine.generation}; giving up"
                    ) from last_exc
                self._restore()
                retries += 1
