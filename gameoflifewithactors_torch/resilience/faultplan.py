"""FaultPlan: a seeded, deterministic schedule of induced faults.

Counterpart of ``gameoflifewithactors_tpu.resilience.faultplan``: the same
kinds, the same draw from one ``random.Random(seed)`` -- the same seed
gives the same plan and the same JSON in both packages -- and in-process
appliers over the port's engine. A fault campaign that cannot be re-run
bit-for-bit is a flake generator, not a test; a plan round-trips through
JSON so a report carries the exact plan it executed.

Fault kinds span the failure modes the obs/resilience stack claims to
survive:

- ``corrupt_region`` / ``drop_region`` -- state gone bad, via the
  ``utils/fault.py`` injectors (rectangles stored as grid *fractions*
  so one plan applies to any shape);
- ``corrupt_shard`` / ``drop_shard`` -- one mesh position's block lost
  in flight (falls back to the region form when the engine has no mesh
  or a representation the shard injectors refuse);
- ``stall`` -- a subscriber that sleeps past the watchdog deadline
  inside the watched tick, so the StallWatchdog + flight recorder path
  fires for real;
- ``retrace`` -- a guaranteed kernel build after warm-up (a variant of a
  source no build can have seen), so the RetraceSentinel attribution
  path fires for real;
- ``kill``, ``process_kill``, ``process_preempt``,
  ``checkpoint_corrupt`` -- launcher kinds: a fleet launcher owns them (a
  process can hardly SIGKILL-and-resume itself); the in-process applier
  refuses them. The fleet of the JAX package's ``resilience/worker.py``
  and ``distributed.py`` waits for its port (ROADMAP A14).

Faults address workers by index and fire at a generation threshold, so
the schedule is defined in simulation time, not wall time -- the only
clock that replays.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import time
from typing import List, Optional, Sequence

# in-process kinds the worker applies between supervised chunks; launcher
# kinds belong to the fleet launcher (a process can hardly
# SIGKILL-and-resume itself, and checkpoint corruption must land while
# nobody is mid-write)
STATE_KINDS = ("corrupt_region", "drop_region", "corrupt_shard",
               "drop_shard")
PROCESS_KINDS = ("stall", "retrace", "kill")
LAUNCHER_KINDS = ("kill", "process_kill", "process_preempt",
                "checkpoint_corrupt")
ALL_KINDS = STATE_KINDS + PROCESS_KINDS + LAUNCHER_KINDS[1:]


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: fire against ``worker`` once its simulation
    reaches ``at_gen``. ``params`` is kind-specific (fractional rect for
    region faults, shard fraction for shard faults, rng seed for the
    corruptors) and JSON-plain by construction."""

    worker: int
    at_gen: int
    kind: str
    params: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "FaultEvent":
        return cls(worker=int(d["worker"]), at_gen=int(d["at_gen"]),
                   kind=str(d["kind"]), params=dict(d.get("params", {})))


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An ordered fault schedule plus the seed that regenerates it."""

    seed: int
    events: tuple

    def for_worker(self, worker: int, *,
                   kinds: Optional[Sequence[str]] = None) -> List[FaultEvent]:
        out = [e for e in self.events if e.worker == worker]
        if kinds is not None:
            out = [e for e in out if e.kind in kinds]
        return out

    def kinds(self) -> List[str]:
        return sorted({e.kind for e in self.events})

    def to_json(self) -> str:
        return json.dumps({"seed": self.seed,
                           "events": [e.to_dict() for e in self.events]})

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        d = json.loads(text)
        return cls(seed=int(d["seed"]),
                   events=tuple(FaultEvent.from_dict(e)
                                for e in d["events"]))

    @classmethod
    def generate(cls, seed: int, *, workers: int, horizon: int,
                 faults_per_worker: int = 3,
                 kinds: Sequence[str] = ALL_KINDS,
                 ensure_kinds: Sequence[str] = (),
                 kill_workers: Sequence[int] = ()) -> "FaultPlan":
        """Deterministically schedule ``faults_per_worker`` state/process
        faults per worker across generations ``[horizon//4, 3·horizon//4]``
        (never at the very start — warmup must finish — nor so late the
        recovery has no generations left to prove itself in), plus one
        ``kill`` for each index in ``kill_workers``. ``ensure_kinds``
        adds one extra event per listed kind the random draw happened to
        miss — how a soak campaign guarantees its coverage floor without
        giving up seeded randomness. Same seed, same plan: the only
        entropy source is one ``random.Random(seed)``."""
        if workers <= 0:
            raise ValueError(f"workers must be positive, got {workers}")
        if horizon < 8:
            raise ValueError(f"horizon too short to schedule into: {horizon}")
        rng = random.Random(seed)
        # the per-worker random draw stays in-process-only: launcher kinds
        # are scheduled deliberately (ensure_kinds / kill_workers), not
        # sprayed — a random process_kill of every worker is an outage,
        # not a campaign
        injectable = [k for k in kinds if k not in LAUNCHER_KINDS]
        if faults_per_worker > 0 and not injectable:
            raise ValueError(
                f"no in-process fault kinds in {tuple(kinds)}; pass "
                "faults_per_worker=0 and schedule launcher kinds via "
                "ensure_kinds")
        lo, hi = max(1, horizon // 4), max(2, (3 * horizon) // 4)
        events: List[FaultEvent] = []
        for w in range(workers):
            for _ in range(faults_per_worker):
                kind = rng.choice(injectable)
                events.append(FaultEvent(
                    worker=w, at_gen=rng.randint(lo, hi), kind=kind,
                    params=_draw_params(rng, kind)))
        for kind in ensure_kinds:
            if kind != "kill" and not any(e.kind == kind for e in events):
                events.append(FaultEvent(
                    worker=rng.randrange(workers),
                    at_gen=rng.randint(lo, hi), kind=kind,
                    params=_draw_params(rng, kind)))
        for w in kill_workers:
            events.append(FaultEvent(worker=int(w),
                                     at_gen=rng.randint(lo, hi),
                                     kind="kill"))
        events.sort(key=lambda e: (e.worker, e.at_gen, e.kind))
        return cls(seed=seed, events=tuple(events))


def _draw_params(rng: random.Random, kind: str) -> dict:
    if kind in ("corrupt_region", "drop_region"):
        p = {
            "top_f": round(rng.uniform(0.0, 0.6), 4),
            "left_f": round(rng.uniform(0.0, 0.6), 4),
            "h_f": round(rng.uniform(0.1, 0.4), 4),
            "w_f": round(rng.uniform(0.1, 0.4), 4),
        }
        if kind == "corrupt_region":
            p["seed"] = rng.randrange(2 ** 31)
        return p
    if kind in ("corrupt_shard", "drop_shard"):
        p = {"shard_f": round(rng.uniform(0.0, 0.999), 4)}
        if kind == "corrupt_shard":
            p["seed"] = rng.randrange(2 ** 31)
        return p
    if kind == "process_preempt":
        # grace window the launcher allows between SIGTERM and SIGKILL
        # escalation — long enough to finish a chunk and checkpoint
        return {"grace_seconds": round(rng.uniform(5.0, 15.0), 2)}
    if kind == "checkpoint_corrupt":
        return {"seed": rng.randrange(2 ** 31)}
    return {}


# -- in-process application ---------------------------------------------------

def induce_retrace(device=None) -> None:
    """Pay one guaranteed kernel build, visible to the process compile log
    as a ``cache_miss``.

    On a card (``device`` of type ``"cuda"``): ``nvcc`` builds
    ``csrc/life_slab.cu`` under a ``-D`` salt of this process's id and
    clock into a library of its own (``_build.build_variant``, inside
    :func:`..obs.compile.tracked_call`); nothing can have built that
    variant, and the file is removed afterwards. On the CPU there is no
    compiler: the event is recorded with no build. This models the
    failure the RetraceSentinel exists for: a warmed run building a
    kernel again."""
    import torch

    from ..obs import compile as obs_compile

    salt = ((os.getpid() << 20) ^ time.perf_counter_ns()) & 0x7FFFFFFF
    if device is not None and torch.device(device).type == "cuda":
        from .. import _build

        path = obs_compile.tracked_call(
            _build.build_variant, "resilience.induced_retrace",
            ("life_slab", (f"-DGOL_RETRACE_SALT={salt}",)), {})
        for leftover in (path, path + ".log"):
            if os.path.exists(leftover):
                os.remove(leftover)
        return
    t = time.perf_counter()
    obs_compile.record_build("resilience.induced_retrace", f"salt={salt}",
                             t, t, miss=True)


def induce_stall(coordinator, sleep_seconds: float) -> None:
    """Arm a one-shot subscriber that sleeps ``sleep_seconds`` inside the
    next tick's notify phase — inside the watchdog's watch scope, so the
    monitor thread flags a real StallEvent (and the flight recorder
    chained on it dumps) while the tick is genuinely stuck."""
    unsubscribe_box = []

    def _sleeper(frame) -> None:
        unsubscribe_box[0]()  # one-shot: the replayed chunk must be clean
        time.sleep(sleep_seconds)

    unsubscribe_box.append(coordinator.subscribe(_sleeper))


def apply_fault(supervisor, event: FaultEvent, *,
                stall_seconds: float = 1.0) -> str:
    """Fire one in-process fault against a supervised coordinator,
    routed through :meth:`Supervisor.inject` so the supervisor knows a
    *detected* fault is pending and will restore at the chunk boundary.
    Returns the kind actually applied (shard faults degrade to their
    region form on engines the shard injectors refuse -- unsharded or
    sparse -- keeping one plan valid across every worker flavor)."""
    from ..utils import fault as fault_lib

    engine = supervisor.coordinator.engine
    kind, p = event.kind, event.params
    if kind in ("corrupt_shard", "drop_shard"):
        shards = engine.mesh.size if engine.mesh is not None else 0
        packed_words = engine._layout == "words"
        if (engine.mesh is None or engine.backend == "sparse"
                or not shards
                or (kind == "corrupt_shard" and not packed_words)):
            kind = ("corrupt_region" if kind == "corrupt_shard"
                    else "drop_region")
            p = {"top_f": p.get("shard_f", 0.0) * 0.5, "left_f": 0.0,
                 "h_f": 0.25, "w_f": 0.25, "seed": p.get("seed", 0)}
        else:
            idx = min(int(p["shard_f"] * shards), shards - 1)
            if kind == "drop_shard":
                supervisor.inject(
                    kind, lambda e: fault_lib.drop_shard(e, idx))
            else:
                supervisor.inject(
                    kind, lambda e: fault_lib.corrupt_shard(
                        e, idx, seed=p.get("seed", 0)))
            return kind
    if kind in ("corrupt_region", "drop_region"):
        h, w = engine.shape
        top, left = int(p["top_f"] * h), int(p["left_f"] * w)
        rh = max(1, int(p["h_f"] * h))
        rw = max(1, int(p["w_f"] * w))
        rh, rw = min(rh, h - top), min(rw, w - left)
        if kind == "corrupt_region":
            supervisor.inject(
                kind, lambda e: fault_lib.corrupt_region(
                    e, top, left, rh, rw, seed=p.get("seed", 0)))
        else:
            supervisor.inject(
                kind, lambda e: fault_lib.drop_region(e, top, left, rh, rw))
        return kind
    if kind == "stall":
        supervisor.inject(
            kind, lambda e: induce_stall(supervisor.coordinator,
                                         stall_seconds))
        return kind
    if kind == "retrace":
        supervisor.inject(kind, lambda e: induce_retrace(e.device))
        return kind
    raise ValueError(
        f"fault kind {kind!r} is not applicable in-process"
        + (" (launcher kinds belong to a fleet launcher)"
           if kind in LAUNCHER_KINDS else ""))
