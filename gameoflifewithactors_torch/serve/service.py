"""SessionService: sessions × lanes × admission, behind one lock.

Counterpart of ``gameoflifewithactors_tpu.serve.service`` on the
capacity ladder (``paged=True`` waits for ROADMAP A10). The frontend
(:mod:`.frontend`) translates HTTP to these methods; tests drive them
directly. Responsibilities:

- **create** — admission verdict first (priced at the family's modelled
  slot bytes against the live HBM gauges), then either place into a lane
  slot, park in the backpressure queue, or refuse;
- **step** — credit a session's ``pending_steps`` debt, then **pump**:
  per lane, repeatedly dispatch ``min(positive pending)`` generations
  with the occupancy mask of the still-indebted slots. Sessions at
  different cursors ride the same dispatch — the mask freezes the ones
  that are done, so every session's trajectory is bit-identical to a
  dedicated engine of its own;
- **close** — free the slot, compact the pool (ladder repack), drain
  the admission queue into the freed capacity;
- **checkpoint / resume** — one atomic ``.npz`` (packed words + a JSON
  manifest), written to a temporary file and moved into place; resume
  re-places every live session and re-parks every queued one at its
  checkpointed generation. The format is the JAX package's, so a
  checkpoint of ``"packed"`` families loads in either package;
- **lane recovery** — a lane dispatch that raises (a kernel that fails to
  build or launch included) is handled in the supervisor's restart shape
  (:class:`..resilience.RestartPolicy` backoff, a circuit breaker after
  ``max_restarts`` consecutive failures): every session in the lane
  restores from its recovery snapshot and its lost generations are
  re-credited as pending debt, so the replayed result is bit-identical to
  a never-faulted run. A lane whose circuit opens evicts its sessions
  instead of wedging the whole service. No dispatch switches backend.

Sessions' lanes live on the service's ``device`` (CUDA unless the caller
asks for the CPU).

Locking: one re-entrant service lock around anything that touches lanes
or session placement. The store and registry have their own fine-grained
locks for read paths (/healthz, /metrics) that must not wait on a pump.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..engine import resolve_device
from ..obs import flight as obs_flight
from ..obs import spans as obs_spans
from ..obs.registry import REGISTRY, MetricsRegistry
from ..ops import bitpack
from ..resilience.supervisor import RestartPolicy
from .admission import QUEUE, REJECT, AdmissionController, AdmissionRejected
from .lanes import LANE_LADDER, LanePool, SpecFamily
from .session import (CLOSED, DEAD_STATES, EVICTED, PACKED, PENDING,
                      RUNNING, Session, SessionStore)

CHECKPOINT_VERSION = 1


def encode_words(words: np.ndarray) -> str:
    """Packed (H, W/32) uint32 -> hex string (little-endian words) — the
    wire form of a grid (8x smaller than a cell-per-byte JSON array)."""
    return np.ascontiguousarray(words, dtype="<u4").tobytes().hex()


def decode_words(hexstr: str, height: int, wq: int) -> np.ndarray:
    buf = bytes.fromhex(hexstr)
    expect = height * wq * 4
    if len(buf) != expect:
        raise ValueError(
            f"grid payload is {len(buf)} bytes, expected {expect} "
            f"({height}x{wq} packed words)")
    return np.frombuffer(buf, dtype="<u4").reshape(height, wq).astype(
        np.uint32)


class SessionService:
    """The multi-tenant session manager (see module docstring)."""

    def __init__(self, *, ladder: Tuple[int, ...] = LANE_LADDER,
                 admission: Optional[AdmissionController] = None,
                 checkpoint_path: Optional[str] = None,
                 registry: MetricsRegistry = REGISTRY,
                 policy: Optional[RestartPolicy] = None,
                 warm_on_first_use: bool = True,
                 paged: bool = False,
                 sleep_fn=time.sleep,
                 device=None):
        if paged:
            raise NotImplementedError(
                "paged lanes (a shared tile pool) are not yet ported to "
                "gameoflifewithactors_torch (see ROADMAP.md queue A10)")
        self.device = resolve_device(device)
        self.ladder = tuple(sorted(set(int(c) for c in ladder)))
        self.registry = registry
        self.admission = admission or AdmissionController(registry=registry)
        self.checkpoint_path = checkpoint_path
        self.policy = policy or RestartPolicy()
        self.warm_on_first_use = warm_on_first_use
        self._sleep = sleep_fn
        self.store = SessionStore()
        self.pools: Dict[str, LanePool] = {}
        self._lock = threading.RLock()
        # recovery snapshots: sid -> (packed words, generation) as of the
        # last checkpoint (or admission, before the first one) — what a
        # crashed lane restores from without touching disk
        self._recovery: Dict[str, Tuple[np.ndarray, int]] = {}
        self._lane_failures: Dict[str, int] = {}
        self._known_tenants: set = set()
        reg = registry
        self._m_steps = reg.counter(
            "session_steps_total", "generations stepped, per tenant")
        self._m_live = reg.gauge(
            "sessions_live", "live (packed+running) sessions, per tenant")
        self._m_lanes = reg.gauge(
            "session_lanes", "lanes allocated, per spec family")
        self._m_slots_live = reg.gauge(
            "session_lane_slots_live", "occupied lane slots, per family")
        self._m_slots_total = reg.gauge(
            "session_lane_slots_total", "allocated lane slots, per family")
        self._m_lane_bytes = reg.gauge(
            "session_lane_bytes",
            "modelled HBM bytes held by lane batches, per family")
        self._m_compactions = reg.counter(
            "session_compactions_total", "lane repacks, per family")
        self._m_recoveries = reg.counter(
            "session_lane_recoveries_total",
            "lane crash restore cycles, per family")
        self._m_evictions = reg.counter(
            "session_evictions_total",
            "sessions evicted (lane circuit open), per family")
        # per-tenant SLO surface: request-phase latencies (queue wait has
        # its own histogram in admission.py) and a recent-throughput gauge
        self._m_phase = reg.histogram(
            "session_phase_seconds",
            "request-phase latency by phase "
            "(admission / dispatch / first_step), per tenant")
        self._m_tenant_rate = reg.gauge(
            "tenant_steps_per_sec",
            "recent per-tenant step throughput on THIS process's chips "
            "(per-chip: list across procs, never sum)")
        # sid -> perf_counter at create, pending its first stepped
        # generation (the time-to-first-step phase)
        self._first_step_t0: Dict[str, float] = {}
        # tenant -> (perf_counter, cumulative steps) anchoring the rate
        self._rate_anchor: Dict[str, Tuple[float, float]] = {}
        self._tenant_steps: Dict[str, float] = {}

    # -- warm start ----------------------------------------------------------

    def warm(self, spec: dict) -> str:
        """Build the kernel a family's lanes launch, ahead of its first
        dispatch. Returns the family key."""
        family = self._family(spec)
        with self._lock:
            self._pool(family).warm()
        return family.key

    def _family(self, spec: dict) -> SpecFamily:
        return SpecFamily.from_spec(spec, self.device)

    def _pool(self, family: SpecFamily) -> LanePool:
        pool = self.pools.get(family.key)
        if pool is None:
            pool = self.pools[family.key] = LanePool(family, self.ladder,
                                                     self.device)
            if self.warm_on_first_use:
                pool.warm()
        return pool

    # -- the session API -----------------------------------------------------

    def create(self, tenant: str, spec: dict, *,
               fill: Optional[float] = None, rng_seed: int = 0,
               cells_hex: Optional[str] = None) -> dict:
        """Admit (or queue/refuse) one session. Seeding is host-side and
        reproducible: ``fill`` draws Bernoulli cells from
        ``numpy.random.default_rng(rng_seed)`` — a client (or an oracle)
        regenerates the exact grid from the same two numbers — and
        ``cells_hex`` ships explicit packed words."""
        family = self._family(spec)
        words = self._seed_words(family, fill, rng_seed, cells_hex)
        with self._lock:
            pool = self._pool(family)
            t_adm = time.perf_counter()
            with obs_spans.span("serve.admission", tenant=tenant,
                                family=family.key):
                verdict = self.admission.decide(pool.admission_cost(),
                                                tenant=tenant)
            self._m_phase.observe(time.perf_counter() - t_adm,
                                  phase="admission", tenant=tenant)
            if verdict == REJECT:
                raise AdmissionRejected(
                    f"over HBM budget and the admission queue is full "
                    f"(family {family.key})")
            sid = self.store.new_sid(tenant)
            s = Session(sid=sid, tenant=tenant, family_key=family.key,
                        spec=family.canonical_spec())
            self.store.add(s)
            self._known_tenants.add(tenant)
            self._first_step_t0[sid] = time.perf_counter()
            if verdict == QUEUE:
                s.parked = words
                self.admission.enqueue(sid, time.perf_counter())
            else:
                self._place(pool, s, words)
            self._refresh_gauges()
            return self._info(s)

    def step(self, sid: str, n: int, *, pump: bool = True) -> dict:
        """Credit ``n`` generations of debt; by default pump immediately.
        Queued (pending) sessions accumulate debt that applies once they
        are admitted."""
        if n < 0:
            raise ValueError(f"cannot step a negative count ({n})")
        with self._lock:
            s = self.store.get(sid)
            if s.state in DEAD_STATES:
                raise ValueError(f"session {sid} is {s.state}")
            s.pending_steps += int(n)
            if pump:
                t0 = time.perf_counter()
                self.pump()
                # dispatch latency attributed to the requesting tenant:
                # how long this step call waited for its lane dispatches
                self._m_phase.observe(time.perf_counter() - t0,
                                      phase="dispatch", tenant=s.tenant)
            return self._info(s)

    def close(self, sid: str) -> dict:
        with self._lock:
            s = self.store.get(sid)
            if s.state in DEAD_STATES:
                return self._info(s)
            pool = self.pools.get(s.family_key)
            if s.placement() is not None and pool is not None:
                pool.release(s.lane_id, s.slot)
                s.lane_id = s.slot = None
                self._apply_moves(pool, pool.compact())
            s.parked = None
            s.pending_steps = 0
            s.transition(CLOSED)
            self._recovery.pop(sid, None)
            self._first_step_t0.pop(sid, None)
            self._drain_queue()
            self._refresh_gauges()
            return self._info(s)

    def info(self, sid: str) -> dict:
        with self._lock:
            return self._info(self.store.get(sid))

    def grid(self, sid: str) -> np.ndarray:
        """The session's current cells, (H, W) uint8 (the lane slot, or
        the parking buffer, copied to the host and unpacked there)."""
        with self._lock:
            s = self.store.get(sid)
            return bitpack.unpack_np(self._words_of(s))

    def grid_hex(self, sid: str) -> dict:
        with self._lock:
            s = self.store.get(sid)
            return {"sid": s.sid, "generation": s.generation,
                    "height": s.spec["height"], "width": s.spec["width"],
                    "encoding": "packed_le_u32_hex",
                    "cells_hex": encode_words(self._words_of(s))}

    # -- the pump ------------------------------------------------------------

    def pump(self) -> int:
        """Apply every session's pending debt. Returns the number of
        lane dispatches issued."""
        with self._lock:
            dispatches = 0
            for pool in list(self.pools.values()):
                for lane in list(pool.lanes.values()):
                    dispatches += self._pump_lane(pool, lane)
            self._drain_queue()
            self._refresh_gauges()
            return dispatches

    def _pump_lane(self, pool: LanePool, lane) -> int:
        dispatches = 0
        while True:
            pend = np.zeros(lane.capacity, dtype=np.int64)
            holders: List[Optional[Session]] = [None] * lane.capacity
            for i, sid in enumerate(lane.slots):
                if sid is not None:
                    s = self.store.get(sid)
                    holders[i] = s
                    pend[i] = s.pending_steps
            if pend.max(initial=0) <= 0:
                return dispatches
            active = pend > 0
            n = int(pend[active].min())
            try:
                with obs_spans.span("lane.dispatch", lane=lane.lane_id,
                                    family=pool.family.key,
                                    generations=n,
                                    slots=int(active.sum())):
                    lane.step(n, active.astype(np.uint32))
            except Exception as exc:  # noqa: BLE001 — restart is the point
                if not self._recover_lane(pool, lane, exc):
                    return dispatches  # circuit opened; lane is gone
                continue  # debts were re-credited; recompute and retry
            dispatches += 1
            now = time.perf_counter()
            self._lane_failures.pop(lane.lane_id, None)
            for i, s in enumerate(holders):
                if s is not None and active[i]:
                    s.generation += n
                    s.pending_steps -= n
                    if s.state == PACKED:
                        s.transition(RUNNING)
                    self._m_steps.inc(n, tenant=s.tenant)
                    self._tenant_steps[s.tenant] = \
                        self._tenant_steps.get(s.tenant, 0.0) + n
                    t0 = self._first_step_t0.pop(s.sid, None)
                    if t0 is not None:
                        self._m_phase.observe(now - t0, phase="first_step",
                                              tenant=s.tenant)

    # -- lane recovery -------------------------------------------------------

    def _recover_lane(self, pool: LanePool, lane, exc) -> bool:
        """Restore every session in a crashed lane from its recovery
        snapshot (lost generations become re-credited debt, so the
        replay is bit-identical). Returns False when the lane's circuit
        opened — its sessions are evicted and the lane removed."""
        fam = pool.family.key
        count = self._lane_failures.get(lane.lane_id, 0) + 1
        self._lane_failures[lane.lane_id] = count
        obs_flight.note_event(
            "lane_fault", {"lane": lane.lane_id, "family": fam,
                           "attempt": count,
                           "error": f"{type(exc).__name__}: {exc}"})
        if count > self.policy.max_restarts:
            self._evict_lane(pool, lane, cause=f"circuit_open: {exc}")
            return False
        delay = self.policy.backoff(count)
        if delay > 0:
            self._sleep(delay)
        for slot, sid in enumerate(lane.slots):
            if sid is None:
                continue
            s = self.store.get(sid)
            snap = self._recovery.get(sid)
            if snap is None:  # placed this instant; its words are intact
                continue
            words, gen = snap
            lost = s.generation - gen
            lane.write(slot, words)
            s.generation = gen
            if lost > 0:
                s.pending_steps += lost
        self._m_recoveries.inc(family=fam)
        obs_flight.note_event(
            "lane_restored", {"lane": lane.lane_id, "family": fam,
                              "attempt": count})
        return True

    def _evict_lane(self, pool: LanePool, lane, *, cause: str) -> None:
        self._lane_failures.pop(lane.lane_id, None)
        for sid in lane.slots:
            if sid is None:
                continue
            s = self.store.get(sid)
            s.lane_id = s.slot = None
            s.transition(EVICTED)
            self._recovery.pop(sid, None)
            self._first_step_t0.pop(sid, None)
            self._m_evictions.inc(family=pool.family.key)
        pool.lanes.pop(lane.lane_id, None)
        obs_flight.note_event(
            "lane_evicted", {"lane": lane.lane_id,
                             "family": pool.family.key, "cause": cause})

    # -- checkpoint / resume -------------------------------------------------

    def checkpoint(self, path: Optional[str] = None) -> str:
        """One atomic .npz: a JSON manifest plus every surviving
        session's packed words. Pending step debt is persisted — a
        resumed server owes exactly what the dead one did. Also refreshes
        the in-memory recovery snapshots (lane crashes restore to the
        last checkpointed cut, same as a process crash would)."""
        path = path or self.checkpoint_path
        if not path:
            raise ValueError("no checkpoint path configured")
        with self._lock:
            manifest: dict = {"version": CHECKPOINT_VERSION,
                              "created_at": time.strftime(
                                  "%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
                              "sessions": []}
            arrays: Dict[str, np.ndarray] = {}
            for i, s in enumerate(self.store.all()):
                if s.state in DEAD_STATES:
                    continue
                words = self._words_of(s)
                key = f"w{i}"
                arrays[key] = words
                meta = s.to_meta()
                meta["array"] = key
                manifest["sessions"].append(meta)
                self._recovery[s.sid] = (np.array(words, copy=True),
                                         s.generation)
            arrays["manifest"] = np.array(json.dumps(manifest))
            tmp = f"{path}.tmp{os.getpid()}.npz"
            with open(tmp, "wb") as f:
                np.savez(f, **arrays)
            os.replace(tmp, path)
            obs_flight.note_event(
                "serve_checkpoint",
                {"path": path, "sessions": len(manifest["sessions"])})
            return path

    def resume(self, path: Optional[str] = None) -> int:
        """Reload a checkpoint into an empty service: live sessions are
        re-placed into fresh (freshly compacted) lanes at their
        checkpointed generations, queued ones re-parked. Returns the
        number of sessions restored."""
        path = path or self.checkpoint_path
        if not path:
            raise ValueError("no checkpoint path configured")
        with self._lock:
            if self.store.all():
                raise RuntimeError(
                    "resume() needs an empty service (it rebuilds "
                    "placement from scratch)")
            with np.load(path, allow_pickle=False) as data:
                manifest = json.loads(str(data["manifest"][()]))
                if manifest.get("version") != CHECKPOINT_VERSION:
                    raise ValueError(
                        f"checkpoint {path} has version "
                        f"{manifest.get('version')}, expected "
                        f"{CHECKPOINT_VERSION}")
                restored = 0
                for meta in manifest["sessions"]:
                    words = np.array(data[meta["array"]], dtype=np.uint32,
                                     copy=True)
                    family = self._family(meta["spec"])
                    pool = self._pool(family)
                    s = Session(sid=meta["sid"], tenant=meta["tenant"],
                                family_key=family.key,
                                spec=family.canonical_spec(),
                                generation=int(meta["generation"]),
                                pending_steps=int(meta["pending_steps"]))
                    self.store.add(s)
                    self._known_tenants.add(s.tenant)
                    if meta["state"] == PENDING:
                        s.parked = words
                        self.admission.enqueue(s.sid, time.perf_counter())
                    else:
                        self._place(pool, s, words)
                        if meta["state"] == RUNNING:
                            s.transition(RUNNING)
                    restored += 1
            self._refresh_gauges()
            obs_flight.note_event("serve_resume",
                                  {"path": path, "sessions": restored})
            return restored

    # -- observability -------------------------------------------------------

    def counts(self) -> dict:
        """The /healthz body: live session/lane/queue counts, cheap."""
        with self._lock:
            lanes = sum(len(p.lanes) for p in self.pools.values())
            slots = sum(p.total_capacity() for p in self.pools.values())
            occupied = sum(p.live_count() for p in self.pools.values())
        return {"sessions": self.store.counts(),
                "lanes": lanes, "lane_slots": slots,
                "lane_slots_occupied": occupied,
                "queue_depth": self.admission.queue_depth(),
                "families": sorted(self.pools)}

    def lane_stats(self) -> List[dict]:
        with self._lock:
            out: List[dict] = []
            for pool in self.pools.values():
                out.extend(pool.stats())
            return out

    # -- internals -----------------------------------------------------------

    def _seed_words(self, family: SpecFamily, fill, rng_seed,
                    cells_hex) -> np.ndarray:
        if fill is not None and cells_hex is not None:
            raise ValueError("give either 'fill' or 'cells_hex', not both")
        if cells_hex is not None:
            return decode_words(cells_hex, family.height, family.wq)
        if fill is not None:
            rng = np.random.default_rng(int(rng_seed))
            cells = (rng.random((family.height, family.width))
                     < float(fill)).astype(np.uint8)
            return bitpack.pack_np(cells)
        return np.zeros((family.height, family.wq), dtype=np.uint32)

    def _place(self, pool: LanePool, s: Session, words: np.ndarray) -> None:
        lane_id, slot, moves = pool.place(s.sid, words)
        self._apply_moves(pool, moves)
        s.lane_id, s.slot = lane_id, slot
        if s.state == PENDING:
            s.transition(PACKED)
        self._recovery[s.sid] = (np.array(words, copy=True), s.generation)

    def _apply_moves(self, pool: LanePool, moves: dict) -> None:
        if not moves:
            return
        for sid, (lane_id, slot) in moves.items():
            moved = self.store.get(sid)
            moved.lane_id, moved.slot = lane_id, slot
        self._m_compactions.inc(family=pool.family.key)

    def _drain_queue(self) -> None:
        def cost(sid: str) -> int:
            s = self.store.maybe(sid)
            if s is None:
                return 0
            return self.pools[s.family_key].admission_cost()

        for sid in self.admission.drain(cost, time.perf_counter()):
            s = self.store.maybe(sid)
            if s is None or s.state != PENDING:
                continue  # closed (or evicted) while parked
            words, s.parked = s.parked, None
            self._place(self.pools[s.family_key], s, words)

    def _words_of(self, s: Session) -> np.ndarray:
        if s.placement() is not None:
            return self.pools[s.family_key].lanes[s.lane_id].read(s.slot)
        if s.parked is not None:
            return np.array(s.parked, copy=True)
        raise ValueError(f"session {s.sid} is {s.state}; no grid to read")

    def _info(self, s: Session) -> dict:
        return {"sid": s.sid, "tenant": s.tenant, "state": s.state,
                "generation": s.generation,
                "pending_steps": s.pending_steps,
                "family": s.family_key, "spec": dict(s.spec),
                "lane": s.lane_id, "slot": s.slot}

    # refuse sub-window samples: back-to-back pumps would otherwise
    # publish rates computed over microsecond baselines (pure noise)
    RATE_WINDOW_SECONDS = 0.25

    def _refresh_gauges(self) -> None:
        tenants = self.store.tenants()
        for tenant in self._known_tenants:
            self._m_live.set(tenants.get(tenant, 0), tenant=tenant)
        now = time.perf_counter()
        for tenant, total in self._tenant_steps.items():
            anchor = self._rate_anchor.get(tenant)
            if anchor is None:
                self._rate_anchor[tenant] = (now, total)
                continue
            last_t, last_total = anchor
            dt = now - last_t
            if dt >= self.RATE_WINDOW_SECONDS:
                self._m_tenant_rate.set((total - last_total) / dt,
                                        tenant=tenant)
                self._rate_anchor[tenant] = (now, total)
        for key, pool in self.pools.items():
            self._m_lanes.set(len(pool.lanes), family=key)
            self._m_slots_live.set(pool.live_count(), family=key)
            self._m_slots_total.set(pool.total_capacity(), family=key)
            self._m_lane_bytes.set(pool.bytes_held(), family=key)
