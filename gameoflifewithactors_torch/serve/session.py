"""Sessions: the logical actors the serving layer multiplexes.

A copy of ``gameoflifewithactors_tpu.serve.session`` (stdlib and numpy).

The scheduling model is the PGAS-actor one (PAPERS.md arXiv:2107.05516):
many logical actors — here, live grid universes owned by tenants — are
mapped onto few physical executors (batched lanes, serve/lanes.py). A
``Session`` is the unit a tenant sees: a spec, a generation cursor, and
a lifecycle; where its bits physically live (which lane, which slot) is
the lane layer's business and changes under compaction without the
session noticing.

Lifecycle::

    pending --admit--> packed --step--> running --close--> closed
       |                                   |
       +------------- evict ---------------+--> evicted

``pending`` — created but queued by admission control (no slot yet);
``packed`` — admitted into a lane slot, not yet stepped;
``running`` — stepped at least once;
``closed`` — tenant-requested delete (slot reclaimed);
``evicted`` — server-initiated removal (admission pressure or a lane
that exhausted its restart budget).

Stdlib + numpy only; no torch at module scope (the store must be
constructible and checkpoint-restorable while the device is wedged).
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import Dict, List, Optional

import numpy as np

PENDING = "pending"
PACKED = "packed"
RUNNING = "running"
CLOSED = "closed"
EVICTED = "evicted"

LIVE_STATES = (PACKED, RUNNING)
DEAD_STATES = (CLOSED, EVICTED)

# state -> states it may move to; anything else is a lifecycle bug
_TRANSITIONS = {
    PENDING: (PACKED, EVICTED, CLOSED),
    PACKED: (RUNNING, CLOSED, EVICTED),
    RUNNING: (RUNNING, CLOSED, EVICTED),
    CLOSED: (),
    EVICTED: (),
}


@dataclasses.dataclass
class Session:
    """One tenant-owned universe: identity + cursor, never bits.

    The packed grid words live in the owning lane's batch array (or in
    the admission queue's parking buffer while ``pending``); the session
    records only where to find them.
    """

    sid: str
    tenant: str
    family_key: str            # lanes.SpecFamily.key — which lanes can host it
    spec: dict                 # canonical EngineSpec dict (JSON-able)
    state: str = PENDING
    generation: int = 0
    pending_steps: int = 0     # requested, not yet applied
    lane_id: Optional[str] = None
    slot: Optional[int] = None
    # parking buffer for a not-yet-packed grid: (H, W/32) uint32
    parked: Optional[np.ndarray] = None

    def transition(self, new_state: str) -> None:
        if new_state not in _TRANSITIONS[self.state]:
            raise ValueError(
                f"session {self.sid}: illegal transition "
                f"{self.state} -> {new_state}")
        self.state = new_state

    @property
    def live(self) -> bool:
        return self.state in LIVE_STATES

    def placement(self) -> Optional[tuple]:
        """(lane_id, slot) when packed into a lane, else None."""
        if self.lane_id is None or self.slot is None:
            return None
        return (self.lane_id, self.slot)

    def to_meta(self) -> dict:
        """The JSON-able identity a checkpoint manifest records (bits —
        ``parked`` and the lane words — travel separately as arrays)."""
        return {"sid": self.sid, "tenant": self.tenant,
                "family_key": self.family_key, "spec": self.spec,
                "state": self.state, "generation": self.generation,
                "pending_steps": self.pending_steps}


class SessionStore:
    """sid -> Session, with the counts /healthz and the gauges read.

    Thread-safe for the frontend's request threads; the service layer
    holds its own coarser lock around anything that touches lanes, so
    the store lock only guards the map itself.
    """

    def __init__(self):
        self._sessions: Dict[str, Session] = {}
        self._lock = threading.Lock()
        self._ids = itertools.count(1)

    def new_sid(self, tenant: str) -> str:
        return f"s{next(self._ids):06d}-{tenant}"

    def add(self, session: Session) -> Session:
        with self._lock:
            if session.sid in self._sessions:
                raise ValueError(f"duplicate session id {session.sid}")
            self._sessions[session.sid] = session
        return session

    def get(self, sid: str) -> Session:
        with self._lock:
            try:
                return self._sessions[sid]
            except KeyError:
                raise KeyError(f"no such session {sid!r}") from None

    def maybe(self, sid: str) -> Optional[Session]:
        with self._lock:
            return self._sessions.get(sid)

    def drop(self, sid: str) -> None:
        """Forget a dead session entirely (post-close GC)."""
        with self._lock:
            self._sessions.pop(sid, None)

    def all(self) -> List[Session]:
        with self._lock:
            return list(self._sessions.values())

    def live(self) -> List[Session]:
        with self._lock:
            return [s for s in self._sessions.values() if s.live]

    def by_state(self, state: str) -> List[Session]:
        with self._lock:
            return [s for s in self._sessions.values() if s.state == state]

    def counts(self) -> dict:
        """{state: n} plus totals — the /healthz body's session block."""
        out = {st: 0 for st in _TRANSITIONS}
        with self._lock:
            for s in self._sessions.values():
                out[s.state] = out.get(s.state, 0) + 1
        out["total"] = sum(out.values())
        out["live"] = out[PACKED] + out[RUNNING]
        return out

    def tenants(self) -> Dict[str, int]:
        """tenant -> live session count (the per-tenant gauge feed)."""
        out: Dict[str, int] = {}
        with self._lock:
            for s in self._sessions.values():
                if s.live:
                    out[s.tenant] = out.get(s.tenant, 0) + 1
        return out
