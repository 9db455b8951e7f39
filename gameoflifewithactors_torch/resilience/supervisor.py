"""Restart policy: how hard to try before declaring a run dead.

Counterpart of ``RestartPolicy`` in
``gameoflifewithactors_tpu.resilience.supervisor``; the ``Supervisor``
that wraps a ``GridCoordinator`` waits for ROADMAP A14.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RestartPolicy:
    """How hard to try before declaring the run dead.

    ``max_restarts`` counts *consecutive* failures: any clean chunk
    resets the streak (the Akka "maxNrOfRetries within a window" knob,
    with the window measured in progress instead of wall time —
    deterministic under replay). Backoff is capped exponential:
    ``min(initial * factor**n, max)`` seconds before restart ``n``."""

    max_restarts: int = 5
    backoff_initial_seconds: float = 0.05
    backoff_max_seconds: float = 2.0
    backoff_factor: float = 2.0

    def backoff(self, consecutive_failures: int) -> float:
        n = max(0, consecutive_failures - 1)
        return min(self.backoff_initial_seconds * self.backoff_factor ** n,
                   self.backoff_max_seconds)
