"""Resilience: supervision and deterministic fault plans.

:class:`Supervisor` wraps a GridCoordinator with checkpoint-restore
restart semantics (bit-exact, unlike Akka's state-losing restart), and the
session service recovers its lanes with the same :class:`RestartPolicy`.
:class:`FaultPlan` makes fault campaigns seeded and replayable. The soak
workers and the elastic multi-process fleet of the JAX package
(``worker.py``, ``distributed.py``) wait for ROADMAP A14's multi-process
part, which needs A12's process group.
"""

from .faultplan import (ALL_KINDS, LAUNCHER_KINDS, FaultEvent, FaultPlan,
                        apply_fault, induce_retrace, induce_stall)
from .supervisor import CircuitOpenError, RestartPolicy, Supervisor

__all__ = [
    "ALL_KINDS",
    "LAUNCHER_KINDS",
    "CircuitOpenError",
    "FaultEvent",
    "FaultPlan",
    "RestartPolicy",
    "Supervisor",
    "apply_fault",
    "induce_retrace",
    "induce_stall",
]
