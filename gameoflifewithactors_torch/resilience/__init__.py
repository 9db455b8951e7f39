"""Resilience: supervision, deterministic fault plans, the soak worker
and the elastic multi-process fleet.

:class:`Supervisor` wraps a GridCoordinator with checkpoint-restore
restart semantics (bit-exact, unlike Akka's state-losing restart), and the
session service recovers its lanes with the same :class:`RestartPolicy`.
:class:`FaultPlan` makes fault campaigns seeded and replayable.
``worker.py`` is the soak worker (one supervised coordinator process a
launcher may kill and resume); ``distributed.py`` the elastic fleet
(:class:`ElasticFleet`): processes of one ``torch.distributed`` group
that survive the loss of a peer through heartbeats, deadline-bounded
barriers and verified sharded checkpoints.
"""

from .distributed import (EXIT_DONE, EXIT_PEER_LOST, EXIT_PREEMPTED,
                          ElasticFleet, ElasticSpec, PeerLostError)
from .faultplan import (ALL_KINDS, LAUNCHER_KINDS, FaultEvent, FaultPlan,
                        apply_fault, induce_retrace, induce_stall)
from .supervisor import CircuitOpenError, RestartPolicy, Supervisor

__all__ = [
    "ALL_KINDS",
    "EXIT_DONE",
    "EXIT_PEER_LOST",
    "EXIT_PREEMPTED",
    "LAUNCHER_KINDS",
    "CircuitOpenError",
    "ElasticFleet",
    "ElasticSpec",
    "FaultEvent",
    "FaultPlan",
    "PeerLostError",
    "RestartPolicy",
    "Supervisor",
    "apply_fault",
    "induce_retrace",
    "induce_stall",
]
