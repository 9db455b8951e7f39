"""Resilience: the restart policy the session service recovers lanes
with (:mod:`.supervisor`). The ``Supervisor``, fault plans and soak
workers wait for ROADMAP A14."""

from .supervisor import RestartPolicy

__all__ = ["RestartPolicy"]
