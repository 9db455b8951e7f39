"""serve/: the multi-tenant session service.

Counterpart of ``gameoflifewithactors_tpu.serve``: many logical sessions
— tenant-owned live grids — multiplexed onto few batched lanes on the
card (the capacity ladder) or onto a shared tile pool (paged lanes).

- :mod:`.session` — Session/SessionStore (identity, lifecycle, cursor);
- :mod:`.lanes` — ladder-capacity batched lanes on the masked batched
  runners, kernel B2 on ``"cuda"`` lanes; paged lanes on
  :mod:`..memory`'s tile pool;
- :mod:`.admission` — HBM-gauge-priced admission control with a bounded
  backpressure queue;
- :mod:`.service` — the orchestrator (pump, checkpoint/resume, lane
  crash recovery);
- :mod:`.frontend` — the stdlib HTTP/JSON surface and the ``serve``
  CLI subcommand.
"""

from .admission import (ADMIT, QUEUE, REJECT, AdmissionController,
                        AdmissionRejected)
from .lanes import LANE_LADDER, Lane, LanePool, SpecFamily
from .service import SessionService, decode_words, encode_words
from .session import Session, SessionStore

__all__ = [
    "ADMIT", "QUEUE", "REJECT", "AdmissionController", "AdmissionRejected",
    "LANE_LADDER", "Lane", "LanePool", "SpecFamily",
    "SessionService", "decode_words", "encode_words",
    "Session", "SessionStore",
]
