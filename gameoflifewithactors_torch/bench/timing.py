"""The timing helpers of the bench package (and of ``chip_smoke.py``).

- :func:`timed_ms`: device milliseconds per call, CUDA events around warm
  calls (a kernel's time);
- :func:`tick_seconds`: host seconds of one ``GridCoordinator.run`` tick,
  closed by a device sync (a step's time, the bench's timed region);
- :func:`timed_run`: an engine's build and one ``n``-generation step, each
  on the host clock and closed by a device sync, with the peak memory
  beyond the start (:func:`peak_start`, :func:`peak_since`);
- :func:`card`: the card's name and power limit as ``nvidia-smi`` reports
  them, written beside every number.

``torch`` is imported inside the calls.
"""

from __future__ import annotations

import subprocess
import time
from typing import Optional


def timed_ms(fn, reps: int) -> float:
    """Device milliseconds per call of ``fn`` over ``reps`` warm calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def tick_seconds(coord, n: int) -> float:
    """Host seconds of one ``coord.run(n)`` tick. The engine's devices are
    synchronized before the clock starts (nothing enqueued earlier lands
    in the window) and again before it stops (``torch.cuda.synchronize``
    of every device the engine steps on: the tick's work is done)."""
    coord.engine.block_until_ready()
    t0 = time.perf_counter()
    coord.run(n)
    coord.engine.block_until_ready()
    return time.perf_counter() - t0


def peak_start(device) -> int:
    """Reset the card's peak-memory statistic; returns the bytes allocated
    now (0 on the CPU)."""
    import torch

    if device.type != "cuda":
        return 0
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    return torch.cuda.memory_allocated(device)


def peak_since(device, base: int) -> Optional[int]:
    """The card's peak bytes beyond ``base`` since :func:`peak_start`;
    None on the CPU (not measured)."""
    import torch

    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) - base


def timed_run(make, n: int, device="cuda"):
    """``(engine, build seconds, step seconds, peak bytes)`` of ``make()``
    stepped ``n`` generations in one step: the build and the step each
    timed on the host clock and closed by a device sync, the peak memory
    beyond what was allocated before (None on the CPU)."""
    from ..engine import resolve_device

    device = resolve_device(device)
    base = peak_start(device)
    t0 = time.perf_counter()
    engine = make()
    engine.block_until_ready()
    t1 = time.perf_counter()
    engine.step(n)
    engine.block_until_ready()
    t2 = time.perf_counter()
    return engine, t1 - t0, t2 - t1, peak_since(device, base)


def nvidia_smi(query: str) -> str:
    """The first line ``nvidia-smi --query-gpu=QUERY`` prints."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def card(device) -> dict:
    """``{"name", "power_limit"}`` of the device a measurement ran on: the
    card's as ``nvidia-smi --query-gpu=name,power.limit`` gives them, or
    ``{"name": "cpu", "power_limit": None}``. On a card whose
    ``nvidia-smi`` cannot be read the name comes from torch and the power
    limit is None (not measured)."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    try:
        name, limit = (s.strip() for s in
                       nvidia_smi("name,power.limit").split(",", 1))
        return {"name": name, "power_limit": limit}
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        index = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        return {"name": torch.cuda.get_device_name(index),
                "power_limit": None}


def card_label(info: Optional[dict]) -> str:
    """``"NAME, LIMIT"`` as ``nvidia-smi`` prints the pair."""
    if not info:
        return "?"
    limit = info.get("power_limit")
    return f"{info['name']}, {limit if limit else 'power limit not measured'}"
