"""The card a number was measured on: a frozen copy of the port's helper.

Copied from ``gameoflifewithactors_torch/bench/timing.py`` (``nvidia_smi``
and ``card``, with the card's index added) at commit df56cff: the card's
name and power limit, written beside every number, since a card set
below 700 W runs slower. The bench's tick timer is not copied: the
window's clock runs from the first tick's start to the last tick's sync
(:mod:`..drivers.batch`), so that the host's time between ticks counts.
"""

from __future__ import annotations

import subprocess


def nvidia_smi(query: str, index: int = 0) -> str:
    """The line ``nvidia-smi --query-gpu=QUERY`` prints for card ``index``."""
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", f"--query-gpu={query}",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def card(index: int = 0) -> dict:
    """``{"name", "power_limit"}`` of card ``index`` as ``nvidia-smi``
    gives them; the name from torch and no power limit where that tool
    cannot be read."""
    import torch

    try:
        name, limit = (s.strip() for s in
                       nvidia_smi("name,power.limit", index).split(",", 1))
        return {"name": name, "power_limit": limit}
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return {"name": torch.cuda.get_device_name(index), "power_limit": None}
