"""The card's peaks: a frozen copy of the port's formula.

Copied from ``gameoflifewithactors_torch/obs/device.py`` (``gpu_peaks``
and ``_max_sm_clock_mhz``) at commit df56cff. The integer-op peak is the
SM count x 64 32-bit integer results per SM and clock x the maximum SM
clock. NVIDIA's data sheet gives no INT32 rate for the H100, so the
figure is read from the device; the HBM rate is two transfers per memory
clock over the bus width. The card's power limit is read beside them
(:func:`.timing.card`), since a card set below 700 W runs slower.
"""

from __future__ import annotations

import subprocess

INT32_LANES_PER_SM = 64   # 32-bit integer/logic results per SM per clock


def _max_sm_clock_mhz(index: int, props) -> float:
    """The card's maximum SM clock: ``nvidia-smi``'s ``clocks.max.sm``, or
    the device properties' clock where that tool is absent."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return props.clock_rate / 1e3   # kHz


def gpu_peaks(index: int = 0) -> dict:
    """``int_ops_per_sec`` and ``hbm_bytes_per_sec`` of card ``index``,
    with the figures they are made of."""
    import torch

    props = torch.cuda.get_device_properties(index)
    mhz = _max_sm_clock_mhz(index, props)
    hbm = 2 * props.memory_clock_rate * 1e3 * props.memory_bus_width / 8
    return {"int_ops_per_sec": props.multi_processor_count
            * INT32_LANES_PER_SM * mhz * 1e6,
            "hbm_bytes_per_sec": hbm,
            "sms": props.multi_processor_count,
            "max_sm_clock_mhz": mhz,
            "int32_lanes_per_sm": INT32_LANES_PER_SM}
