"""Device-memory sampling into the registry's HBM gauges, and the roofline.

Counterpart of ``gameoflifewithactors_tpu.obs.device``. A daemon thread
polls a memory backend into the ``hbm_bytes_in_use``, ``hbm_bytes_peak``
and ``hbm_bytes_limit`` gauges, the budget ``serve/admission.py`` prices
creates against. :func:`roofline_section` folds a runner's cost
(``Engine.runner_cost_analysis``: the packed formulation's bitwise
operations and bytes, :mod:`.cost`) with the measured step rates into
achieved-against-peak shares; :func:`peaks_for` reads the card's peaks
from the device itself (:func:`gpu_peaks`), and a platform without a
model (the CPU) gets ``peak_modelled: None``, never an invented
denominator.

:func:`cuda_memory_backend` reads each card with ``torch.cuda.mem_get_info``
(free and total bytes of the whole card): in use is total minus
free, which counts every process on the card and the caching allocator's
reserve, and the limit is the card's total; the peak is
``torch.cuda.max_memory_allocated`` of this process.
:func:`host_memory_backend` is the CPU stand-in: this process's RSS,
labelled ``source="host_rss"``, and no limit gauge, so admission stays
permissive where no device budget exists (as in the JAX package). Tests
inject their own backend to fake a full card.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, List, Optional

from .registry import REGISTRY, MetricsRegistry

DEFAULT_INTERVAL_S = 1.0
INT32_LANES_PER_SM = 64   # 32-bit integer/logic results per SM per clock

#: Peaks per platform, filled from the device on first use
#: (:func:`peaks_for`); tests may set an entry.
PEAKS: dict = {}


def host_memory_backend() -> List[dict]:
    """One record: this process's resident set as the CPU stand-in for
    device memory (current RSS from /proc, peak from ``ru_maxrss``)."""
    import resource

    rec = {"device": "0", "platform": "cpu", "source": "host_rss",
           "peak_bytes_in_use":
               resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024}
    try:
        with open("/proc/self/statm") as f:
            rec["bytes_in_use"] = int(f.read().split()[1]) * os.sysconf(
                "SC_PAGE_SIZE")
    except OSError:
        rec["bytes_in_use"] = rec["peak_bytes_in_use"]
    return [rec]


def cuda_memory_backend() -> List[dict]:
    """One record per visible CUDA device: device-wide free/total bytes
    (``torch.cuda.mem_get_info``) and this process's allocation peak."""
    import torch

    out = []
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        out.append({"device": str(i), "platform": "gpu",
                    "source": "mem_get_info",
                    "bytes_in_use": int(total - free),
                    "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(i)),
                    "bytes_limit": int(total)})
    return out


class DeviceSampler:
    """Background poller: a memory backend -> registry gauges.

    ``with DeviceSampler(0.5): ...`` or ``start()``/``stop()``. Each sample
    sets ``hbm_bytes_in_use`` / ``hbm_bytes_peak`` / ``hbm_bytes_limit``
    labelled by device and platform (plus ``source`` for the host
    stand-in) and bumps ``device_samples``. ``backend`` is a callable
    returning one dict per device (default :func:`cuda_memory_backend`
    when CUDA is available, else :func:`host_memory_backend`);
    ``sample_once()`` is the deterministic step tests drive."""

    _GAUGES = {"bytes_in_use": ("hbm_bytes_in_use",
                                "device memory currently allocated (bytes)"),
               "peak_bytes_in_use": ("hbm_bytes_peak",
                                     "high-water device allocation (bytes)"),
               "bytes_limit": ("hbm_bytes_limit",
                               "device memory capacity (bytes)")}

    def __init__(self, interval_seconds: float = DEFAULT_INTERVAL_S, *,
                 registry: MetricsRegistry = REGISTRY,
                 backend: Optional[Callable[[], List[dict]]] = None):
        if interval_seconds <= 0:
            raise ValueError(
                f"poll interval must be positive, got {interval_seconds}")
        if backend is None:
            import torch

            backend = cuda_memory_backend if torch.cuda.is_available() \
                else host_memory_backend
        self.interval = float(interval_seconds)
        self.registry = registry
        self._backend = backend
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.samples = 0

    def sample_once(self) -> List[dict]:
        """One poll; returns what the backend reported. Never raises: a
        backend that raises yields an empty sample and a bumped
        ``device_sample_errors`` counter."""
        try:
            stats = self._backend()
        except Exception as exc:  # noqa: BLE001 — telemetry must not kill serving
            # goltpu: ignore[GOL010] -- series name frozen pre-_total convention: committed history.jsonl/RunReports key on it
            self.registry.counter(
                "device_sample_errors",
                "device memory polls that raised").inc(
                    error=type(exc).__name__)
            return []
        for rec in stats:
            labels = {"device": str(rec.get("device", "?")),
                      "platform": str(rec.get("platform", "?"))}
            if rec.get("source") == "host_rss":
                labels["source"] = "host_rss"
            for key, (gname, ghelp) in self._GAUGES.items():
                if rec.get(key) is not None:
                    self.registry.gauge(gname, ghelp).set(
                        float(rec[key]), **labels)
        self.samples += 1
        # goltpu: ignore[GOL010] -- series name frozen pre-_total convention: committed history.jsonl/RunReports key on it
        self.registry.counter(
            "device_samples", "device memory polls completed").inc()
        return stats

    def start(self) -> "DeviceSampler":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._poll, name="device-sampler", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def _poll(self) -> None:
        # sample at once (a short run still leaves gauges), then on the
        # interval until stopped
        self.sample_once()
        while not self._stop.wait(self.interval):
            self.sample_once()

    def __enter__(self) -> "DeviceSampler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# -- roofline attribution -----------------------------------------------------


def _max_sm_clock_mhz(index: int, props) -> float:
    """The card's maximum SM clock: ``nvidia-smi``'s ``clocks.max.sm``, or
    the device properties' clock where that tool is absent."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return props.clock_rate / 1e3   # kHz


def gpu_peaks(index: int = 0) -> dict:
    """The card's peaks, from the device: the HBM rate (two transfers per
    memory clock over the bus width) and the 32-bit integer-op rate (SM
    count x :data:`INT32_LANES_PER_SM` x the maximum SM clock)."""
    import torch

    props = torch.cuda.get_device_properties(index)
    mhz = _max_sm_clock_mhz(index, props)
    hbm = 2 * props.memory_clock_rate * 1e3 * props.memory_bus_width / 8
    return {"device": props.name,
            "hbm_gbps": hbm / 1e9,
            "int_ops_per_sec": props.multi_processor_count
            * INT32_LANES_PER_SM * mhz * 1e6,
            "sms": props.multi_processor_count,
            "max_sm_clock_mhz": mhz,
            "int32_lanes_per_sm": INT32_LANES_PER_SM}


def peaks_for(platform: Optional[str]) -> Optional[dict]:
    """The modelled peaks of ``platform``: ``"gpu"`` reads the card once
    (:func:`gpu_peaks`); any other platform has none."""
    if platform in PEAKS:
        return PEAKS[platform]
    if platform == "gpu":
        import torch

        if torch.cuda.is_available():
            PEAKS["gpu"] = gpu_peaks(torch.cuda.current_device())
            return PEAKS["gpu"]
    return None


def roofline_section(*, cost: Optional[dict] = None,
                     step_records: Optional[list] = None,
                     platform: Optional[str] = None,
                     gens: Optional[int] = None) -> Optional[dict]:
    """Fold a runner's cost with measured step rates.

    ``cost`` is ``Engine.runner_cost_analysis()`` output (``flops`` /
    ``bytes_accessed`` of a ``gens``-generation dispatch; the port counts
    bitwise operations, ``ops_kind="bitwise"``); ``step_records`` are
    StepMetrics dicts or objects. Returns the RunReport ``roofline`` dict
    -- per-generation cost, achieved throughput (best measured record),
    and achieved-against-peak fractions (:func:`peaks_for`) -- or None
    when there is nothing to attribute. The JAX package's function, with
    the card's integer-op peak beside the HBM rate.
    """
    gens = gens or (cost or {}).get("generations") or 1
    section: dict = {}
    if cost:
        flops = cost.get("flops")
        bytes_acc = cost.get("bytes_accessed")
        section["cost_analysis"] = {
            "generations": gens,
            "flops": flops,
            "bytes_accessed": bytes_acc,
            "flops_per_gen": flops / gens if flops else None,
            "bytes_per_gen": bytes_acc / gens if bytes_acc else None,
        }
        if flops and bytes_acc:
            section["cost_analysis"]["arithmetic_intensity"] = \
                flops / bytes_acc
        if cost.get("ops_kind"):
            section["cost_analysis"]["ops_kind"] = cost["ops_kind"]

    best = None
    records = [m if isinstance(m, dict) else m.to_dict()
               for m in step_records or []]
    rated = [m for m in records if m.get("cell_updates_per_sec")]
    if rated:
        best = max(rated, key=lambda m: m["cell_updates_per_sec"])
        rate = best["cell_updates_per_sec"]
        section["achieved"] = {
            "cell_updates_per_sec": rate,
            "records": len(rated),
        }
        ca = section.get("cost_analysis") or {}
        cells_per_gen = None
        if best.get("generations_stepped") and best.get("wall_seconds"):
            cells_per_gen = (rate * best["wall_seconds"]
                             / best["generations_stepped"])
        if ca.get("flops_per_gen") and cells_per_gen:
            # measured rate x per-cell cost = achieved operations and
            # memory traffic of the counted formulation
            section["achieved"]["flops_per_sec"] = \
                rate * ca["flops_per_gen"] / cells_per_gen
            if ca.get("bytes_per_gen"):
                section["achieved"]["bytes_per_sec"] = \
                    rate * ca["bytes_per_gen"] / cells_per_gen

    if not section:
        return None

    peaks = peaks_for(platform)
    section["platform"] = platform
    if peaks:
        section["peak_modelled"] = dict(peaks)
        if best is not None:
            frac = {}
            ach = section.get("achieved", {})
            if ach.get("bytes_per_sec") and peaks.get("hbm_gbps"):
                frac["of_hbm_bandwidth"] = \
                    ach["bytes_per_sec"] / (peaks["hbm_gbps"] * 1e9)
            if ach.get("flops_per_sec") and peaks.get("int_ops_per_sec"):
                frac["of_int_op_peak"] = \
                    ach["flops_per_sec"] / peaks["int_ops_per_sec"]
            if frac:
                section["achieved_fraction"] = frac
    else:
        # no invented denominators: an unmodelled platform says so
        section["peak_modelled"] = None
    return section


def summary_lines(roofline: dict) -> List[str]:
    """The human face of a roofline section (RunReport.summary_lines)."""
    lines = []
    ca = roofline.get("cost_analysis") or {}
    bitwise = ca.get("ops_kind") == "bitwise"
    unit = "bitwise ops" if bitwise else "FLOPs"
    if ca.get("flops_per_gen"):
        per = f"  {ca['flops_per_gen']:.3g} {unit}/gen"
        if ca.get("bytes_per_gen"):
            per += f", {ca['bytes_per_gen']:.3g} HBM bytes/gen"
        if ca.get("arithmetic_intensity"):
            per += f" (intensity {ca['arithmetic_intensity']:.2f})"
        lines.append("roofline (op counts of the packed formulation):"
                     if bitwise else
                     "roofline (XLA cost analysis of the compiled runner):")
        lines.append(per)
    ach = roofline.get("achieved") or {}
    if ach.get("cell_updates_per_sec"):
        line = f"  achieved {ach['cell_updates_per_sec']:.3g} cell-updates/s"
        if ach.get("flops_per_sec"):
            line += (f" = {ach['flops_per_sec']:.3g} "
                     + ("bitwise ops/s" if bitwise else "FLOP/s"))
        if ach.get("bytes_per_sec"):
            line += f", {ach['bytes_per_sec'] / 1e9:.1f} GB/s HBM"
        lines.append(line)
    frac = roofline.get("achieved_fraction") or {}
    peaks = roofline.get("peak_modelled") or {}
    if frac.get("of_hbm_bandwidth") is not None:
        lines.append(
            f"  {frac['of_hbm_bandwidth']:.1%} of the "
            f"{peaks['hbm_gbps']:.0f} GB/s modelled "
            "HBM bound")
    elif roofline.get("peak_modelled") is None and lines:
        lines.append(f"  (no modelled peak for platform "
                     f"{roofline.get('platform')!r})")
    if frac.get("of_int_op_peak") is not None:
        lines.append(
            f"  {frac['of_int_op_peak']:.1%} of the "
            f"{peaks['int_ops_per_sec']:.4g} integer ops/s peak "
            f"({peaks.get('sms')} SMs x {peaks.get('int32_lanes_per_sm')} x "
            f"{peaks.get('max_sm_clock_mhz'):.0f} MHz)")
    return lines
