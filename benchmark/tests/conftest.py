"""Shared pieces of the benchmark's CPU tests.

``drive`` runs a cell through its driver on the CPU at a small size (the
harness's look for a card is skipped: ``run.main`` refuses without one),
on as many CPU positions as the cell asks for cards, and returns the
result line. Tests that need the card take the ``cuda``
fixture, which skips without one; the decision is taken there, never at
import.
"""

from __future__ import annotations

import pytest
import torch

from benchmark import manifest, run

SMALL = {
    "conway-batch-16384": {"shape": [128, 128], "tick_generations": 8},
    "bosco-batch-16384": {"shape": [96, 96], "tick_generations": 2,
                          "backend": "packed"},
    "conway-sessions-1024": {"shape": [64, 64], "sessions": 8, "tenants": 2,
                             "clients": 2, "step_generations": 8,
                             "sample_share": 0.5},
    # four bands of 64 rows on four CPU positions; B2's slab form runs its
    # plain version there
    "conway-mesh4-65536": {"shape": [256, 1024], "tick_generations": 64,
                           "backend": "cuda"},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips inside the test without one")


def names_of(cell: str) -> tuple:
    """``(configuration, traffic)`` of a cell."""
    w = manifest.workload(manifest.load(), cell)
    return w["config"], w["traffic"]


def drive_cpu(cell: str, seed: int = 2**31 + 11, seconds: float = 0.3,
              trace: bool = False, **overrides) -> dict:
    bench = manifest.load()
    chips = manifest.workload(bench, cell)["chips"]
    config_name, traffic_name = names_of(cell)
    traffic = dict(manifest.traffic(traffic_name), **SMALL[cell])
    traffic.update(overrides)
    spec = run.RunSpec(
        cell=cell, config=manifest.config(bench, config_name),
        traffic=traffic, seed=seed, seconds=seconds, trace=trace,
        devices=[torch.device("cpu")] * chips)
    out = run.drive(spec)
    if trace:
        out["peaks"] = {"int_ops_per_sec": 1.6727e13,
                        "hbm_bytes_per_sec": 3.3523e12}
    return run.result_line(bench, spec, out, {"platform": "cpu"})


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
