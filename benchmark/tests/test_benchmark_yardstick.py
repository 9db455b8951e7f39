"""The frozen copies of the yardstick against the program's originals."""

from __future__ import annotations

import pytest

from benchmark import manifest
from benchmark.yardstick import cost


@pytest.mark.parametrize("name", ["conway-b3s23", "bosco-r5"])
def test_op_counts_equal_the_programs(name):
    from gameoflifewithactors_torch.models.generations import parse_any
    from gameoflifewithactors_torch.obs import cost as program_cost

    config = manifest.config(manifest.load(), name)
    mine = cost.rule_from_config(config)
    theirs = parse_any(config["rule"])
    assert cost.rule_ops_per_word(mine) == program_cost.rule_ops_per_word(theirs)
    words = 16384 * 512
    want = program_cost.packed_cost(theirs, (16384, 16384), 2000)
    got = cost.work(mine, words, 2000, 1)
    assert got == {"ops": want["flops"], "bytes": want["bytes_accessed"]}


def test_the_counts_the_records_name():
    config = manifest.config(manifest.load(), "conway-b3s23")
    assert cost.rule_ops_per_word(cost.rule_from_config(config)) == 20
    config = manifest.config(manifest.load(), "bosco-r5")
    assert cost.rule_ops_per_word(cost.rule_from_config(config)) == 78


def test_peak_formula_copy(monkeypatch):
    import subprocess
    import types

    import torch

    from gameoflifewithactors_torch.obs import device
    from benchmark.yardstick import peaks

    props = types.SimpleNamespace(
        name="card", clock_rate=1_980_000, multi_processor_count=132,
        memory_clock_rate=2_619_000, memory_bus_width=5120)

    def no_smi(*args, **kwargs):
        raise subprocess.SubprocessError("no nvidia-smi here")

    monkeypatch.setattr(subprocess, "run", no_smi)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda i: props)
    mine, theirs = peaks.gpu_peaks(0), device.gpu_peaks(0)
    assert mine["int_ops_per_sec"] == theirs["int_ops_per_sec"] == \
        132 * 64 * 1980 * 1e6
    assert mine["hbm_bytes_per_sec"] == theirs["hbm_gbps"] * 1e9
