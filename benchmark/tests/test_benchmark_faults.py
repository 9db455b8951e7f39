"""The comparison fails where the timed path is wrong.

Each test drives the rest of a run on the CPU at a small size (the
harness's look for a card skipped) with the timed path broken
underneath, and sees ``correct`` come out false: the control (the
reference in the program's place, with one guarantee of the
configuration broken: dead edges instead of the torus), a step that
returns its state unchanged, half of a lane's batch left out, and an
answer altered where it is produced. A sound run beside them comes out true.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import manifest
from benchmark.chip import control
from benchmark.tests.conftest import drive_cpu, names_of

BATCH = ["conway-batch-16384", "bosco-batch-16384"]
ALL = BATCH + ["conway-sessions-1024"]


def install_control(cell: str, monkeypatch) -> None:
    config, traffic = names_of(cell)
    control.install(manifest.traffic(traffic),
                    manifest.config(manifest.load(), config),
                    monkeypatch.setattr)


@pytest.mark.parametrize("cell", ALL)
def test_a_sound_run_is_correct(cell):
    line = drive_cpu(cell)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("cell", BATCH)
def test_the_control_is_not_correct(cell, monkeypatch):
    install_control(cell, monkeypatch)
    line = drive_cpu(cell)
    assert not line["correct"]
    assert line["checks"]["start_mismatched_cells"]["value"] > 0


def test_the_control_is_not_correct_in_the_lanes(monkeypatch):
    install_control("conway-sessions-1024", monkeypatch)
    line = drive_cpu("conway-sessions-1024")
    assert not line["correct"]
    assert line["checks"]["frame_mismatched_cells"]["value"] > 0


@pytest.mark.parametrize("cell", BATCH)
def test_a_step_that_returns_its_state_unchanged(cell, monkeypatch):
    from gameoflifewithactors_torch.engine import Engine

    monkeypatch.setattr(Engine, "_run", lambda self, state, n: state)
    assert not drive_cpu(cell)["correct"]


def test_a_lane_step_that_returns_its_state_unchanged(monkeypatch):
    from gameoflifewithactors_torch.serve import lanes

    monkeypatch.setattr(lanes, "lane_runner",
                        lambda family: lambda state, n, mask: state)
    assert not drive_cpu("conway-sessions-1024")["correct"]


def test_half_of_the_lane_left_out(monkeypatch):
    from gameoflifewithactors_torch.serve import lanes

    real = lanes.lane_runner

    def runner(family):
        inner = real(family)

        def run(state, n, mask):
            half = np.array(mask, copy=True)
            half[1::2] = 0
            return inner(state, n, half)
        return run

    monkeypatch.setattr(lanes, "lane_runner", runner)
    line = drive_cpu("conway-sessions-1024")
    assert not line["correct"]
    assert line["checks"]["frame_mismatched_cells"]["value"] > 0


@pytest.mark.parametrize("cell", BATCH)
def test_an_answer_altered_where_it_is_produced(cell, monkeypatch):
    from gameoflifewithactors_torch.engine import Engine

    real = Engine._run

    def flipped(self, state, n):
        out = real(self, state, n).clone()
        out.view(-1)[7] ^= 1 << 3
        return out

    monkeypatch.setattr(Engine, "_run", flipped)
    assert not drive_cpu(cell)["correct"]


def test_a_frame_altered_where_it_is_produced(monkeypatch):
    from gameoflifewithactors_torch.serve import service

    real = service.encode_words

    def flipped(words):
        words = np.array(words, copy=True)
        words.reshape(-1)[3] ^= np.uint32(1 << 5)
        return real(words)

    monkeypatch.setattr(service, "encode_words", flipped)
    line = drive_cpu("conway-sessions-1024")
    assert not line["correct"]
