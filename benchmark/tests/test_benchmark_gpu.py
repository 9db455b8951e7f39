"""On the card: a cell's command prints a result line of the contract's
form. Skips without a card (the ``cuda`` fixture decides)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import manifest


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_prints_a_correct_result(cuda, trace):
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "conway-batch-16384", "--seed", str(2**31 + 3), "--seconds", "2",
         "--trace", str(trace)],
        cwd=manifest.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu"
    want = manifest.cell_metrics(manifest.load(), "conway-batch-16384",
                                 bool(trace))
    assert set(line["metrics"]) == {m["name"] for m in want}
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
