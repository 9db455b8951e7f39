"""The multi-process run on one card, at a small size: the band runners of
B2's, B3's and B4's slab forms across two gloo processes sharing the card
(each launching its slab form once per chunk, never the full-grid
kernel, the gathered grid equal to the single-device engine), the
elastic fleet recovering from a ``process_kill``, the soak worker killed
and resumed, and NCCL refusing two ranks on one card. Each test skips
without a CUDA device.

This file imports no JAX: ``python -m pytest --noconftest
tests/test_torch_gpu_multiprocess.py``. The helpers are ``chip_smoke.py``'s
multi-process phase, at full size there.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _need_cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.mark.gpu
def test_band_runners_across_two_processes_on_one_card(tmp_path):
    _need_cuda()
    from gameoflifewithactors_torch import Engine, _build
    from gameoflifewithactors_torch.ops.stencil import Topology

    _build.build_all(chip_smoke.KERNELS)   # the workers load, never build
    runs, truths = [], {}
    for spec, states, topology, n in [("B3/S23", 2, Topology.TORUS, 200),
                                      ("brain", 3, Topology.DEAD, 60),
                                      ("bosco", 2, Topology.DEAD, 60)]:
        cells = (np.random.default_rng(5).random((1024, 1024))
                 * states).astype(np.uint8)
        alone = Engine(cells, spec, topology=topology, backend="cuda")
        start = str(tmp_path / f"start_{spec.replace('/', '')}.npy")
        np.save(start, chip_smoke._words(alone.state))
        alone.step(n)
        truths[spec] = chip_smoke._words(alone.state)
        runs.append({"name": spec, "rule": spec, "topology": topology.value,
                     "generations": n, "start": start})
    plan = {"mesh": [2, 2], "per_process": 2, "runs": runs}
    stats = chip_smoke.run_band_group(str(tmp_path), plan, timeout=300)
    chip_smoke.check_band_group(str(tmp_path), plan, stats, truths)


@pytest.mark.gpu
def test_elastic_fleet_recovers_on_the_card(tmp_path):
    _need_cuda()
    report = chip_smoke.fleet_on_card(str(tmp_path), (1024, 1024), 200, 50)
    assert len(report["epochs"]) == 2


@pytest.mark.gpu
def test_soak_worker_killed_and_resumed_on_the_card(tmp_path):
    _need_cuda()
    soak = chip_smoke.soak_on_card(str(tmp_path), (1024, 1024), 200, 50)
    assert soak["report"]["members"][0]["final_generation"] == 200


_NCCL = """
import sys
sys.path.insert(0, sys.argv[3])
from gameoflifewithactors_torch.parallel import multihost
try:
    multihost.initialize("localhost:" + sys.argv[2], 2, int(sys.argv[1]),
                         backend="nccl", initialization_timeout=60,
                         device="cuda:0")
except ValueError as exc:
    print("REFUSED", "gloo" in str(exc))
    sys.exit(0)
print("JOINED")
"""


@pytest.mark.gpu
def test_nccl_refuses_two_ranks_on_one_card():
    _need_cuda()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, "-c", _NCCL, str(r), str(port),
                               REPO], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert out.split() == ["REFUSED", "True"], out + err[-2000:]
