"""The CLI's observed and supervised run against the JAX CLI, in-process
on the CPU: the ``--supervise`` refusals and the 1D route's refusals of
the new flags say what the JAX CLI says; a supervised run ends on the JAX
CLI's grid; ``--telemetry-out`` and ``--flight-dump`` write their files;
``report --json`` and ``report --diff`` read the reports of both
packages; ``$GOLTPU_PROFILE_SAMPLE_S`` arms the sampler."""

import json
import os

import numpy as np
import pytest

from gameoflifewithactors_torch import cli as t_cli
from gameoflifewithactors_torch.models import seeds
from gameoflifewithactors_torch.obs.report import RunReport
from gameoflifewithactors_torch.utils import checkpoint as t_ckpt
from gameoflifewithactors_tpu import cli as j_cli
from gameoflifewithactors_tpu.obs.report import RunReport as JRunReport


def _soup(tmp_path, shape=(48, 96)):
    path = tmp_path / "soup.rle"
    grid = (np.random.default_rng(9).random(shape) < 0.35).astype(np.uint8)
    path.write_text(seeds.to_rle(grid))
    return ["--grid", f"{shape[0]}x{shape[1]}", "--seed", f"@{path}"]


def _refusal(main, argv):
    with pytest.raises(SystemExit) as exc:
        main(argv)
    return str(exc.value)


@pytest.mark.parametrize("extra", [[], ["--checkpoint", "c.npz", "--rate", "50"]])
def test_supervise_refusals_match_jax(tmp_path, extra):
    argv = _soup(tmp_path) + ["--steps", "4", "--supervise"] + extra
    got = _refusal(t_cli.main, ["--device", "cpu"] + argv)
    want = _refusal(j_cli.main, argv)
    assert got == want and "--supervise" in got


def test_the_1d_route_refuses_the_new_flags_as_jax_does(tmp_path):
    for flag in (["--supervise"], ["--telemetry-out", "t.json"],
                 ["--flight-dump", "f.jsonl"], ["--serve-metrics", "0"],
                 ["--device-poll", "1"], ["--profile-sample", "5"]):
        argv = ["--rule", "W90", "--grid", "1x64", "--steps", "4"] + flag
        got = _refusal(t_cli.main, ["--device", "cpu"] + argv)
        assert got == _refusal(j_cli.main, argv), flag


def test_supervised_cli_run_ends_on_the_jax_clis_grid(tmp_path, capsys):
    argv = _soup(tmp_path) + ["--steps", "60", "--supervise",
                              "--checkpoint-every", "20"]
    assert t_cli.main(["--device", "cpu", "--checkpoint",
                       str(tmp_path / "t.npz")] + argv) == 0
    assert j_cli.main(["--checkpoint", str(tmp_path / "j.npz")] + argv) == 0
    got, meta = t_ckpt.load_grid(tmp_path / "t.npz")
    want, j_meta = t_ckpt.load_grid(tmp_path / "j.npz")
    np.testing.assert_array_equal(got, want)
    assert meta["generation"] == j_meta["generation"] == 60
    assert (tmp_path / "t.npz.prev").exists()


def test_telemetry_out_and_flight_dump_write_their_files(tmp_path):
    report, dump = tmp_path / "run.json", tmp_path / "flight.jsonl"
    # a 1024^2 tick of 400 generations runs far past a 50 ms deadline
    assert t_cli.main(["--device", "cpu", "--grid", "1024x1024", "--seed",
                       "random", "--steps", "400", "--telemetry-out",
                       str(report), "--flight-dump", str(dump),
                       "--stall-deadline", "0.05"]) == 0
    rep = RunReport.load(str(report))
    assert len(rep.stalls) == 1 and rep.stalls[0]["deadline_seconds"] == 0.05
    assert rep.config["argv"][:2] == ["--device", "cpu"]
    assert rep.roofline["cost_analysis"]["ops_kind"] == "bitwise"
    with open(dump) as f:
        header = json.loads(f.readline())
    assert header["type"] == "flight" and "stall" in header["reason"]


def test_report_reads_and_diffs_both_packages(tmp_path, capsys):
    argv = _soup(tmp_path) + ["--steps", "16"]
    t_path, j_path = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    assert t_cli.main(["--device", "cpu", "--telemetry-out", t_path] + argv) == 0
    assert j_cli.main(["--telemetry-out", j_path] + argv) == 0
    capsys.readouterr()
    for path in (t_path, j_path):
        with open(path) as f:
            raw = json.load(f)
        for main, cls in ((t_cli.main, RunReport), (j_cli.main, JRunReport)):
            assert main(["report", path, "--json"]) == 0
            assert json.loads(capsys.readouterr().out) == \
                cls.from_dict(raw).to_dict()
        assert t_cli.main(["report", path]) == 0
        assert "RunReport" in capsys.readouterr().out
    for flags in (["--json"], []):
        assert t_cli.main(["report", j_path, "--diff", t_path] + flags) == 0
        got = capsys.readouterr().out
        assert j_cli.main(["report", j_path, "--diff", t_path] + flags) == 0
        assert got == capsys.readouterr().out


def test_profile_sample_env_arms_the_sampler(tmp_path, monkeypatch):
    monkeypatch.setenv("GOLTPU_PROFILE_SAMPLE_S", "3")
    path = tmp_path / "run.json"
    assert t_cli.main(["--device", "cpu", "--steps", "8", "--telemetry-out",
                       str(path)]) == 0
    rep = RunReport.load(str(path))
    assert rep.profile["windows"] == 1 and rep.profile["period_seconds"] == 3
    assert rep.profile["source"] == "host_tracks"
    assert os.path.exists(tmp_path / "run.attribution.json")
