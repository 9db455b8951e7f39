"""The CLI's output flags against the JAX package's CLI: ``--ppm``,
``--ppm-every``, ``--save-rle``, ``--checkpoint`` and ``--resume`` (a
checkpoint written by one package resumed by the other), ``--list`` and
the 1D W-rule route write byte-equal files and print the same lines.

Every CLI runs in a subprocess (the port's with ``--device cpu``, the JAX
package's with its warm-start cache under ``tmp_path``), so this file
compiles nothing in the test process; one invocation carries several
output flags to keep the file light."""

import os
import subprocess
import sys

import numpy as np
import pytest

from gameoflifewithactors_torch.utils import checkpoint as t_ck
from gameoflifewithactors_tpu.utils import checkpoint as j_ck

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax(tmp_path, *argv):
    return subprocess.run(
        [sys.executable, "-m", "gameoflifewithactors_tpu", *argv,
         "--cache-dir", str(tmp_path / "jax-cache")],
        cwd=_REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))


def _port(*argv):
    return subprocess.run(
        [sys.executable, "-m", "gameoflifewithactors_torch", "--device", "cpu",
         *argv], cwd=_REPO, capture_output=True, text=True, timeout=300)


def _ok(proc):
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def _outputs(tmp_path, who, rule, *argv, resume=None):
    """Run one package's CLI with --ppm, --save-rle and --checkpoint into
    ``tmp_path/<who>``; returns (stdout, the directory)."""
    out = tmp_path / who
    out.mkdir()
    flags = ["--ppm", str(out / "f.ppm"), "--save-rle", str(out / "f.rle"),
             "--checkpoint", str(out / "c.npz"), "--population", *argv]
    if resume is not None:
        flags += ["--resume", str(resume)]
    else:
        flags += ["--rule", rule, "--grid", "48x96", "--seed", "r_pentomino"]
    run = _jax(tmp_path, *flags) if who.startswith("jax") else _port(*flags)
    return _ok(run), out


@pytest.mark.parametrize("rule", ["B3/S23", "brain"])
def test_final_outputs_and_cross_resume_match_jax(rule, tmp_path):
    """--ppm, --save-rle and --checkpoint after 30 generations, then each
    package resumes the other's checkpoint for 11 more."""
    j_out, j_dir = _outputs(tmp_path, "jax", rule, "--steps", "30")
    t_out, t_dir = _outputs(tmp_path, "port", rule, "--steps", "30")
    assert t_out == j_out and t_out.startswith("gen 30  pop ")
    for name in ("f.ppm", "f.rle"):
        assert (t_dir / name).read_bytes() == (j_dir / name).read_bytes(), name
    j_grid, j_meta = j_ck.load_grid(j_dir / "c.npz")
    t_grid, t_meta = t_ck.load_grid(t_dir / "c.npz")
    assert t_meta == j_meta and t_meta["generation"] == 30
    np.testing.assert_array_equal(t_grid, j_grid)

    # each package resumes the OTHER package's checkpoint
    j_out, j_res = _outputs(tmp_path, "jax-resumed", rule, "--steps", "11",
                            resume=t_dir / "c.npz")
    t_out, t_res = _outputs(tmp_path, "port-resumed", rule, "--steps", "11",
                            resume=j_dir / "c.npz")
    assert t_out == j_out and t_out.startswith("gen 41  pop ")
    assert (t_res / "f.ppm").read_bytes() == (j_res / "f.ppm").read_bytes()
    assert t_ck.load_grid(t_res / "c.npz")[1] == \
        j_ck.load_grid(j_res / "c.npz")[1]
    t_rle = (t_res / "f.rle").read_text()
    j_rle = (j_res / "f.rle").read_text()
    if rule == "B3/S23":
        assert t_rle == j_rle   # the --rule default is the resumed rule
    else:
        # the JAX CLI heads a resumed run's RLE with --rule's default
        # B3/S23 (which its own reader cannot decode for a multi-state
        # grid); the port heads it with the resumed rule -- the cells are
        # the same
        assert t_rle.split("\n", 1) == ["x = 96, y = 48, rule = B2/S/C3",
                                        j_rle.split("\n", 1)[1]]
        assert j_rle.startswith("x = 96, y = 48, rule = B3/S23\n")


def test_ppm_every_matches_jax(tmp_path):
    """Frame 0, then every 4 generations and the last: byte-equal files of
    the same names; --ppm-every without --ppm fails with the same
    message."""
    flags = ["--grid", "32x64", "--seed", "glider", "--steps", "9",
             "--ppm-every", "4"]
    for who in ("jax", "port"):
        (tmp_path / who).mkdir()
        run = (_jax(tmp_path, *flags, "--ppm", str(tmp_path / who / "m.ppm"))
               if who == "jax" else
               _port(*flags, "--ppm", str(tmp_path / who / "m.ppm")))
        _ok(run)
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == [f"m_{g:06d}.ppm" for g in (0, 4, 8, 9)]
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    j_run, t_run = _jax(tmp_path, *flags), _port(*flags)
    assert t_run.returncode == j_run.returncode == 1
    assert t_run.stderr.strip().splitlines()[-1] == \
        j_run.stderr.strip().splitlines()[-1] == (
            "--ppm-every needs --ppm PATH as the filename stem for the frame "
            "sequence")


def test_list_matches_jax(tmp_path):
    got = _ok(_port("--list"))
    assert got == _ok(_jax(tmp_path, "--list"))
    assert "brain" in got and "bosco" in got and "W110" in got


@pytest.mark.parametrize("argv", [
    ["--rule", "W90", "--grid", "1x96", "--steps", "40"],
    ["--rule", "rule110", "--grid", "7x128", "--steps", "50", "--seed",
     "random", "--random-p", "0.3", "--rng-seed", "5", "--topology", "dead"],
])
def test_elementary_route_matches_jax(argv, tmp_path):
    """The spacetime diagram, printed (--render final) and as a PPM, from
    the center cell or a numpy random row; the flags the route refuses
    fail as the JAX CLI's do."""
    for who in ("jax", "port"):
        (tmp_path / who).mkdir()
    flags = [*argv, "--render", "final", "--population"]
    j_out = _ok(_jax(tmp_path, *flags, "--ppm", str(tmp_path / "jax/s.ppm")))
    t_out = _ok(_port(*flags, "--ppm", str(tmp_path / "port/s.ppm")))
    assert t_out == j_out and len(t_out.splitlines()) == int(argv[5]) + 2
    assert (tmp_path / "port/s.ppm").read_bytes() == \
        (tmp_path / "jax/s.ppm").read_bytes()
    refused = _port(*argv, "--save-rle", str(tmp_path / "x.rle"))
    assert refused.returncode == 1 and not (tmp_path / "x.rle").exists()
    if argv[1] == "W90":
        want = _jax(tmp_path, *argv, "--save-rle", str(tmp_path / "x.rle"))
        assert want.returncode == 1
        assert refused.stderr.strip().splitlines()[-1] == \
            want.stderr.strip().splitlines()[-1]
    else:
        for flag in (["--checkpoint", str(tmp_path / "x.npz")],
                     ["--mesh", "bands"]):
            got = _port(*argv, *flag)
            assert got.returncode == 1
            assert f"{flag[0]} is not supported" in got.stderr
