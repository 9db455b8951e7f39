"""Warm start, layer 3: the port's manifest reader, the ``warmup``
subcommand and ``serve --manifest`` on the CPU. The manifest reader is
held against the JAX package's on the same files (entries, extras and
error messages); ``warmup`` runs in-process through ``cli.main`` into a
temporary cache root, its rows' specs and backends against the JAX
package's ``EngineSpec``; ``serve --manifest`` (a process that runs until
SIGTERM) is driven over HTTP in a subprocess."""

import json
import os
import signal
import subprocess
import sys
import urllib.request

import numpy as np
import pytest

import gameoflifewithactors_torch as tg
from gameoflifewithactors_torch import _build, cli
from gameoflifewithactors_torch.aot import cache as aot_cache
from gameoflifewithactors_torch.aot import warmup as aot_warmup
from gameoflifewithactors_torch.config import from_args
from gameoflifewithactors_tpu.aot import EngineSpec as JaxSpec
from gameoflifewithactors_tpu.aot import warmup as jax_warmup
from gameoflifewithactors_tpu.config import from_args as jax_from_args

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SHIPPED = os.path.join(_REPO, "results", "serve_manifest.json")


@pytest.fixture
def restore_root():
    """Put the process's cache root back after a test re-points it."""
    saved, build_dir = dict(aot_cache._state), _build.BUILD_DIR
    yield
    aot_cache._state.update(saved)
    _build.BUILD_DIR = build_dir


def _write(tmp_path, entries, name="m.json"):
    path = tmp_path / name
    path.write_text(json.dumps(entries))
    return str(path)


def test_manifest_entries_match_jax(tmp_path):
    hand = _write(tmp_path, [
        {"rule": "B3/S23", "shape": [32, 64], "backend": "packed"},
        {"rule": "brain", "height": 32, "width": 64, "lanes": [1, 8]},
        {"rule": "bosco", "shape": [64, 64], "mesh": [2, 1]},
    ])
    for path in (_SHIPPED, hand):
        ours = aot_warmup.load_manifest_entries(path)
        theirs = jax_warmup.load_manifest_entries(path)
        assert [(s.canonical(), e) for s, e in ours] == \
            [(s.canonical(), e) for s, e in theirs]
        assert [s.describe() for s in aot_warmup.load_manifest(path)] == \
            [s.describe() for s in jax_warmup.load_manifest(path)]
    assert aot_warmup.MANIFEST_EXTRAS == jax_warmup.MANIFEST_EXTRAS


@pytest.mark.parametrize("bad", [
    {"not": "a list"},
    [{"rule": "B3/S23", "shape": [32, 64], "lanes": []}],
    [{"rule": "B3/S23", "shape": [32, 64], "lanes": [0, 8]}],
    [{"rule": "B3/S23", "shape": [32, 64], "lanes": "1,8"}],
    [{"rule": "B3/S23", "shape": [32, 64], "lanes": [1.5]}],
    [{"rule": "B3/S23", "shape": [32, 64], "ladder": [1]}],
], ids=["not-a-list", "empty", "zero", "string", "float", "unknown-field"])
def test_manifest_errors_match_jax(bad, tmp_path):
    path = _write(tmp_path, bad)
    with pytest.raises(ValueError) as ours:
        aot_warmup.load_manifest_entries(path)
    with pytest.raises(ValueError) as theirs:
        jax_warmup.load_manifest_entries(path)
    assert str(ours.value) == str(theirs.value)


def test_warmup_from_config_json(tmp_path, capsys, restore_root):
    root = str(tmp_path / "root")
    flags = ["--grid", "48x96", "--rule", "brain", "--topology", "dead"]
    rc = cli.main(["warmup", "--from-config", "--device", "cpu", "--json",
                   "--cache-dir", root] + flags)
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    (row,) = out["specs"]
    assert out["warmup"] is True
    assert set(row) == {"spec", "resolved_backend", "wall_seconds",
                        "compile_seconds", "events", "aot"}
    jspec = JaxSpec.from_config(jax_from_args(flags)[0])
    assert row["spec"] == jspec.canonical()
    assert row["resolved_backend"] == jspec.resolve().backend == "packed"
    assert row["aot"] == "serialized" and row["compile_seconds"] == 0
    assert _build.BUILD_DIR == os.path.join(root, "cuda")
    assert any(n.endswith(".json") for n in
               os.listdir(os.path.join(root, "torch_aot")))


def test_warmup_manifest_fills_the_registry(tmp_path, capsys, restore_root):
    root = str(tmp_path / "root")
    manifest = _write(tmp_path, [
        {"rule": "B3/S23", "shape": [32, 64], "backend": "packed",
         "lanes": [1, 8, 64]},
        {"rule": "bosco", "shape": [32, 64], "topology": "dead"},
        {"rule": "brain", "shape": [32, 64], "backend": "sparse"},
        {"rule": "brain", "shape": [32, 64], "lanes": [1]},
    ])
    assert cli.main(["warmup", "--manifest", manifest, "--device", "cpu",
                     "--cache-dir", root]) == 0
    captured = capsys.readouterr()
    assert "warmed 4 spec(s)" in captured.out
    assert f"kernel build cache: {os.path.join(root, 'cuda')}" in captured.err
    rows = aot_warmup.warmup_specs(
        aot_warmup.load_manifest_entries(manifest), device="cpu")
    assert [r["resolved_backend"] for r in rows] == \
        ["packed", "dense", "sparse", "packed"]
    assert [r["aot"].split(":")[0] for r in rows] == \
        ["serialized", "serialized", "unsupported", "serialized"]
    assert rows[0]["lanes"] == {
        "capacities": [1, 8, 64],
        "status": "warmed the lane kernel for B3/S23|32x64|torus|packed "
                  "(3 capacities need no warming)"}
    # the lane layer refuses multi-state rules: the report says so
    assert rows[3]["lanes"]["status"].startswith("unsupported: ")
    grid = np.random.default_rng(1).integers(0, 2, (32, 64), dtype=np.uint8)
    assert tg.Engine(grid, "B3/S23", backend="packed", device="cpu").aot_loaded
    assert tg.Engine(grid, "bosco", topology=tg.Topology.DEAD,
                     device="cpu").aot_loaded


def test_warmup_no_aot_writes_no_record(tmp_path, capsys, restore_root):
    root = str(tmp_path / "root")
    assert cli.main(["warmup", "--from-config", "--no-aot", "--json",
                     "--device", "cpu", "--cache-dir", root,
                     "--grid", "32x64"]) == 0
    (row,) = json.loads(capsys.readouterr().out)["specs"]
    assert row["aot"] is None
    assert not os.path.exists(os.path.join(root, "torch_aot"))


def test_warmup_needs_exactly_one_mode(tmp_path, capsys):
    manifest = _write(tmp_path, [{"rule": "B3/S23", "shape": [32, 64]}])
    for argv in (["warmup"], ["warmup", "--manifest", manifest, "--from-config"],
                 ["warmup", "--manifest", manifest, "--grid", "32x64"]):
        with pytest.raises(SystemExit):
            cli.main(argv + ["--device", "cpu"])
    assert "exactly one of --manifest / --from-config" in capsys.readouterr().err


def test_cache_dir_flag_points_the_run_at_its_root(tmp_path, restore_root):
    root = str(tmp_path / "root")
    cfg, _ = from_args(["--device", "cpu", "--grid", "32x64",
                        "--cache-dir", root])
    assert cfg.cache_dir == root
    coordinator, _ = cfg.build()
    coordinator.run(4)
    assert _build.BUILD_DIR == os.path.join(root, "cuda")
    assert from_args([])[0].cache_dir is None


def test_serve_manifest_warms_the_lane_ladder(tmp_path):
    manifest = _write(tmp_path, [
        {"rule": "B3/S23", "shape": [32, 64], "backend": "packed",
         "lanes": [1, 8]},
        {"rule": "bosco", "shape": [32, 64]},
    ])
    proc = subprocess.Popen(
        [sys.executable, "-m", "gameoflifewithactors_torch", "serve",
         "--device", "cpu", "--port", "0", "--manifest", manifest,
         "--cache-dir", str(tmp_path / "root"), "--flight-dump",
         str(tmp_path / "f.jsonl")],
        cwd=_REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("SERVE_PORT "), proc.stderr.read()
        port = int(line.split()[1])
        body = json.dumps({"spec": {"rule": "B3/S23", "height": 32,
                                    "width": 64}, "fill": 0.3}).encode()
        reply = urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{port}/sessions", data=body, method="POST"),
            timeout=60)
        assert reply.status == 201
        assert json.loads(reply.read())["spec"]["backend"] == "packed"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        err = proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert "warmed lane ladder (1, 8, 64, 256) for B3/S23|32x64|torus|packed" \
        in err
    assert err.count("warmed lane ladder") == 1   # the engine-only entry is not
