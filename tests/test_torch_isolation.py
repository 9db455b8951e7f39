"""The port stands alone: importing any of its modules, or the smoke
script, loads neither ``jax`` nor ``gameoflifewithactors_tpu``, and no
source of it names either in an import. The smoke script fails, printing
no result, where there is no CUDA device."""

import ast
import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PORT = os.path.join(_REPO, "gameoflifewithactors_torch")
_FORBIDDEN = ("jax", "jaxlib", "gameoflifewithactors_tpu")


def _port_sources():
    for root, _, files in os.walk(_PORT):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(root, name)
    yield os.path.join(_REPO, "chip_smoke.py")


def test_no_source_imports_jax_or_the_jax_package():
    offenders = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{os.path.relpath(path, _REPO)}: {n}" for n in names
                          if n.split(".")[0] in _FORBIDDEN]
    assert offenders == []


_IMPORT_ALL = """
import importlib, pkgutil, sys
import gameoflifewithactors_torch as pkg
for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    if not mod.name.endswith("__main__"):
        importlib.import_module(mod.name)
for name in ("models.generations", "models.ltl", "ops.generations", "ops.ltl",
             "ops.packed_generations", "ops.packed_ltl", "obs.registry",
             "obs.spans", "obs.compile", "obs.flight", "obs.exporter",
             "obs.device", "resilience.supervisor", "parallel.halo",
             "parallel.batched", "parallel.mesh", "parallel.sharded",
             "serve.session", "serve.admission",
             "serve.lanes", "serve.service", "serve.frontend",
             "models.elementary", "ops.elementary", "parallel.multihost",
             "utils.checkpoint", "ops.sparse", "memory", "memory.pool",
             "memory.paged", "obs.watchdog", "obs.report", "obs.profiler",
             "obs.cost", "obs.diff", "obs.aggregate", "utils.profiling",
             "utils.provenance", "utils.fault", "analysis.sanitizers",
             "resilience.faultplan", "aot", "aot.cache", "aot.spec",
             "aot.registry", "aot.warmup", "resilience.distributed",
             "resilience.worker"):
    assert pkg.__name__ + "." + name in sys.modules, name
import chip_smoke
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "gameoflifewithactors_tpu"))
print(len([m for m in sys.modules if m.startswith("gameoflifewithactors_torch")]), loaded)
"""


def test_importing_every_module_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=_REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, loaded = out.stdout.split(" ", 1)
    assert int(count) >= 64   # every module: rule families, obs, serve, aot, ...
    assert loaded.strip() == "[]"


_BLOCKED_RUN = """
import sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "gameoflifewithactors_tpu"):
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, Refuse())
import numpy as np
from gameoflifewithactors_torch import Engine
from gameoflifewithactors_torch.memory import PagedUniverse
from gameoflifewithactors_torch.utils import checkpoint
from gameoflifewithactors_torch.cli import main

u = PagedUniverse("B3/S23", capacity=32, tile_rows=16, tile_words=1,
                  device="cpu")
glider = np.zeros((8, 8), np.uint8)
glider[0, 1] = glider[1, 2] = glider[2, 0] = glider[2, 1] = glider[2, 2] = 1
u.seed_cells(glider, origin=(1, 1))
u.step(64)
e = Engine(np.pad(glider, ((28, 28), (60, 60))), "B3/S23", backend="sparse",
           device="cpu")
e.step(64)
print(u.population(), e.population(), e.active_tiles())
# the observed and supervised run, and the report subcommand
main(["--device", "cpu", "--grid", "48x96", "--steps", "40", "--supervise",
      "--checkpoint-every", "20", "--checkpoint", sys.argv[1] + "/c.npz",
      "--telemetry-out", sys.argv[1] + "/r.json", "--profile-sample", "5"])
main(["report", sys.argv[1] + "/r.json", "--diff", sys.argv[1] + "/r.json"])
# warm start: the warmup pipeline and a registry-served engine
main(["warmup", "--from-config", "--device", "cpu", "--json", "--cache-dir",
      sys.argv[1] + "/warm", "--grid", "32x64", "--backend", "packed"])
assert Engine(np.zeros((32, 64), np.uint8), "B3/S23", backend="packed",
              device="cpu").aot_loaded
"""


def test_the_tiled_backends_run_with_jax_blocked(tmp_path):
    """The memory/ package, the paged universe, the sparse engine and the
    checkpoint module import and step with every import of ``jax`` and the
    JAX package refused; so do a supervised, observed CLI run, the
    ``report`` subcommand, ``warmup`` and a registry-served engine."""
    out = subprocess.run([sys.executable, "-c", _BLOCKED_RUN, str(tmp_path)],
                         cwd=_REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[:3] == ["5", "5", "1"]
    assert "delta" in out.stdout and (tmp_path / "r.json").exists()


def test_chip_smoke_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
