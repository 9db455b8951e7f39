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
             "parallel.batched", "serve.session", "serve.admission",
             "serve.lanes", "serve.service", "serve.frontend"):
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
    assert int(count) >= 43   # every module: rule families, obs, serve, ...
    assert loaded.strip() == "[]"


def test_chip_smoke_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
