"""What the benchmark may import, by whole top-level module names."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

from benchmark import manifest

JAX = {"jax", "jaxlib", "flax", "gameoflifewithactors_tpu"}
PROGRAM = "gameoflifewithactors_torch"


def modules(folder: str):
    for dirpath, dirnames, filenames in os.walk(folder):
        dirnames[:] = [d for d in dirnames if not d.startswith(("_", "."))]
        for name in filenames:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def top_level_imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_of_the_benchmark_imports_jax():
    seen = 0
    for path in modules(manifest.BENCH_DIR):
        seen += 1
        assert not top_level_imports(path) & JAX, path
    assert seen > 20


def test_the_reference_imports_nothing_of_the_program():
    folder = os.path.join(manifest.BENCH_DIR, "reference")
    for path in modules(folder):
        names = top_level_imports(path)
        assert PROGRAM not in names and not names & JAX, path
        assert names <= {"__future__", "dataclasses", "typing", "torch",
                         "numpy"}, (path, names)


def test_names_are_compared_whole():
    assert "gameoflifewithactors_torch" not in JAX
    from benchmark import run

    assert "gameoflifewithactors_torch" not in run.FORBIDDEN


def test_a_run_leaves_no_jax_module_loaded(tmp_path):
    """A whole run of a cell on the CPU, in a fresh process, holds none of
    the forbidden modules once its window has closed."""
    code = (
        "import json, sys\n"
        "from benchmark.tests.conftest import drive_cpu\n"
        "from benchmark import run\n"
        "line = drive_cpu('conway-batch-16384')\n"
        "print(json.dumps({'correct': line['correct'],"
        " 'forbidden': run.forbidden_modules()}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "forbidden": []}


def test_without_a_card_there_is_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "conway-batch-16384", "--seed", "1", "--seconds", "1"],
        cwd=manifest.ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""
