"""The port's lint engine against the JAX package's: the same fixtures
through both ``lint_sources`` give the same ``(path, code, line)`` findings
for the engine's own GOL000, the pragmas and the baseline, and for the
rules carried over unchanged (GOL004, 005, 007, 009, 010); the CLI's exit
codes 0/1/2, ``--json``, ``--sarif`` and ``--write-baseline``; the port's
tree lints clean with its empty baseline; and the engine's three modules
import neither torch nor jax.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import pytest

from gameoflifewithactors_torch.analysis import lint as port_lint
from gameoflifewithactors_tpu.analysis import lint as jax_lint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARRIED = ("GOL004", "GOL005", "GOL007")
CARRIED_PROJECT = ("GOL009", "GOL010")

FIXTURES = {
    "locks": {
        "pkg/obs/rec.py": """
            import threading

            class Recorder:
                def __init__(self):
                    self._events = []
                    self._lock = threading.Lock()

                def record(self, ev):
                    self._events.append(ev)

                def record_locked(self, ev):
                    with self._lock:
                        self._events.append(ev)
            """,
        "pkg/utils/rec.py": """
            import threading

            class Recorder:
                def __init__(self):
                    self._events = []
                    self._lock = threading.Lock()

                def record(self, ev):
                    self._events.append(ev)
            """},
    "cache": {
        "pkg/obs/agg.py": """
            import threading

            class Agg:
                def __init__(self):
                    self._cache = None
                    self._lock = threading.Lock()

                def scrape(self):
                    return self._cache

                def scrape_locked(self):
                    with self._lock:
                        c = self._cache
                    return c
            """},
    "pragmas": {
        "pkg/clock.py": '''
            import time

            a = time.time()  # goltpu: ignore[GOL005] -- epoch stamp for a header
            # goltpu: ignore[GOL005] -- epoch stamp, standalone form
            b = time.time()
            c = time.time()  # goltpu: ignore[GOL005]
            d = time.time()  # goltpu: ignore[GOL006] -- wrong code on purpose
            x = 1  # goltpu: ignore[BOGUS] -- not a real code
            DOC = "say # goltpu: ignore[GOLnnn] -- reason to suppress"
            '''},
    "lock-order": {
        "pkg/obs/pair.py": """
            import threading


            class Alpha:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._beta = Beta()

                def tick(self):
                    with self._lock:
                        self._beta.poke()


            class Beta:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._alpha = Alpha()

                def poke(self):
                    with self._lock:
                        self._alpha.tick()

                def again(self):
                    with self._lock:
                        with self._lock:
                            pass
            """},
    "metrics": {
        "pkg/obs/aggregate.py": """
            PER_CHIP_GAUGES = frozenset({"hbm_bytes_in_use"})
            """,
        "pkg/obs/a.py": """
            from .registry import REGISTRY
            REGISTRY.counter("stalls", "no _total suffix")
            REGISTRY.gauge("hbm_bytes_peak", "per-chip, not listed")
            REGISTRY.gauge("dual_kind", "a gauge here")
            # goltpu: ignore[GOL010] -- series name frozen on purpose
            REGISTRY.counter("frozen", "pragma'd")
            """,
        "pkg/serve/b.py": """
            from ..obs.registry import REGISTRY
            REGISTRY.histogram("dual_kind", "a histogram there")
            REGISTRY.counter("requests_total", "conventional")
            """},
}


def _lint(lib, sources, baseline=None):
    rules = {c: lib.RULES[c] for c in CARRIED}
    project = {c: lib.PROJECT_RULES[c] for c in CARRIED_PROJECT}
    return lib.lint_sources(
        {p: textwrap.dedent(s) for p, s in sources.items()},
        baseline=baseline, rules=rules, project_rules=project)


def _found(result):
    return sorted((f.path, f.code, f.line) for f in result.findings)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_carried_rules_and_pragmas_match_the_jax_engine(name):
    port = _lint(port_lint, FIXTURES[name])
    ref = _lint(jax_lint, FIXTURES[name])
    assert _found(port) == _found(ref)
    assert sorted((f.path, f.code, f.line) for f in port.suppressed) == \
        sorted((f.path, f.code, f.line) for f in ref.suppressed)
    assert _found(port)          # every fixture has something to find
    # the same words, the port spelling its dashes in ASCII
    assert [f.message for f in port.findings] == \
        [f.message.replace(" \u2014 ", " -- ") for f in ref.findings]


def test_baseline_grandfathers_like_the_jax_engine():
    sources = FIXTURES["pragmas"]
    first = _lint(port_lint, sources)
    baseline = [f.to_dict() for f in first.findings]
    for lib in (port_lint, jax_lint):
        res = _lint(lib, sources, baseline=baseline)
        gol000 = [f for f in res.findings if f.code == "GOL000"]
        assert res.findings == gol000 or res.ok
        assert len(res.baselined) == len(baseline)
        assert res.unused_baseline == []
    stale = baseline + [{"code": "GOL005", "path": "gone.py", "message": "x"}]
    assert _lint(port_lint, sources, baseline=stale).unused_baseline == \
        _lint(jax_lint, sources, baseline=stale).unused_baseline == [stale[-1]]


def test_rule_codes_are_the_jax_packages():
    port = set(port_lint.RULES) | set(port_lint.PROJECT_RULES)
    ref = set(jax_lint.RULES) | set(jax_lint.PROJECT_RULES)
    assert port == ref == {f"GOL{i:03d}" for i in range(1, 11)}


def test_cli_module_entry_exit_codes(tmp_path):
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    dirty = tmp_path / "dirty.py"
    dirty.write_text("import time\nt = time.time()\n")
    run = [sys.executable, "-m", "gameoflifewithactors_torch.analysis.lint",
           "--baseline", "none"]
    out = [subprocess.run(run + [str(p)], cwd=REPO, capture_output=True,
                          text=True, timeout=120).returncode
           for p in (clean, dirty, tmp_path / "missing.py")]
    assert out == [0, 1, 2]


def test_cli_json_sarif_and_bad_input(tmp_path, capsys):
    dirty = tmp_path / "dirty.py"
    dirty.write_text("import time\nt = time.time()\n")
    sarif = tmp_path / "out.sarif"
    assert port_lint.main([str(dirty), "--baseline", "none", "--json",
                           "--sarif", str(sarif)]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["exit_code"] == 1 and not doc["ok"]
    assert [x["code"] for x in doc["findings"]] == ["GOL005"]
    run = json.loads(sarif.read_text())["runs"][0]
    assert {"GOL001", "GOL010"} <= {r["id"] for r in run["tool"]["driver"]["rules"]}
    (res,) = run["results"]
    assert res["ruleId"] == "GOL005"
    assert res["locations"][0]["physicalLocation"]["region"]["startLine"] == 2
    broken = tmp_path / "broken.py"
    broken.write_text("def (:\n")
    assert port_lint.main([str(broken), "--baseline", "none"]) == 2
    badbase = tmp_path / "b.json"
    badbase.write_text("[]")
    assert port_lint.main([str(dirty), "--baseline", str(badbase)]) == 2


def test_write_baseline_round_trips_to_exit_0(tmp_path, capsys):
    for name, body in [("zz.py", "import time\nt = time.time()\n"),
                       ("aa.py", "import torch\nf = torch.compile(len)\n")]:
        (tmp_path / name).write_text(body)
    base = tmp_path / "base.json"
    assert port_lint.main([str(tmp_path), "--baseline", str(base),
                           "--write-baseline"]) == 0
    assert len(json.loads(base.read_text())["findings"]) == 2
    assert port_lint.main([str(tmp_path), "--baseline", str(base),
                           "--strict-baseline"]) == 0
    capsys.readouterr()


def test_the_port_tree_lints_clean_with_its_empty_baseline():
    """The package, chip_smoke.py and tests/test_torch_*.py: no finding
    beyond an inline pragma with a reason; the six frozen counter names
    of obs/ are among the suppressed."""
    with open(port_lint.DEFAULT_BASELINE) as f:
        assert json.load(f) == {"version": 1, "findings": []}
    paths = [os.path.join(REPO, p) for p in port_lint.default_paths()]
    assert any(p.endswith("chip_smoke.py") for p in paths)
    res = port_lint.lint_paths(paths, baseline=[])
    assert res.ok, [f.format() for f in res.findings] + res.errors
    frozen = sorted(os.path.basename(f.path) for f in res.suppressed
                    if f.code == "GOL010")
    assert frozen == ["compile.py", "compile.py", "device.py", "device.py",
                      "profiler.py", "watchdog.py"]


def test_the_engine_imports_neither_torch_nor_jax():
    """lint.py, rules.py and dataflow.py load alone (no package import),
    with torch and jax poisoned."""
    code = textwrap.dedent("""
        import importlib.util, os, sys, types
        for bad in ("torch", "jax", "numpy"):
            sys.modules[bad] = None
        pkg_dir = os.path.join(sys.argv[1], "gameoflifewithactors_torch",
                               "analysis")
        pkg = types.ModuleType("standalone_lint")
        pkg.__path__ = [pkg_dir]
        sys.modules["standalone_lint"] = pkg
        spec = importlib.util.spec_from_file_location(
            "standalone_lint.lint", os.path.join(pkg_dir, "lint.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules["standalone_lint.lint"] = mod
        spec.loader.exec_module(mod)
        rep = mod.lint_source("import time\\nt = time.time()\\n", "m.py")
        loaded = sorted(m for m in sys.modules if m.startswith("standalone"))
        print([f.code for f in rep.findings], loaded)
    """)
    out = subprocess.run([sys.executable, "-c", code, REPO],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == (
        "['GOL005'] ['standalone_lint', 'standalone_lint.dataflow', "
        "'standalone_lint.lint', 'standalone_lint.rules']")
