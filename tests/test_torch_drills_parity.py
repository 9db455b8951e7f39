"""The port's fleet drills against the JAX package's, without running a
fleet: the chaos drill's fault schedule, the soak's plan and worker
specs, the serve drill's oracle, sampling stride and tenant spread.

The JAX schedules come from ``gameoflifewithactors_tpu``'s
``FaultPlan.generate`` with the arguments of ``scripts/chaos_multihost.py``
and ``scripts/soak.py``; the soak's specs from ``scripts/soak.py``'s own
``build_specs``; the stride from the statements of
``scripts/serve_load.py``'s ``main`` that compute it.
"""

import argparse
import ast
import importlib.util
import os
import textwrap
from pathlib import Path

import numpy as np
import pytest

from gameoflifewithactors_torch.drills import chaos_multihost as t_chaos
from gameoflifewithactors_torch.drills import oracle as t_oracle
from gameoflifewithactors_torch.drills import serve_load as t_serve_load
from gameoflifewithactors_torch.drills import soak as t_soak
from gameoflifewithactors_torch.models.generations import parse_any as t_parse
from gameoflifewithactors_torch.ops.stencil import Topology as TTop
from gameoflifewithactors_tpu.models.generations import parse_any as j_parse
from gameoflifewithactors_tpu.ops.stencil import Topology as JTop
from gameoflifewithactors_tpu.resilience.faultplan import FaultPlan as JPlan

from .oracle import numpy_run as j_numpy_run

_REPO = Path(__file__).resolve().parents[1]


def _load_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_jax_script_{name}", _REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- chaos ---------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_chaos_schedule_equals_jax(seed):
    """``build_events(seed, 4, 120)`` is the JAX drill's call of
    ``FaultPlan.generate`` (scripts/chaos_multihost.py, build_events)."""
    kinds = ("process_kill", "process_preempt", "checkpoint_corrupt")
    want = JPlan.generate(seed, workers=2, horizon=120, faults_per_worker=0,
                          kinds=kinds, ensure_kinds=kinds)
    got = t_chaos.build_events(seed, 4, 120)
    assert [e.to_dict() for e in got] == [e.to_dict() for e in want.events]
    assert {e.kind for e in got} == set(kinds)
    with pytest.raises(AssertionError, match=">= 3 processes"):
        t_chaos.build_events(seed, 2, 120)


# -- soak ----------------------------------------------------------------------

def _soak_args(**kw):
    base = dict(seed=0, duration=60.0, processes=3, generations=240,
                checkpoint_every=40, faults_per_worker=2, kills=1,
                watchdog_deadline=6.0, chunk_sleep=0.3, poll_seconds=0.1,
                grace=120.0)
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("kw", [
    {}, {"seed": 3, "processes": 5}, {"seed": 7, "processes": 7, "kills": 2,
                                      "generations": 80,
                                      "checkpoint_every": 10}])
def test_soak_plan_and_specs_equal_jax(kw, tmp_path):
    """The plan, and every worker spec but its ``device``, equal the JAX
    soak's for the same arguments."""
    j_soak = _load_script("soak")
    args = _soak_args(**kw)
    kill_targets = [w for w in range(args.processes)
                    if j_soak.FLAVOR_ORDER[w % 5] != "ensemble"][:args.kills]
    j_plan = JPlan.generate(
        args.seed, workers=args.processes, horizon=args.generations,
        faults_per_worker=args.faults_per_worker,
        kinds=("corrupt_region", "drop_region", "drop_shard", "stall",
               "retrace"),
        ensure_kinds=("corrupt_region", "stall", "retrace"),
        kill_workers=kill_targets)
    t_args = argparse.Namespace(**vars(args), device="cpu")
    t_plan = t_soak.build_plan(t_args)
    assert t_plan.to_json() == j_plan.to_json()
    assert t_soak.FLAVOR_ORDER == j_soak.FLAVOR_ORDER
    assert t_soak.SHAPES == j_soak.SHAPES
    want = j_soak.build_specs(args, tmp_path, j_plan)
    got = t_soak.build_specs(t_args, tmp_path, t_plan)
    assert [s.pop("device") for s in got] == ["cpu"] * args.processes
    assert got == want
    assert t_soak.plan_kills(t_plan, got) == j_soak.plan_kills(j_plan, want)
    # other shapes (the card's) change the specs' shapes and nothing else
    shapes = {f: (8 * h, 8 * w) for f, (h, w) in t_soak.SHAPES.items()}
    wide = t_soak.build_specs(t_args, tmp_path, t_plan, shapes)
    for spec, base in zip(wide, got):
        assert spec.pop("shape") == [8 * n for n in base.pop("shape")]
        assert spec.pop("device") == "cpu" and spec == base


# -- serve_load ----------------------------------------------------------------

@pytest.mark.parametrize("rule", ["B3/S23", "highlife", "B3678/S34678"])
@pytest.mark.parametrize("topology", ["torus", "dead"])
def test_oracle_equals_the_jax_test_oracle(rule, topology):
    """``drills/oracle.numpy_run`` is ``tests/oracle.numpy_run`` over the
    port's rule and topology: three seeds, every generation 0..13."""
    for seed in range(3):
        cells = (np.random.default_rng(seed).random((19, 23))
                 < 0.4).astype(np.uint8)
        t_state, j_state = cells, cells
        for gen in range(14):
            if gen:
                t_state = t_oracle.numpy_step(t_state, t_parse(rule),
                                              TTop(topology))
                j_state = j_numpy_run(j_state, j_parse(rule),
                                      JTop(topology), 1)
            np.testing.assert_array_equal(t_state, j_state)
        np.testing.assert_array_equal(
            t_oracle.numpy_run(cells, t_parse(rule), TTop(topology), 13),
            j_numpy_run(cells, j_parse(rule), JTop(topology), 13))


def test_advancer_steps_on_from_its_last_check():
    """``oracle_grid`` with an Advancer (steps a session on from its last
    check, forward or back) equals a replay from the seed each time."""
    spec = {"rule": "B36/S23", "height": 16, "width": 32,
            "topology": "dead"}
    adv = t_oracle.Advancer()
    seed = (np.random.default_rng(5).random((16, 32)) < 0.35).astype(np.uint8)
    for gens in (0, 4, 4, 9, 2, 11):
        got = t_serve_load.oracle_grid(spec, 0.35, 5, gens, adv)
        want = j_numpy_run(seed, j_parse("B36/S23"), JTop.DEAD, gens)
        np.testing.assert_array_equal(got, want)


def _jax_stride():
    """The statements of ``scripts/serve_load.py``'s ``main`` that compute
    the sample stride, as a function of (sessions, args, TENANTS)."""
    source = (_REPO / "scripts" / "serve_load.py").read_text()
    main = next(n for n in ast.parse(source).body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    body = next(n for n in main.body if isinstance(n, ast.Try)).body
    first = next(i for i, n in enumerate(body)
                 if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", "") == "stride")
    lines = source.splitlines()
    stmts = body[first:first + 2]
    code = "\n".join(lines[stmts[0].lineno - 1:stmts[1].end_lineno])
    ns = {}
    exec("def stride(sessions, args, TENANTS):\n"
         + textwrap.indent(textwrap.dedent(code), "    ")
         + "\n    return stride\n", ns)
    return ns["stride"]


def test_serve_load_stride_and_tenant_spread_equal_jax():
    j_serve = _load_script("serve_load")
    j_stride = _jax_stride()
    assert t_serve_load.TENANTS == j_serve.TENANTS
    assert t_serve_load.FAMILIES == j_serve.FAMILIES
    for n in range(1, 260):
        for sample in (0, 1, 3, 8, 10, 40, 50, 300):
            assert t_serve_load.sample_stride(n, sample) == j_stride(
                list(range(n)), argparse.Namespace(sample=sample),
                j_serve.TENANTS), (n, sample)
    for i in range(24):
        assert t_serve_load.session_assignment(i) == (
            j_serve.FAMILIES[i % len(j_serve.FAMILIES)],
            j_serve.TENANTS[i % len(j_serve.TENANTS)])
    # every tenant has a sampled session at the JAX and card sizes
    for n, sample in ((200, 40), (100, 20), (24, 8)):
        sampled = range(0, n, t_serve_load.sample_stride(n, sample))
        assert {t_serve_load.session_assignment(i)[1] for i in sampled} == \
            set(t_serve_load.TENANTS)


def test_drills_import_neither_jax_nor_the_test_oracle():
    """The drills carry their own oracle: no import of ``jax``, the JAX
    package or ``tests/``."""
    drills = _REPO / "gameoflifewithactors_torch" / "drills"
    for path in sorted(drills.glob("*.py")):
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            else:
                continue
            assert not any(n.split(".")[0] in ("jax", "tests",
                                               "gameoflifewithactors_tpu")
                           for n in names), (path.name, names)
    assert os.path.exists(drills / "oracle.py")
