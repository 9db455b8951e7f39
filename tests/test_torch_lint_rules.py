"""The port's retargeted lint rules on torch fixtures: for each of GOL001
(host sync in a step loop), GOL002 (Python branch on a tensor), GOL003
(a runner writing its tensor argument undeclared), GOL006 (a build, a
graph capture or torch.compile outside its choke point) and GOL008 (a
caller-owned array's alias written in place) a positive fixture fires
and a negative one stays quiet.
"""

from __future__ import annotations

import textwrap

from gameoflifewithactors_torch.analysis.lint import lint_source

STEP = "gameoflifewithactors_torch/ops/fixture.py"


def codes(src, path=STEP, only=None):
    rep = lint_source(textwrap.dedent(src), path)
    assert rep.error is None, rep.error
    return [(f.code, f.line) for f in rep.findings
            if only is None or f.code == only]


def test_gol001_fires_on_syncs_in_a_runner_closure():
    src = """
        import torch

        def make_runner(rule):
            def helper(x):
                return x.tolist()

            def run(state, n):
                for _ in range(int(n)):
                    a = state.sum().item()
                    b = int(state.any())
                    idx = torch.nonzero(state)
                    host = state.cpu().numpy()
                    print(a)
                    helper(state)
                return state

            return run
        """
    # one finding per expression: .cpu().numpy() is one read back
    assert codes(src) == [("GOL001", 6), ("GOL001", 10), ("GOL001", 11),
                          ("GOL001", 12), ("GOL001", 13), ("GOL001", 14)]


def test_gol001_quiet_on_declared_and_host_side_reads():
    src = """
        import numpy as np
        import torch
        from gameoflifewithactors_torch.analysis import sanitizers

        def make_runner(rule):
            def run(state, n, mask):
                sel = np.flatnonzero(np.asarray(mask))
                for _ in range(int(n)):
                    with sanitizers.allow_host_transfers("counted once"):
                        k = int(state.sum())
                    state = state + k + len(sel)
                return state

            return run

        def not_a_runner(state):
            return state.cpu()
        """
    assert codes(src) == []
    # outside the step-loop modules a runner closure is not a step loop
    assert codes("""
        def make(x):
            def run(s):
                return s.item()
            return run
        """, path="gameoflifewithactors_torch/serve/fixture.py") == []


def test_gol001_fires_in_a_guard_scope_anywhere_and_a_pragma_declares():
    src = """
        from gameoflifewithactors_torch.analysis import sanitizers

        def drive(engine, t, dev):
            with sanitizers.no_implicit_host_transfers(dev):
                engine.step(8)
                n = int(t.sum())
                # goltpu: ignore[GOL001] -- the negative control: must raise
                m = int(t.sum())
            return n + m + int(t.sum())
        """
    assert codes(src, path="chip_smoke.py") == [("GOL001", 7)]


def test_gol002_fires_on_tensor_branches_and_not_on_host_ones():
    src = """
        import torch

        def make_runner(rule):
            def run(state, n):
                if state.any():
                    pass
                while (state != 0).all():
                    break
                assert torch.equal(state, state)
                if n > 1 and state.shape[0] > 2 and state is not None:
                    pass
                if len(rule.born):
                    pass
                return state

            return run
        """
    assert codes(src, only="GOL002") == [("GOL002", 6), ("GOL002", 8),
                                         ("GOL002", 10)]


def test_gol003_fires_on_undeclared_in_place_writes():
    src = """
        def make_runner(rule):
            def gen(buf, idx):
                view = buf.view(-1)
                view[idx] = 0

            def run(state, n, out):
                state[0] = 1
                state.copy_(state + 1)
                state.add_(1)
                torch.add(out, 1, out=state)
                gen(state, 0)
                return state

            return run
        """
    assert codes(src, only="GOL003") == [("GOL003", 5), ("GOL003", 8),
                                         ("GOL003", 9), ("GOL003", 10),
                                         ("GOL003", 11)]


def test_gol003_quiet_when_declared_or_pure():
    src = """
        from gameoflifewithactors_torch.ops._builders import steps_in_place

        def make_declared(rule):
            @steps_in_place
            def run(state, n):
                state[0] = 1
                return state

            return run

        def make_wrapped(rule):
            def gen(buf):
                buf.zero_()

            def run(state, n):
                gen(state)
                return state

            return steps_in_place(run)

        def make_pure(rule):
            def run(state, n):
                out = state.clone()
                out[0] = 1
                fresh = torch.zeros_like(state)
                fresh.add_(1)
                return out + fresh

            return run
        """
    assert codes(src, only="GOL003") == []


def test_gol006_fires_on_builds_graphs_and_compile_outside_choke_points():
    src = """
        import ctypes
        import subprocess
        import torch
        from torch.utils import cpp_extension

        lib = ctypes.CDLL("x.so")
        ext = cpp_extension.load(name="k", sources=["k.cu"])
        subprocess.run(["nvcc", "-o", "k.so", "k.cu"])
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            pass
        fast = torch.compile(len)
        torch.ops.load_library("k.so")
        subprocess.run(["cuobjdump", "-sass", "k.so"])
        """
    assert codes(src, path="gameoflifewithactors_torch/engine.py") == [
        ("GOL006", 7), ("GOL006", 8), ("GOL006", 9), ("GOL006", 10),
        ("GOL006", 11), ("GOL006", 13), ("GOL006", 14)]


def test_gol006_quiet_at_the_choke_points():
    build = """
        import ctypes
        import subprocess

        def build(nvcc, src):
            subprocess.run([nvcc, "-o", "k.so", src])
            return ctypes.CDLL("k.so")
        """
    assert codes(build, path="gameoflifewithactors_torch/_build.py") == []
    graphs = """
        import torch

        def capture(run, state):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                run(state)
            return g
        """
    assert codes(graphs,
                 path="gameoflifewithactors_torch/aot/registry.py") == []


def test_gol008_fires_on_caller_arrays_written_in_place():
    src = """
        import torch
        from ..parallel.batched import make_multi_step_paged

        def seed(words, other):
            t = torch.from_numpy(words)
            t[0] = 1
            v = torch.as_tensor(other).view(-1)
            v.zero_()

        def step(tiles, n, nbr, mask):
            run = make_multi_step_paged("B3/S23")
            return run(torch.as_tensor(tiles), n, nbr, mask)

        class Pool:
            def __init__(self, slab):
                self.slab = torch.from_numpy(slab)

            def release(self, slot):
                self.slab[slot] = 0
        """
    assert codes(src, only="GOL008") == [("GOL008", 7), ("GOL008", 9),
                                         ("GOL008", 13), ("GOL008", 20)]


def test_gol008_quiet_when_the_chain_is_broken():
    src = """
        import numpy as np
        import torch

        def seed(words, other, grid):
            t = torch.from_numpy(words).clone()
            t[0] = 1
            u = torch.tensor(other)
            u.zero_()
            host = np.array(grid, copy=True)
            cells = torch.from_numpy(host)
            cells[0] = 1
            return t, u, cells

        class Pool:
            def __init__(self, slab):
                self.slab = torch.as_tensor(slab).clone()

            def release(self, slot):
                self.slab[slot] = 0
        """
    assert codes(src, only="GOL008") == []
