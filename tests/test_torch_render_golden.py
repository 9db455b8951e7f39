"""The port's renderings against the JAX suite's golden files, byte for byte.

``tests/test_render_golden.py`` pins the JAX package's ConsoleRenderer
text (plain and ANSI) and ``save_ppm`` bytes over a deterministic run of
each family -- Conway's pulsar, Brian's Brain, a C4 Larger-than-Life plane
stack and W30's spacetime diagram -- in ``tests/golden/``. Here the same
runs go through the port's own engines, ``utils/render.ConsoleRenderer``
and ``save_ppm`` on the CPU, and must write the same bytes; the pulsar
also through ``backend="cuda"`` (B1, whose wrapper runs the kernel's
plain version on the CPU; the Brain's 48-cell rows are no whole number of
words, so no kernel takes them). The goldens belong to the JAX suite: this file never writes them.
"""

import io
import os

import numpy as np
import pytest
import torch

from gameoflifewithactors_torch import Engine
from gameoflifewithactors_torch import engine as engine_mod
from gameoflifewithactors_torch.coordinator import RenderFrame
from gameoflifewithactors_torch.models import seeds
from gameoflifewithactors_torch.models.elementary import parse_elementary
from gameoflifewithactors_torch.ops import bitpack
from gameoflifewithactors_torch.ops.elementary import evolve_spacetime
from gameoflifewithactors_torch.utils.render import ConsoleRenderer, save_ppm

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
_EXPECTED = sorted((
    "conway_pulsar_g2_plain.txt", "conway_pulsar_g2_ansi.txt",
    "brain_g5_plain.txt", "brain_g5.ppm", "ltl_c4_g4.ppm",
    "w30_spacetime.ppm",
))


def _render_text(grid, generation, *, ansi, charset="·█", population=None):
    buf = io.StringIO()
    ConsoleRenderer(buf, ansi=ansi, charset=charset)(RenderFrame(
        grid=grid, generation=generation, population=population,
        full_shape=tuple(grid.shape)))
    return buf.getvalue()


def _ppm_bytes(grid, tmp, name, scale=1):
    path = os.path.join(tmp, name)
    save_ppm(grid, path, scale=scale)
    with open(path, "rb") as f:
        return f.read()


def _conway_pulsar(backend):
    e = Engine(seeds.seeded((17, 32), "pulsar", 2, 9), "B3/S23",
               backend=backend, device="cpu")
    e.step(2)                      # the pulsar has period 3: gen 2 differs
    return e.snapshot(), e.generation, e.population()


def _brain_soup():
    rng = np.random.default_rng(42)
    e = Engine((rng.random((24, 48)) < 0.3).astype(np.uint8), "brain",
               device="cpu")
    e.step(5)
    return e.snapshot(), e.generation


def _ltl_multistate():
    grid = np.random.default_rng(7).integers(0, 4, size=(32, 64), dtype=np.uint8)
    e = Engine(grid, "R2,C4,M1,S3..8,B5..9", device="cpu")
    e.step(4)
    return e.snapshot(), e.generation


def _w30_spacetime():
    row = np.zeros(64, dtype=np.uint8)
    row[32] = 1                    # one seed: W30's cone
    st = evolve_spacetime(bitpack.pack(torch.from_numpy(row[None])), 40,
                          rule=parse_elementary("W30"))
    return bitpack.unpack(st[:, 0, :]).numpy()


def _artifacts(tmp) -> dict:
    """name -> bytes of every golden, rendered by the port."""
    out = {}
    pulsar, gen, pop = _conway_pulsar("auto")
    out["conway_pulsar_g2_plain.txt"] = _render_text(
        pulsar, gen, ansi=False, population=pop).encode()
    out["conway_pulsar_g2_ansi.txt"] = _render_text(
        pulsar, gen, ansi=True, population=pop).encode()
    brain, gen = _brain_soup()
    out["brain_g5_plain.txt"] = _render_text(
        brain, gen, ansi=False, charset="·█▒").encode()
    out["brain_g5.ppm"] = _ppm_bytes(brain, tmp, "brain.ppm")
    ltl, _ = _ltl_multistate()
    out["ltl_c4_g4.ppm"] = _ppm_bytes(ltl, tmp, "ltl.ppm")
    out["w30_spacetime.ppm"] = _ppm_bytes(_w30_spacetime(), tmp, "w30.ppm",
                                          scale=2)
    return out


def _golden(name) -> bytes:
    with open(os.path.join(GOLDEN_DIR, name), "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    return _artifacts(str(tmp_path_factory.mktemp("render")))


@pytest.mark.parametrize("name", _EXPECTED)
def test_golden(name, artifacts):
    got, want = artifacts[name], _golden(name)
    assert got == want, (
        f"the port's {name} differs from the JAX suite's golden "
        f"({len(got)} vs {len(want)} bytes)")


def test_b1_renders_the_pulsar_goldens(monkeypatch):
    """The pulsar on B1 (its plain version on the CPU, the engine told
    that its kernels run there) renders its two goldens."""
    monkeypatch.setattr(engine_mod, "_kernels_run_on", lambda device: True)
    pulsar, gen, pop = _conway_pulsar("cuda")
    for ansi, name in [(False, "conway_pulsar_g2_plain.txt"),
                       (True, "conway_pulsar_g2_ansi.txt")]:
        assert _render_text(pulsar, gen, ansi=ansi,
                            population=pop).encode() == _golden(name), name


def test_golden_dir_has_no_strays():
    on_disk = sorted(f for f in os.listdir(GOLDEN_DIR) if not f.startswith("."))
    assert on_disk == _EXPECTED


def test_families_visibly_distinct(artifacts):
    """The Brain PPM shows its dying state as a grey (>= 3 luminances), the
    LtL PPM its four states, the text both glyphs, the ANSI frame its
    clear-and-home prefix."""
    def lums(ppm: bytes):
        head_end = ppm.index(b"255\n") + 4
        return set(ppm[head_end::3])

    assert len(lums(artifacts["brain_g5.ppm"])) >= 3
    assert len(lums(artifacts["ltl_c4_g4.ppm"])) >= 4
    body = artifacts["conway_pulsar_g2_plain.txt"].decode()
    assert "█" in body and "·" in body
    assert artifacts["conway_pulsar_g2_ansi.txt"].decode().startswith(
        "\x1b[2J\x1b[H")
