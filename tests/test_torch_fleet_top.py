"""The port's ``obs/fleet_top`` against the JAX package's
``scripts/fleet_top.py``: the same columns, rows and per-chip rule over
the port's registry and exporter, and a ``--once`` frame over two live
port workers' ``/metrics`` (a CPU ``SessionService`` and an armed
profiler's gauges)."""

import importlib.util
import os
import socket

from gameoflifewithactors_torch.obs import fleet_top as ft
from gameoflifewithactors_torch.obs.aggregate import parse_exposition
from gameoflifewithactors_torch.obs.exporter import (MetricsServer,
                                                      render_prometheus)
from gameoflifewithactors_torch.obs.registry import MetricsRegistry

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_fleet_top():
    spec = importlib.util.spec_from_file_location(
        "jax_fleet_top", os.path.join(_REPO, "scripts", "fleet_top.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _profiled_registry():
    reg = MetricsRegistry()
    reg.gauge("profile_duty_cycle", "g").set(0.02)
    reg.gauge("profile_overhead_ratio", "g").set(0.013)
    return reg


def test_fleet_top_shows_profiler_duty_and_overhead():
    """PROF (duty cycle) and PROF-OH (measured overhead) from the profile
    gauges, '-' when unarmed or down; every row equal to the JAX
    script's over the same exposition."""
    from gameoflifewithactors_tpu.obs.aggregate import \
        parse_exposition as jax_parse

    jft = _jax_fleet_top()
    assert ft.COLUMNS == jft.COLUMNS
    assert ft.COLUMNS[-2:] == ("PROF", "PROF-OH")
    armed = render_prometheus(_profiled_registry().snapshot())
    row = ft.row_for("w0", parse_exposition(armed))
    assert row[-2] == "2.0%" and row[-1] == "1.3%"
    # unarmed worker: dashes, never a fabricated zero
    empty = render_prometheus(MetricsRegistry().snapshot())
    unarmed = ft.row_for("w1", parse_exposition(empty))
    assert unarmed[-2] == "-" and unarmed[-1] == "-"
    # down worker: the whole row is dashes
    assert ft.row_for("w2", None) == jft.row_for("w2", None)
    assert ft.row_for("w2", None)[-1] == "-"
    for name, text in (("w0", armed), ("w1", empty)):
        assert ft.row_for(name, parse_exposition(text)) == \
            jft.row_for(name, jax_parse(text))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_fleet_top_once_over_two_port_workers(capsys):
    from gameoflifewithactors_torch.serve.service import SessionService

    serving = MetricsRegistry()
    svc = SessionService(registry=serving, device="cpu")
    sids = [svc.create(tenant, {"rule": "B3/S23", "height": 32,
                                "width": 64}, fill=0.35, rng_seed=i)["sid"]
            for i, tenant in enumerate(("acme", "acme", "initech"))]
    for sid in sids:
        svc.step(sid, 4)
    serving.counter("kernel_builds", "c").inc(2, kind="hit")
    with MetricsServer(0, registry=serving, host="127.0.0.1") as w0, \
            MetricsServer(0, registry=_profiled_registry(),
                          host="127.0.0.1") as w1:
        targets = [f"127.0.0.1:{w0.port}", f"w1=127.0.0.1:{w1.port}"]
        assert ft.main(["--once", "--serve", "0"] + targets) == 0
        out = capsys.readouterr().out.splitlines()
        assert out[0].startswith("fleet_top: aggregate endpoint on")
        header, rows = out[1].split(), [r.split() for r in out[2:]]
        assert header == list(ft.COLUMNS)
        w0_row, w1_row = rows
        assert w0_row[:2] == ["w0", "up"]
        # 3 sessions of 2 tenants in one 8-slot lane, 2 kernel loads
        assert w0_row[2:6] == ["1", "3/8", "3", "2"]
        assert w0_row[header.index("RETRACE")] == "2"
        assert w0_row[-2:] == ["-", "-"]
        assert w1_row[:2] == ["w1", "up"] and w1_row[-2:] == ["2.0%", "1.3%"]
        # a target that does not answer: its row is 'down', exit code 1
        dead = f"dead=127.0.0.1:{_free_port()}"
        assert ft.main(["--once"] + targets + [dead]) == 1
        rows = capsys.readouterr().out.splitlines()[1:]
        assert rows[0].split()[:2] == ["dead", "down"]
