"""The sessions driver: tenants step their universes over HTTP.

Set-up starts a ``SessionService`` (the traffic's capacity ladder) behind
a ``SessionFrontend`` on port 0 in this process, makes one soup per
session from the seed on the card, and creates the sessions through
``POST /sessions`` with their packed words (``cells_hex``), ``tenants``
tenants of equal share. One warm-up request (a step of
``step_generations`` and the grid) on the first session launches the
lane kernel at the lane's shape; it is the start that the reference
checks from the soup. The clients then run in a child process
(:mod:`..loadgen`): a closed loop, client *i* cycling through tenant
*i*'s sessions, until ``--seconds`` have passed; the window runs from
their start to the last frame received. The card's peak memory is read
from the window's start. With ``--trace 1`` each profiled slice opens and
closes with the service's lock held and the card drained, so that no
launch is in flight at either end.

The reference steps the sampled requests: each from the frame before it
(the session's soup for its first request), compared with the frame it
returned, and the frame's generation against the count of steps.
"""

from __future__ import annotations

import contextlib
import gc
import http.client
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .. import check, hostspans, inputs
from ..reference import box_rule
from ..trace import TracedWindow

LOADGEN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "loadgen.py")


def _http(port: int, method: str, path: str, body=None) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        data = None if body is None else json.dumps(body).encode()
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        payload = resp.read()
    finally:
        conn.close()
    if resp.status not in (200, 201):
        raise RuntimeError(f"{method} {path}: HTTP {resp.status} "
                           f"{payload[:300]!r}")
    return json.loads(payload)


def _words(hexstr: str, h: int, wq: int, device) -> torch.Tensor:
    arr = np.frombuffer(bytes.fromhex(hexstr), dtype="<u4").reshape(h, wq)
    return torch.from_numpy(arr.view(np.int32).copy()).to(device)


@contextlib.contextmanager
def _quiet(service, dev):
    """No step being enqueued and none running: the service's lock held
    and the card drained."""
    with service._lock:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        yield


def run(spec) -> dict:
    from gameoflifewithactors_torch.obs import compile as obs_compile
    from gameoflifewithactors_torch.ops import cuda_stencil
    from gameoflifewithactors_torch.serve.frontend import SessionFrontend
    from gameoflifewithactors_torch.serve.service import SessionService

    traffic, config = spec.traffic, spec.config
    h, w = traffic["shape"]
    wq = w // box_rule.WORD
    n = int(traffic["step_generations"])
    count, tenants = int(traffic["sessions"]), int(traffic["tenants"])
    clients = int(traffic["clients"])
    per_tenant = count // tenants
    dev = spec.devices[0]
    log = hostspans.SpanLog().start()
    compile_mark = len(obs_compile.COMPILE_LOG.events())

    service = SessionService(ladder=tuple(traffic["ladder"]), device=dev)
    frontend = SessionFrontend(service, port=0).start()
    port = frontend.port
    sids = []
    with log.span("benchmark.create_sessions"):
        words = box_rule.pack_cells(
            inputs.soup((count, h, w), traffic["fill"], spec.seed, dev))
        host = words.cpu().numpy().astype("<i4")
        del words
        spec_body = {"rule": config["rule"], "height": h, "width": w,
                     "topology": config["topology"]}
        took = []
        for i in range(count):
            t_a = time.perf_counter()
            info = _http(port, "POST", "/sessions", {
                "tenant": f"tenant{i // per_tenant:02d}", "spec": spec_body,
                "cells_hex": host[i].tobytes().hex()})
            took.append((time.perf_counter() - t_a, i))
            if info["state"] == "pending":
                raise RuntimeError(f"session {i} was queued by admission")
            sids.append(info["sid"])
        del host
    spec.note("slowest session creations (s, index): "
              + ", ".join(f"{t:.3f} #{i}" for t, i in sorted(took)[-3:]))
    with log.span("benchmark.warmup_request"):
        _http(port, "POST", f"/sessions/{sids[0]}/step", {"n": n})
        warm = _http(port, "GET", f"/sessions/{sids[0]}/grid")
    traced = TracedWindow(spec.devices, log) if spec.trace else None
    if traced is not None:
        with log.span("benchmark.trace_warmup"):
            traced.warm()
    setup_events = [e.to_dict() for e in
                    obs_compile.COMPILE_LOG.events()[compile_mark:]]

    plan = {"port": port, "n": n, "seconds": spec.seconds, "seed": spec.seed,
            "sample_share": traffic["sample_share"],
            "clients": [sids[c * per_tenant:(c + 1) * per_tenant]
                        for c in range(clients)]}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    launches0 = cuda_stencil.launch_counts()
    proc = subprocess.Popen([sys.executable, LOADGEN, json.dumps(plan)],
                            stdout=subprocess.PIPE, text=True)
    try:
        go = proc.stdout.readline()
        if not go.startswith("GO "):
            raise RuntimeError(f"the clients did not start: {go!r}")
        t0 = float(go.split()[1])
        if traced is not None:
            time.sleep(max(0.0, t0 + traffic["trace_skip_seconds"]
                           - time.perf_counter()))
            while traced.wanted() and (
                    traced.attempts == 0 or time.perf_counter() - t0
                    + traffic["trace_seconds"] <= spec.seconds):
                with _quiet(service, dev):
                    traced.start(cuda_stencil.launch_counts())
                time.sleep(max(0.0, min(
                    traffic["trace_seconds"],
                    t0 + spec.seconds - time.perf_counter())))
                with _quiet(service, dev):
                    traced.stop(cuda_stencil.launch_counts())
                got = traced.reduce()
                if got is not None:
                    got["counters"]["dispatches"] = [
                        (r[4] or {}) for r in log.between(traced.t_start,
                                                          traced.t_stop)
                        if r[0] == "lane.dispatch"]
        out = json.loads(proc.stdout.read().strip().splitlines()[-1])
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
    if proc.returncode:
        raise RuntimeError(f"the clients exited with {proc.returncode}")
    launches1 = cuda_stencil.launch_counts()
    requests = out["requests"]
    done = [r for r in requests if r[6]]
    t1 = max(r[5] for r in requests)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    capacity = {s["lane"]: s["capacity"] for s in service.lane_stats()}
    window_spans = log.between(t0, t1)
    setup_spans = log.between(spec.t_process, t0)
    trace = traced.trace if traced is not None else None
    log.stop()
    frontend.stop()
    del service, frontend
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the reference: the warm-up request and every sampled request
    t_ref = time.perf_counter()
    reference = check.Reference(config)
    soups = reference.encode(
        inputs.soup((count, h, w), traffic["fill"], spec.seed, dev))
    index = {sid: i for i, sid in enumerate(sids)}
    warm_words = _words(warm["cells_hex"], h, wq, dev)
    base = {sid: 0 for sid in sids}
    base[sids[0]] = n

    def before(sample) -> torch.Tensor:
        if sample["before"] is not None:
            return _words(sample["before"], h, wq, dev)
        if sample["sid"] == sids[0]:
            return warm_words
        return soups[index[sample["sid"]]]

    samples = out["samples"]
    bad = check.compare_each(
        reference, [soups[0]] + [before(s) for s in samples],
        [warm_words] + [_words(s["after"], h, wq, dev) for s in samples], n)
    gen_bad = int(warm["generation"] != n) + sum(
        int(s["generation"] != base[s["sid"]] + n * (s["j"] + 1))
        for s in samples)
    del soups
    spec.note(f"checked the warm-up request and {len(samples)} sampled "
              f"requests of {len(done)} in {time.perf_counter() - t_ref:.3f} s")
    per_client = [sum(1 for r in done if r[0] == c) for c in range(clients)]
    spec.note(f"requests completed per client: {per_client}")
    for e in out["errors"][:5]:
        spec.note(f"request failed: {e}")
    checks = {"frame_mismatched_cells": (sum(bad), check.LIMIT),
              "frame_generation_mismatches": (gen_bad, check.LIMIT),
              "failed_requests": (len(requests) - len(done), check.LIMIT)}

    return {
        "attempted": len(requests),
        "failed": len(requests) - len(done),
        "checks": checks,
        "memory_peak_bytes": peak,
        "trace": trace,
        "ctx": {
            "driver": "sessions",
            "setup_s": t0 - spec.t_process,
            "setup_spans": hostspans.summary(setup_spans),
            "setup_compile_events": setup_events,
            "window": {"seconds": t1 - t0, "requests": len(done),
                       "generations_per_request": n, "cells": h * w,
                       "latencies_s": [r[5] - r[4] for r in done],
                       "launches": {k: launches1[k] - launches0[k]
                                    for k in launches1},
                       "per_client": per_client},
            "spans": hostspans.summary(window_spans),
            "dispatches": [(r[4] or {}) for r in window_spans
                           if r[0] == "lane.dispatch"],
            "lane_capacity": capacity,
            "words": h * wq,
            "trace": trace,
        },
    }
