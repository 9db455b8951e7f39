"""The sessions cell's clients: a closed loop over HTTP, stdlib only.

Run as its own process, so that the clients' interpreter lock never
paces the server::

    python3 loadgen.py PLAN_JSON

``PLAN_JSON`` holds ``port``, ``clients`` (one list of session ids per
client), ``n`` (generations a request asks for), ``seconds``, ``seed`` and
``sample_share``. Each client cycles through its sessions: a request is
``POST /sessions/<sid>/step {"n": n}`` and then ``GET
/sessions/<sid>/grid``, and it is done when the frame is in hand. A
client sends no new request once ``seconds`` have passed since the start.

The process prints ``GO <start>`` when the clients start, then, as its
last line, one JSON object: the start, every request (client, index,
session, index within the session, send and receive times, whether it
succeeded), the errors, and the sampled frames. A request is sampled
where a draw from ``random.Random(f"{seed}:{client}")`` falls under
``sample_share``, and each client's first request always; a sample holds
the frame before it (None for a session's first request) and the frame
it returned. Times are ``time.perf_counter`` seconds, one clock with the
parent's.
"""

from __future__ import annotations

import http.client
import json
import random
import sys
import threading
import time


def _request(port: int, method: str, path: str, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        data = None if body is None else json.dumps(body).encode()
        headers = {} if data is None else {"Content-Type": "application/json"}
        conn.request(method, path, body=data, headers=headers)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def client(index: int, plan: dict, start: threading.Barrier, out: dict) -> None:
    port, n = plan["port"], plan["n"]
    sids = plan["clients"][index]
    rng = random.Random(f"{plan['seed']}:{index}")
    last = {}          # sid -> hex of the session's last frame
    done = {sid: 0 for sid in sids}
    broken = set()     # sessions whose count of steps is no longer known
    requests, samples, errors = [], [], []
    start.wait()
    t_start = out["t_start"]
    k = 0
    while time.perf_counter() - t_start < plan["seconds"]:
        sid = sids[k % len(sids)]
        draw = rng.random()
        t_a = time.perf_counter()
        ok, frame = False, None
        try:
            s1, b1 = _request(port, "POST", f"/sessions/{sid}/step", {"n": n})
            s2, b2 = _request(port, "GET", f"/sessions/{sid}/grid")
            ok = s1 == 200 and s2 == 200
            if ok:
                frame = json.loads(b2)
            else:
                errors.append(f"{sid}: step {s1} {b1[:200]!r}, grid {s2} "
                              f"{b2[:200]!r}")
        except (OSError, http.client.HTTPException, ValueError) as exc:
            errors.append(f"{sid}: {type(exc).__name__}: {exc}")
        t_b = time.perf_counter()
        requests.append([index, k, sid, done[sid], t_a, t_b, ok])
        if not ok:
            broken.add(sid)
        elif sid not in broken:
            if k == 0 or draw < plan["sample_share"]:
                samples.append({"sid": sid, "j": done[sid],
                                "before": last.get(sid),
                                "after": frame["cells_hex"],
                                "generation": frame["generation"]})
            last[sid] = frame["cells_hex"]
            done[sid] += 1
        k += 1
    out["requests"].extend(requests)
    out["samples"].extend(samples)
    out["errors"].extend(errors)


def main(argv=None) -> int:
    plan = json.loads((argv or sys.argv[1:])[0])
    count = len(plan["clients"])
    out = {"requests": [], "samples": [], "errors": []}
    barrier = threading.Barrier(count + 1)
    threads = [threading.Thread(target=client, args=(i, plan, barrier, out))
               for i in range(count)]
    for t in threads:
        t.start()
    out["t_start"] = time.perf_counter()
    print(f"GO {out['t_start']!r}", flush=True)
    barrier.wait()
    for t in threads:
        t.join()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
