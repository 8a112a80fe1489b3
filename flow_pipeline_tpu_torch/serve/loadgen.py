"""Closed-loop query load generator for the serving tier.

Counterpart of flow_pipeline_tpu/serve/loadgen.py. N threads, each with
one keep-alive HTTP connection, issue queries back to back (closed loop:
the next request waits for the previous response, the honest client
model for "how many concurrent readers can this sustain"), and a sampler
reads the snapshot's age from ``/query/version``. chip_smoke.py drives
both against a live ``pipeline -serve.addr``. Stdlib only, so a reader
subprocess loads this file by path without importing the package.
"""

from __future__ import annotations

# Each load thread owns its private _Worker stats; aggregation reads them
# only after join(). Every request has a timeout: a load generator with
# an unbounded read would hang with the server under test.

import http.client
import threading
import time

DEFAULT_ENDPOINTS = (
    "/query/topk?k=10",
    "/query/version",
    "/query/topk?k=50",
    "/query/range",
)


class _Worker:
    """Per-thread private stats (plain class, not a dataclass: the
    reader subprocess spec-loads this file without a sys.modules entry,
    which the dataclass machinery requires)."""

    def __init__(self):
        self.latencies: list = []
        self.codes: dict = {}
        self.errors = 0


def _quantile(sorted_vals: list, q: float) -> float:
    if not sorted_vals:
        return 0.0
    return sorted_vals[min(len(sorted_vals) - 1,
                           int(q * len(sorted_vals)))]


def wait_ready(host: str, port: int, timeout: float = 30.0) -> bool:
    """Block until /query/version answers 200 (first snapshot
    published) — load measured before that would count bootstrap 503s
    against the serving path."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            conn = http.client.HTTPConnection(host, port, timeout=2)
            conn.request("GET", "/query/version")
            code = conn.getresponse().status
            conn.close()
            if code == 200:
                return True
        except OSError:
            pass
        time.sleep(0.05)
    return False


def sample_ages(host: str, port: int, stop: threading.Event,
                interval: float = 0.1) -> tuple[threading.Thread, list]:
    """Started snapshot-age sampler: polls /query/version every
    ``interval`` until ``stop`` and appends ``age_seconds`` to the
    returned list (the freshness evidence). join() the thread after
    setting ``stop``."""
    ages: list = []

    def drive() -> None:
        import json as _json
        import urllib.request as _rq

        while not stop.is_set():
            try:
                doc = _json.loads(_rq.urlopen(
                    f"http://{host}:{port}/query/version",
                    timeout=5).read())
                ages.append(doc["age_seconds"])
            except OSError:
                pass
            stop.wait(interval)

    t = threading.Thread(target=drive, name="serve-age-sampler",
                         daemon=True)
    t.start()
    return t, ages


def run_load(host: str, port: int, threads: int = 8,
             duration: float = 2.0,
             endpoints=DEFAULT_ENDPOINTS,
             stop: threading.Event | None = None) -> dict:
    """Closed-loop load for ``duration`` seconds (or until ``stop``).

    Returns {qps, p50_ms, p99_ms, requests, errors, codes, threads,
    duration_s}. ``errors`` counts transport failures; ``codes`` the
    HTTP status distribution (a 5xx in there fails chip_smoke.py)."""
    stop = stop or threading.Event()
    workers = [_Worker() for _ in range(threads)]
    t_end = time.monotonic() + duration

    def drive(w: _Worker, idx: int) -> None:
        conn = http.client.HTTPConnection(host, port, timeout=10)
        i = idx  # offset so threads don't hit one endpoint in lockstep
        while time.monotonic() < t_end and not stop.is_set():
            path = endpoints[i % len(endpoints)]
            i += 1
            t0 = time.perf_counter()
            try:
                conn.request("GET", path)
                resp = conn.getresponse()
                resp.read()  # drain: keep-alive needs the body consumed
                code = resp.status
            except OSError:
                w.errors += 1
                conn.close()
                conn = http.client.HTTPConnection(host, port, timeout=10)
                continue
            w.latencies.append(time.perf_counter() - t0)
            w.codes[code] = w.codes.get(code, 0) + 1
        conn.close()

    t0 = time.monotonic()
    ts = [threading.Thread(target=drive, args=(w, i), daemon=True)
          for i, w in enumerate(workers)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    wall = time.monotonic() - t0
    lats = sorted(x for w in workers for x in w.latencies)
    codes: dict[int, int] = {}
    for w in workers:
        for c, n in w.codes.items():
            codes[c] = codes.get(c, 0) + n
    n = len(lats)
    return {
        "qps": round(n / wall, 1) if wall else 0.0,
        "p50_ms": round(_quantile(lats, 0.5) * 1e3, 3),
        "p99_ms": round(_quantile(lats, 0.99) * 1e3, 3),
        "requests": n,
        "errors": sum(w.errors for w in workers),
        "codes": {str(c): n for c, n in sorted(codes.items())},
        "threads": threads,
        "duration_s": round(wall, 3),
    }


def merge_stats(parts: list[dict]) -> dict:
    """Aggregate per-process run_load summaries: qps sums (concurrent
    windows), latency quantiles take the worst process (conservative —
    exact pooling would need the raw samples)."""
    parts = [p for p in parts if p]
    if not parts:
        return {"qps": 0.0, "p50_ms": 0.0, "p99_ms": 0.0, "requests": 0,
                "errors": 0, "codes": {}, "threads": 0,
                "duration_s": 0.0}
    codes: dict[str, int] = {}
    for p in parts:
        for c, n in p["codes"].items():
            codes[c] = codes.get(c, 0) + n
    return {
        "qps": round(sum(p["qps"] for p in parts), 1),
        "p50_ms": max(p["p50_ms"] for p in parts),
        "p99_ms": max(p["p99_ms"] for p in parts),
        "requests": sum(p["requests"] for p in parts),
        "errors": sum(p["errors"] for p in parts),
        "codes": codes,
        "threads": sum(p["threads"] for p in parts),
        "duration_s": max(p["duration_s"] for p in parts),
    }


# Child bootstrap: spec-load THIS file directly so a reader process never
# imports the package (whose import chain pulls torch: seconds of CPU
# that would throttle the very serving path the reader measures).
_CHILD_BOOT = """
import importlib.util, json, sys
spec = importlib.util.spec_from_file_location("loadgen", sys.argv[1])
m = importlib.util.module_from_spec(spec)
sys.modules["loadgen"] = m
spec.loader.exec_module(m)
print(json.dumps(m.run_load(sys.argv[2], int(sys.argv[3]),
                            threads=int(sys.argv[4]),
                            duration=float(sys.argv[5]),
                            endpoints=tuple(sys.argv[6].split(",")))))
"""


def run_load_procs(host: str, port: int, procs: int = 2,
                   threads: int = 4, duration: float = 2.0,
                   endpoints=DEFAULT_ENDPOINTS) -> dict:
    """run_load fanned over ``procs`` reader SUBPROCESSES (x ``threads``
    connections each). In-process reader threads share the server's GIL
    — beyond a few, the measurement throttles ITSELF; separate
    interpreter processes are the honest client model for "N concurrent
    readers"."""
    import json as _json
    import subprocess
    import sys as _sys

    cmd = [_sys.executable, "-c", _CHILD_BOOT, __file__, host,
           str(port), str(threads), str(duration), ",".join(endpoints)]
    ps = [subprocess.Popen(cmd, stdout=subprocess.PIPE)
          for _ in range(procs)]
    parts = []
    for p in ps:
        out, _ = p.communicate(timeout=duration + 120)
        if p.returncode == 0 and out:
            parts.append(_json.loads(out))
    return merge_stats(parts)


def main(argv=None) -> int:
    """Subprocess entry: HOST PORT [THREADS] [DURATION] [ENDPOINTS] ->
    one JSON summary line on stdout."""
    import json as _json
    import sys as _sys

    args = list(argv if argv is not None else _sys.argv[1:])
    host, port = args[0], int(args[1])
    threads = int(args[2]) if len(args) > 2 else 8
    duration = float(args[3]) if len(args) > 3 else 2.0
    endpoints = tuple(args[4].split(",")) if len(args) > 4 \
        else DEFAULT_ENDPOINTS
    print(_json.dumps(run_load(host, port, threads=threads,
                               duration=duration, endpoints=endpoints)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
