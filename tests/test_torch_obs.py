"""The port's observability against the JAX package's, on the CPU.

Each package runs its processor on the same seeded Zipf frames file
(6,000 flows at 40 flows/s: DDoS sub-windows close mid-stream and the
interleaved partitions make the detector drop late rows) in a fresh
process of its own, so each /metrics holds the families of one run and
nothing a test before it registered. The port's processor serves its own
/metrics on port 0 and the script scrapes it before the server stops;
the JAX processor's server stops with its run, so its script scrapes a
server on the same REGISTRY afterwards. Both carry the same family
names, the counters both update hold the same values (flows, batches,
insert_count, late_flows_dropped, the entropy gauges exactly, as the
DDoS tests hold them, and sink_write_*), and /debug/trace holds the
same span names with the same count of each.

Also: the port's exposition text is byte-equal to the reference's on a
scripted sequence of updates, and the default -metrics.addr parses to
127.0.0.1:8081.
"""

import json
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import pytest

from flow_pipeline_tpu.obs import metrics as jmetrics
from flow_pipeline_tpu_torch import cli as tcli
from flow_pipeline_tpu_torch.obs import metrics as tmetrics
import torch_cpu  # noqa: F401  (one torch thread; see the module)

REPO = Path(__file__).resolve().parents[1]
NARROW = ["-processor.batch", "1024", "-sketch.width", "4096",
          "-sketch.capacity", "128", "-metrics.addr", "127.0.0.1:0"]

_PORT_RUN = r"""
import json, sys, urllib.request
from flow_pipeline_tpu_torch import cli
frames, db, out, *flags = sys.argv[1:]
got = {}

def scrape(worker, server):
    base = "http://127.0.0.1:%d" % server.port
    for path in ("/metrics", "/debug/trace", "/healthz"):
        got[path] = urllib.request.urlopen(base + path).read().decode()
    got["late"] = {n: getattr(m, "late_flows_dropped", 0)
                   for n, m in worker.models.items()}
    got["entropy"] = [worker.models["ddos_alerts"].entropy,
                      worker.models["ddos_alerts"].entropy_baseline]

cli.run_processor(["-device", "cpu", "-in", frames, "-sink", "sqlite:" + db,
                   "-processor.hostassist", "off", "-loglevel", "warning",
                   *flags], on_finish=scrape)
json.dump(got, open(out, "w"))
"""

_JAX_RUN = r"""
import json, sys, urllib.request
from flow_pipeline_tpu import cli
from flow_pipeline_tpu.obs import MetricsServer
frames, db, out, *flags = sys.argv[1:]
assert cli.processor_main(["-in", frames, "-sink", "sqlite:" + db,
                           "-processor.backend", "cpu",
                           "-processor.hostassist", "off", "-loglevel",
                           "warning", *flags]) == 0
server = MetricsServer(0, host="127.0.0.1").start()
base = "http://127.0.0.1:%d" % server.port
got = {p: urllib.request.urlopen(base + p).read().decode()
       for p in ("/metrics", "/debug/trace", "/healthz")}
server.stop()
json.dump(got, open(out, "w"))
"""


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    path = tmp_path_factory.mktemp("frames") / "frames.bin"
    assert tcli.main(["mocker", "-out", str(path), "-produce.profile",
                      "zipf", "-produce.count", "6000", "-produce.rate",
                      "40", "-produce.seed", "5"]) == 0
    return path


@pytest.fixture(scope="module")
def scraped(frames, tmp_path_factory):
    """{package: scrape} after one processor run of each, both started at
    once in fresh processes."""
    tmp = tmp_path_factory.mktemp("scrape")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    procs = {}
    for pkg, script in (("port", _PORT_RUN), ("jax", _JAX_RUN)):
        procs[pkg] = subprocess.Popen(
            [sys.executable, "-c", script, str(frames),
             str(tmp / f"{pkg}.db"), str(tmp / f"{pkg}.json"), *NARROW],
            cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    out = {}
    for pkg, proc in procs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
        out[pkg] = json.loads((tmp / f"{pkg}.json").read_text())
    return out


def _families(text: str) -> set:
    return {line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE ")}


def _samples(text: str) -> dict:
    """{series (name + labels): float} of an exposition text."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            series, _, value = line.rpartition(" ")
            out[series] = float(value)
    return out


def test_metrics_carry_the_same_families(scraped):
    port = _families(scraped["port"]["/metrics"])
    ref = _families(scraped["jax"]["/metrics"])
    assert port == ref
    # the worker's, the sinks', the DDoS gauges and the zero families of
    # subsystems not ported
    assert {"flows_processed_total", "sink_write_retries_total",
            "flow_entropy", "flow_entropy_baseline",
            "host_fused_phase_ns_total", "native_path_degraded",
            "sketch_hh_recall", "flow_guard_level"} <= port
    assert json.loads(scraped["port"]["/healthz"]) == {"ok": True}


def test_shared_counters_are_equal(scraped):
    port = _samples(scraped["port"]["/metrics"])
    ref = _samples(scraped["jax"]["/metrics"])
    assert port["flows_processed_total"] == 6000
    shared = ["flows_processed_total", "batches_processed_total",
              "insert_count", "flow_entropy", "flow_entropy_baseline"]
    shared += [s for s in ref if s.startswith(("late_flows_dropped{",
                                               "sink_write_"))]
    for series in shared:
        assert port[series] == ref[series], series
    late = scraped["port"]["late"]
    assert late["ddos_alerts"] > 0  # the stream has late rows to count
    for name, n in late.items():
        if n:
            assert port[f'late_flows_dropped{{model="{name}"}}'] == n, name
    assert [port["flow_entropy"], port["flow_entropy_baseline"]] == \
        scraped["port"]["entropy"]


def test_trace_holds_the_same_spans(scraped):
    counts = {pkg: Counter(ev["name"] for ev in json.loads(
        got["/debug/trace"])["traceEvents"]) for pkg, got in scraped.items()}
    assert counts["port"] == counts["jax"]
    assert set(counts["port"]) == {"decode", "apply", "flush"}
    assert counts["port"]["decode"] == counts["port"]["apply"]
    port = _samples(scraped["port"]["/metrics"])
    assert counts["port"]["apply"] == port["batches_processed_total"]


def _script(registry):
    """A fixed sequence of updates over every metric kind and label
    form, the cardinality cap of a labeled summary included."""
    c = registry.counter("requests_total", "requests served")
    c.inc()
    c.inc(2.5, route="/a", code="200")
    c.inc(route="/b", code="500")
    g = registry.gauge("queue_depth", "items queued")
    g.set(7)
    g.set(3.25, stage="feed")
    g.set(1, stage="gone")
    g.remove(stage="gone")
    registry.gauge("never_set", "registered only")
    s = registry.summary("latency_us", "request latency", window=8,
                         max_label_sets=2)
    for i, v in enumerate([5.0, 1.0, 9.0, 3.0, 7.0, 2.0, 8.0, 4.0, 6.0,
                           10.0, 0.5]):
        s.observe(v)
        s.observe(v * 2, router=f"r{i % 4}")
    h = registry.histogram("size_bytes", "payload size",
                           buckets=(1.0, 10.0, 2.5, 100.0))
    for v in (0.5, 1.0, 3.0, 10.0, 50.0, 1000.0):
        h.observe(v)
        h.observe(v, table="t1")
    h.remove(table="none")
    return registry.render()


def test_exposition_is_byte_equal_to_reference():
    assert _script(tmetrics.MetricsRegistry()) == \
        _script(jmetrics.MetricsRegistry())


def test_default_metrics_addr_is_8081():
    vals = tcli._processor_flags(tcli._common_flags(
        tcli.FlagSet("processor"))).parse(["-in", "unused"])
    assert vals["metrics.addr"] == "127.0.0.1:8081"
    assert tcli._host_port(vals["metrics.addr"], 8081) == ("127.0.0.1",
                                                           8081)
    assert tcli._host_port(":0", 8081) == ("127.0.0.1", 0)
    assert vals["sink.retries"] == 4 and vals["flush.count"] == 50
    assert vals["obs.trace"] == "ring" and vals["faults"] == ""
