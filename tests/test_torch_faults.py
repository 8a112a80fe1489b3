"""The port's fault plan, retries and dead-letter spill against the JAX
package's, on the CPU.

- ``parse_plan`` and the per-site draw sequences equal the reference's
  for several plans and seeds.
- Both processors run the same seeded frames file under the same
  ``-faults`` plan: under ``sink.write:p=0.3@seed=7`` (retried at the
  default ``-sink.retries 4``) and under the latency plan
  ``bus.poll:delay=0.01``, the sqlite tables equal the fault-free run's
  and the retry counters of both are identical. Under ``bus.poll:p=1``
  both fail with their package's ``FaultInjected``, an ``OSError``. A
  plan that exhausts the retries fails both runs the same way, with the
  same commits and none past the failed step.
- Dead-letter files the port writes replay in the reference, and the
  reference's replay in the port.

Each package keeps a process-global FAULTS and TRACER; the fixture
disarms both after every test, so no plan leaks into another test or
the other package.
"""

import sqlite3

import numpy as np
import pytest

from flow_pipeline_tpu import cli as jcli
from flow_pipeline_tpu.obs import REGISTRY as JREG
from flow_pipeline_tpu.obs.trace import TRACER as JTRACER
from flow_pipeline_tpu.sink import SQLiteSink as JSQLite
from flow_pipeline_tpu.sink.resilient import \
    replay_deadletter as jreplay
from flow_pipeline_tpu.transport.bus import InProcessBus as JBus
from flow_pipeline_tpu.utils import faults as jfaults
from flow_pipeline_tpu_torch import cli as tcli
from flow_pipeline_tpu_torch.obs import REGISTRY as TREG
from flow_pipeline_tpu_torch.obs.trace import TRACER as TTRACER
from flow_pipeline_tpu_torch.sink import SQLiteSink as TSQLite
from flow_pipeline_tpu_torch.sink.resilient import \
    replay_deadletter as treplay
from flow_pipeline_tpu_torch.transport.bus import InProcessBus as TBus
from flow_pipeline_tpu_torch.utils import faults as tfaults
import torch_cpu  # noqa: F401  (one torch thread; see the module)

TABLES = ("flows_5m", "top_talkers", "top_src_ips", "top_dst_ips",
          "top_src_ports", "top_dst_ports", "ddos_alerts")
NARROW = ["-processor.batch", "1024", "-sketch.width", "4096",
          "-sketch.capacity", "128", "-metrics.addr", "",
          "-loglevel", "warning"]
SINK_COUNTERS = ("sink_write_retries_total", "sink_write_failures_total",
                 "sink_deadletter_total")


@pytest.fixture(autouse=True)
def _disarm():
    yield
    for plan in (jfaults.FAULTS, tfaults.FAULTS):
        plan.configure("")
    for tracer in (JTRACER, TTRACER):
        tracer.configure("ring")


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    path = tmp_path_factory.mktemp("frames") / "frames.bin"
    # 6,000 flows at 40 flows/s: DDoS sub-windows close mid-stream, every
    # table gets rows at the end
    assert tcli.main(["mocker", "-out", str(path), "-produce.profile",
                      "zipf", "-produce.count", "6000", "-produce.rate",
                      "40", "-produce.seed", "5"]) == 0
    return path


def _rows(db):
    conn = sqlite3.connect(db)
    try:
        return {t: sorted(conn.execute(f"SELECT * FROM {t}").fetchall())
                for t in TABLES}
    finally:
        conn.close()


def _sink_counts(registry) -> dict:
    """{(family, table): value} of the sink counters, so a run's counts
    are a difference of two reads (the registries outlive a run)."""
    out = {}
    for fam in SINK_COUNTERS:
        metric = registry._metrics.get(fam)
        if metric is None:  # no resilient sink built in this process yet
            continue
        with metric._lock:
            for key, v in metric._values.items():
                out[(fam, dict(key).get("table"))] = v
    return out


def _delta(before, after) -> dict:
    return {k: v - before.get(k, 0.0) for k, v in after.items()
            if v - before.get(k, 0.0)}


def _run(pkg, frames, db, *flags):
    """One processor run of ``pkg``; returns its sink counter deltas."""
    reg = TREG if pkg == "port" else JREG
    before = _sink_counts(reg)
    if pkg == "port":
        tcli.run_processor(["-device", "cpu", "-in", str(frames), "-sink",
                            f"sqlite:{db}", "-processor.hostassist", "off",
                            *NARROW, *flags])
    else:
        assert jcli.processor_main(
            ["-in", str(frames), "-sink", f"sqlite:{db}",
             "-processor.backend", "cpu", "-processor.hostassist", "off",
             *NARROW, *flags]) == 0
    return _delta(before, _sink_counts(reg))


@pytest.fixture(scope="module")
def clean_rows(frames, tmp_path_factory):
    db = tmp_path_factory.mktemp("clean") / "port.db"
    assert not _run("port", frames, db)
    return _rows(db)


@pytest.mark.parametrize("spec", [
    "sink.write:p=0.3@seed=7",
    "sink.write:p=0.05;bus.poll:p=0.5:delay=0.1@seed=3",
    "bus.poll:delay=0.01",
    " sink.write : p=1 ; bus.produce:p=0 @seed=11",
])
def test_parse_plan_matches_reference(spec):
    assert tfaults.parse_plan(spec) == jfaults.parse_plan(spec)
    assert tfaults.parse_plan_full(spec) == jfaults.parse_plan_full(spec)


@pytest.mark.parametrize("spec", ["sink.write:p", "nosuch.site:p=0.1",
                                  "sink.write:p=1.5", "sink.write:q=1",
                                  "sink.write:p=0.1@salt=3"])
def test_bad_plans_fail_alike(spec):
    for mod in (tfaults, jfaults):
        with pytest.raises(ValueError):
            mod.parse_plan(spec)


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_draw_sequences_match_reference(seed):
    spec = (f"sink.write:p=0.3;bus.poll:p=0.5:delay=0.001;"
            f"bus.produce:p=0.05@seed={seed}")
    plans = []
    for mod in (tfaults, jfaults):
        plan = mod.FaultPlan()
        plan.configure(spec)
        plans.append(plan)
    rng = np.random.default_rng(seed)
    sites = ["sink.write", "bus.poll", "bus.produce", "mesh.sync"]
    # the same interleaving of sites in both: each site's stream is its own
    order = rng.integers(0, len(sites), 400)
    draws = [[p._roll(sites[i]) for i in order] for p in plans]
    assert draws[0] == draws[1]
    assert plans[0].snapshot() == plans[1].snapshot()
    assert any(hit for hit, _ in draws[0])


@pytest.mark.parametrize("plan,retried", [
    ("sink.write:p=0.3@seed=7", True),
    ("bus.poll:delay=0.01", False),
])
def test_fault_plan_rows_and_retries_match_reference(frames, tmp_path,
                                                     clean_rows, plan,
                                                     retried):
    counts = {pkg: _run(pkg, frames, tmp_path / f"{pkg}.db", "-faults",
                        plan) for pkg in ("port", "jax")}
    assert counts["port"] == counts["jax"]
    if retried:
        assert any(f == "sink_write_retries_total" for f, _ in
                   counts["port"])
    assert not any(f != "sink_write_retries_total"
                   for f, _ in counts["port"])
    for pkg in ("port", "jax"):
        assert _rows(tmp_path / f"{pkg}.db") == clean_rows, pkg


def test_poll_failure_fails_both_alike(frames, tmp_path):
    for pkg, mod in (("port", tfaults), ("jax", jfaults)):
        with pytest.raises(mod.FaultInjected) as err:
            _run(pkg, frames, tmp_path / f"{pkg}.db", "-faults",
                 "bus.poll:p=1")
        assert isinstance(err.value, OSError)


def test_exhausted_retries_fail_both_without_commits_past_the_step(
        frames, tmp_path, monkeypatch):
    commits = {"port": [], "jax": []}
    for pkg, cls in (("port", TBus), ("jax", JBus)):
        orig = cls.commit

        def record(self, group, topic, partition, next_offset, _o=orig,
                   _log=commits[pkg]):
            _log.append((partition, next_offset))
            _o(self, group, topic, partition, next_offset)
        monkeypatch.setattr(cls, "commit", record)
    counts, applied = {}, {}
    for pkg, mod, tracer in (("port", tfaults, TTRACER),
                             ("jax", jfaults, JTRACER)):
        reg = TREG if pkg == "port" else JREG
        before = _sink_counts(reg)
        with pytest.raises(mod.FaultInjected):
            _run(pkg, frames, tmp_path / f"{pkg}.db", "-faults",
                 "sink.write:p=1@seed=1", "-sink.retries", "2",
                 "-flush.count", "1")
        counts[pkg] = _delta(before, _sink_counts(reg))
        applied[pkg] = [ev[5]["rows"] for ev in tracer.snapshot()
                        if ev[0] == "apply"]
    assert counts["port"] == counts["jax"]
    assert sum(v for (f, _), v in counts["port"].items()
               if f == "sink_write_failures_total") == 1
    assert commits["port"] == commits["jax"]
    assert applied["port"] == applied["jax"]
    # -flush.count 1 commits after every batch: the last commit covers
    # every batch before the failed one (the last applied), and none of
    # the failed batch's rows
    committed = dict(commits["port"])
    assert sum(committed.values()) == sum(applied["port"][:-1])
    assert len(applied["port"]) > 1
    for pkg in ("port", "jax"):
        assert not any(_rows(tmp_path / f"{pkg}.db").values())


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_deadletter_replays_across_packages(frames, tmp_path, clean_rows,
                                            writer):
    """Every write of ``writer``'s run is dead-lettered; the other
    package replays the spill into a fresh sqlite sink, which then holds
    the fault-free rows."""
    dlq = tmp_path / "dlq"
    counts = _run(writer, frames, tmp_path / "spilled.db", "-faults",
                  "sink.write:p=1@seed=1", "-sink.retries", "1",
                  "-sink.deadletter", str(dlq))
    assert counts[("sink_write_failures_total", "flows_5m")] >= 1
    assert not any(_rows(tmp_path / "spilled.db").values())
    db = tmp_path / "replayed.db"
    if writer == "port":
        sink = JSQLite(str(db))
        n_files, _ = jreplay(str(dlq), [sink])
    else:
        sink = TSQLite(str(db))
        n_files, _ = treplay(str(dlq), [sink])
    sink.close()
    assert n_files == sum(v for (f, _), v in counts.items()
                          if f == "sink_deadletter_total")
    assert _rows(db) == clean_rows
