"""Checkpoints shared by the port and the JAX package, on the CPU.

A seeded Zipf frames file (8,000 flows at 20 flows/s: a 5-minute window
and many DDoS sub-windows close mid-stream, and the two interleaved
partitions make the detector and the windowed tables drop late rows)
runs through one package's worker for 4 batches, which then snapshots
to ``-checkpoint.path`` and stops. The other package's processor
restores the checkpoint and runs the stream to its end into the same
sqlite file: all seven tables must equal an uninterrupted run's, row for
row (tolerance: none; every sum stays inside 2^24). The cut is after an
even number of polls, so the restarted consumer's partition rotation
(not part of a checkpoint, in either package) lines up with the
uninterrupted run's.

The same holds on the host sketch backend (-sketch.backend host, with the
fused native pass and with the staged engine), whose invertible families
checkpoint their exact uint64 planes.

Also: kind and lane-count mismatches skip loudly in both packages; a
restore under ``-feed.prefetch 2`` (and 0) resumes at the covered
offsets; the crash-point model checker passes over the port's save, and
catches each barrier dropped from it; under ``-flush.count 2`` the
sequence of (partition, offset) commits on the bus equals the
reference's.
"""

import logging
import os
import sqlite3

import numpy as np
import pytest
import torch

from flow_pipeline_tpu import cli as jcli
from flow_pipeline_tpu.engine import StreamWorker as JWorker
from flow_pipeline_tpu.engine import WindowedHeavyHitter as JWHH
from flow_pipeline_tpu.models import HeavyHitterConfig as JHHConfig
from flow_pipeline_tpu.models import WindowAggConfig as JWaggConfig
from flow_pipeline_tpu.models import WindowAggregator as JWagg
from flow_pipeline_tpu.transport import Consumer as JConsumer
from flow_pipeline_tpu.transport.bus import InProcessBus as JBus
from flow_pipeline_tpu.utils import faults as jfaults
from flow_pipeline_tpu_torch import cli as tcli
from flow_pipeline_tpu_torch.engine import PrefetchConsumer
from flow_pipeline_tpu_torch.engine import StreamWorker as TWorker
from flow_pipeline_tpu_torch.engine import WindowedHeavyHitter as TWHH
from flow_pipeline_tpu_torch.engine.checkpoint import (checkpoint_exists,
                                                       load_checkpoint)
from flow_pipeline_tpu_torch.models import HeavyHitterConfig as THHConfig
from flow_pipeline_tpu_torch.models import WindowAggConfig as TWaggConfig
from flow_pipeline_tpu_torch.models import WindowAggregator as TWagg
from flow_pipeline_tpu_torch.transport import Consumer as TConsumer
from flow_pipeline_tpu_torch.transport.bus import InProcessBus as TBus
from flow_pipeline_tpu_torch.utils import crashsim, fsutil
from flow_pipeline_tpu_torch.utils import faults as tfaults

TABLES = ("flows_5m", "top_talkers", "top_src_ips", "top_dst_ips",
          "top_src_ports", "top_dst_ports", "ddos_alerts")
NARROW = ["-processor.batch", "1024", "-sketch.width", "4096",
          "-sketch.capacity", "128", "-metrics.addr", "",
          "-loglevel", "warning"]
CUT = 4  # batches before the snapshot: even, see the module docstring


@pytest.fixture(autouse=True)
def _disarm():
    yield
    for plan in (jfaults.FAULTS, tfaults.FAULTS):
        plan.configure("")


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    path = tmp_path_factory.mktemp("frames") / "frames.bin"
    assert tcli.main(["mocker", "-out", str(path), "-produce.profile",
                      "zipf", "-produce.count", "8000", "-produce.rate",
                      "20", "-produce.seed", "9"]) == 0
    return path


def _rows(db):
    conn = sqlite3.connect(db)
    try:
        return {t: sorted(conn.execute(f"SELECT * FROM {t}").fetchall())
                for t in TABLES}
    finally:
        conn.close()


def _run(pkg, frames, db, *flags):
    if pkg == "port":
        return tcli.run_processor(["-device", "cpu", "-in", str(frames),
                                   "-sink", f"sqlite:{db}",
                                   "-processor.hostassist", "off", *NARROW,
                                   *flags])
    assert jcli.processor_main(
        ["-in", str(frames), "-sink", f"sqlite:{db}", "-processor.backend",
         "cpu", "-processor.hostassist", "off", *NARROW, *flags]) == 0
    return None


@pytest.fixture(scope="module")
def full_rows(frames, tmp_path_factory):
    """The uninterrupted run's rows (the reference's; the port's equal
    them)."""
    tmp = tmp_path_factory.mktemp("full")
    _run("jax", frames, tmp / "jax.db")
    _run("port", frames, tmp / "port.db")
    rows = _rows(tmp / "jax.db")
    assert _rows(tmp / "port.db") == rows
    assert all(rows[t] for t in TABLES)
    return rows


def _worker(pkg, frames, db, ckpt, *flags):
    """A worker of ``pkg`` built as its processor builds one, not yet
    run."""
    args = ["-in", str(frames), "-sink", f"sqlite:{db}", *NARROW,
            "-checkpoint.path", str(ckpt), *flags]
    if pkg == "port":
        vals = tcli._processor_flags(tcli._common_flags(
            tcli.FlagSet("processor"))).parse(args)
        bus = tcli._load_frames_bus(vals["in"], vals["kafka.topic"])
        return TWorker(TConsumer(bus, vals["kafka.topic"]),
                       tcli._build_models(vals, torch.device("cpu")),
                       tcli._make_sinks(vals["sink"]),
                       poll_max=vals["processor.batch"],
                       prefetch=vals["feed.prefetch"],
                       snapshot_every=vals["flush.count"],
                       checkpoint_path=vals["checkpoint.path"],
                       host_assist="off")
    vals = jcli._processor_flags(jcli._common_flags(
        jcli.FlagSet("processor"))).parse(
            [*args, "-processor.hostassist", "off"])
    bus = jcli._load_frames_bus(vals["in"], vals["kafka.topic"])
    return JWorker(JConsumer(bus, vals["kafka.topic"], fixedlen=True),
                   jcli._build_models(vals), jcli._vals_sinks(vals),
                   jcli._worker_config(vals))


def _stop(worker):
    stop = getattr(worker.consumer, "stop", None)
    if stop is not None:
        stop()


def _first_half(pkg, frames, db, ckpt, *flags):
    """CUT batches through ``pkg``'s worker, a snapshot, then a stop (a
    crash right after the snapshot)."""
    worker = _worker(pkg, frames, db, ckpt, *flags)
    try:
        for _ in range(CUT):
            assert worker.run_once()
        worker.snapshot_and_commit()
    finally:
        _stop(worker)
    return worker


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port"),
                                           ("port", "port")])
def test_checkpoint_restores_across_packages(frames, tmp_path, full_rows,
                                             writer, reader):
    db, ckpt = tmp_path / "out.db", tmp_path / "ckpt"
    _first_half(writer, frames, db, ckpt)
    assert checkpoint_exists(str(ckpt))
    half = _rows(db)
    assert any(half.values())  # the first half emitted rows already
    worker = _run(reader, frames, db, "-checkpoint.path", str(ckpt))
    if worker is not None:  # the port reports what it resumed from
        assert worker.batches_seen > CUT and worker.flows_seen == 8000
    assert _rows(db) == full_rows


HOST = ["-sketch.backend", "host", "-processor.hostassist", "on",
        "-ingest.mode", "serial"]


def _host_run(pkg, frames, db, fused, *flags):
    args = ["-in", str(frames), "-sink", f"sqlite:{db}", *NARROW, *HOST,
            "-ingest.fused", fused, *flags]
    if pkg == "port":
        return tcli.run_processor(["-device", "cpu", *args])
    assert jcli.processor_main([*args, "-processor.backend", "cpu"]) == 0
    return None


def _host_worker(pkg, frames, db, ckpt, fused):
    """A ``pkg`` worker on the host sketch backend, built as its
    processor builds one, not yet run."""
    args = ["-in", str(frames), "-sink", f"sqlite:{db}", *NARROW, *HOST,
            "-ingest.fused", fused, "-checkpoint.path", str(ckpt)]
    if pkg == "port":
        vals = tcli._processor_flags(tcli._common_flags(
            tcli.FlagSet("processor"))).parse(args)
        bus = tcli._load_frames_bus(vals["in"], vals["kafka.topic"])
        return TWorker(TConsumer(bus, vals["kafka.topic"]),
                       tcli._build_models(vals, torch.device("cpu")),
                       tcli._make_sinks(vals["sink"]),
                       poll_max=vals["processor.batch"],
                       prefetch=vals["feed.prefetch"],
                       snapshot_every=vals["flush.count"],
                       checkpoint_path=vals["checkpoint.path"],
                       **tcli._ingest_kwargs(vals))
    vals = jcli._processor_flags(jcli._common_flags(
        jcli.FlagSet("processor"))).parse([*args, "-processor.backend",
                                           "cpu"])
    bus = jcli._load_frames_bus(vals["in"], vals["kafka.topic"])
    return JWorker(JConsumer(bus, vals["kafka.topic"], fixedlen=True),
                   jcli._build_models(vals), jcli._vals_sinks(vals),
                   jcli._worker_config(vals))


@pytest.mark.parametrize("fused", ["auto", "off"])
@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_host_sketch_checkpoint_restores_across_packages(
        frames, tmp_path, writer, reader, fused):
    """On -sketch.backend host (the cascade families invertible under
    -hh.sketch auto): a checkpoint one package's worker writes after CUT
    polls (the engine's state synced into the models first) restores in
    the other package's processor, which finishes the stream with an
    uninterrupted run's rows in all seven tables. The invertible planes
    travel as exact uint64."""
    full = tmp_path / "full.db"
    _host_run("jax", frames, full, fused)
    full_rows = _rows(full)
    assert all(full_rows[t] for t in TABLES)
    db, ckpt = tmp_path / "out.db", tmp_path / "ckpt"
    worker = _host_worker(writer, frames, db, ckpt, fused)
    try:
        for _ in range(CUT):
            assert worker.run_once()
        worker.snapshot_and_commit()
    finally:
        _stop(worker)
    snap = load_checkpoint(str(ckpt))
    hh = {n: snap["models"][n]["hh"] for n in ("top_talkers", "top_src_ips")}
    assert "table_keys" in hh["top_talkers"]
    assert hh["top_src_ips"]["keysum"].dtype == np.uint64
    assert hh["top_src_ips"]["cms"].dtype == np.uint64
    assert hh["top_talkers"]["cms"].any()  # the synced engine state
    restored = _host_run(reader, frames, db, fused, "-checkpoint.path",
                         str(ckpt))
    if restored is not None:
        assert type(restored.fused).__name__ == "HostSketchPipeline"
        assert restored.batches_seen > CUT
    assert _rows(db) == full_rows


def test_checkpoint_stores_the_reference_dtypes(frames, tmp_path):
    """The port writes host arrays in the reference's dtypes: u32 lanes
    (table keys, witness addresses) as uint32, not its int64 carriers."""
    _first_half("port", frames, tmp_path / "o.db", tmp_path / "ckpt")
    snap = load_checkpoint(str(tmp_path / "ckpt"))
    models = snap["models"]
    assert models["top_talkers"]["kind"] == "windowed_hh"
    assert models["top_talkers"]["hh"]["table_keys"].dtype == np.uint32
    assert models["top_talkers"]["hh"]["cms"].dtype == np.float32
    assert models["ddos_alerts"]["state"]["addrs"].dtype == np.uint32
    assert models["ddos_alerts"]["state"]["seen"].dtype == np.bool_
    assert models["top_src_ports"]["totals"].dtype == np.int32
    store = next(iter(models["flows_5m"]["windows"].values()))
    key, acc = next(iter(store.items()))
    assert len(key) == 4 and acc.dtype == np.uint64
    assert sum(int(v) for v in snap["covered"].values()) == \
        snap["flows_seen"]


@pytest.fixture(scope="module")
def spread_frames(tmp_path_factory):
    path = tmp_path_factory.mktemp("frames") / "spread.bin"
    assert tcli.main(["mocker", "-out", str(path), "-produce.profile",
                      "zipf", "-zipf.spread", "0.05", "-produce.count",
                      "8000", "-produce.rate", "20", "-produce.seed",
                      "9"]) == 0
    return path


def _spread_rows(db):
    conn = sqlite3.connect(db)
    try:
        return {t: sorted(conn.execute(f"SELECT * FROM {t}").fetchall())
                for t in (*TABLES, "journal")}
    finally:
        conn.close()


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_spread_checkpoint_restores_across_packages(spread_frames, tmp_path,
                                                    writer, reader):
    """With -spread.enabled the checkpoint holds the superspreader and
    portscan windows in the reference's format (u8 registers, u32 keys,
    f32 metric); the other package resumes from it and the stream's rows,
    spread journal included, equal an uninterrupted run's."""
    full = tmp_path / "full.db"
    _run("jax", spread_frames, full, "-spread.enabled")
    _run("port", spread_frames, tmp_path / "full-port.db", "-spread.enabled")
    want = _spread_rows(full)
    assert _spread_rows(tmp_path / "full-port.db") == want
    assert want["journal"]
    db, ckpt = tmp_path / "out.db", tmp_path / "ckpt"
    _first_half(writer, spread_frames, db, ckpt, "-spread.enabled")
    snap = load_checkpoint(str(ckpt))
    for name in ("superspreaders", "portscan"):
        ms = snap["models"][name]
        assert ms["kind"] == "windowed_spread" and ms["current_slot"]
        sp = ms["spread"]
        assert sp["regs"].dtype == np.uint8 and sp["regs"].any()
        assert sp["table_keys"].dtype == np.uint32
        assert sp["table_metric"].dtype == np.float32
    _run(reader, spread_frames, db, "-checkpoint.path", str(ckpt),
         "-spread.enabled")
    assert _spread_rows(db) == want


def _mismatched_models(pkg):
    """flows_5m without the sampling-rate lane (3-lane keys, the
    checkpoint has 4), and a sketch-backed top_src_ports (the checkpoint
    holds dense totals)."""
    if pkg == "port":
        dev = torch.device("cpu")
        return {"flows_5m": TWagg(TWaggConfig(batch_size=1024,
                                              scale_col=None), device=dev),
                "top_src_ports": TWHH(THHConfig(key_cols=("src_port",),
                                                batch_size=1024,
                                                width=4096, capacity=128),
                                      device=dev)}
    return {"flows_5m": JWagg(JWaggConfig(batch_size=1024, scale_col=None)),
            "top_src_ports": JWHH(JHHConfig(key_cols=("src_port",),
                                            batch_size=1024, width=4096,
                                            capacity=128))}


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_mismatches_skip_loudly(frames, tmp_path, caplog, pkg):
    ckpt = tmp_path / "ckpt"
    _first_half("port", frames, tmp_path / "o.db", ckpt)
    models = _mismatched_models(pkg)
    cls = TWorker if pkg == "port" else JWorker
    worker = cls(None, models)
    handler_owner = logging.getLogger("flowtpu")  # does not propagate
    handler_owner.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.WARNING):
            assert worker.restore(str(ckpt))
    finally:
        handler_owner.removeHandler(caplog.handler)
    text = caplog.text
    assert "keys have 4 lanes" in text and "expects 3" in text
    assert "'windowed_dense' does not match model 'top_src_ports'" in text
    assert "unconfigured model" in text  # the other five
    wagg, hh = models["flows_5m"], models["top_src_ports"]
    assert wagg.windows == {} and wagg.watermark > 0
    assert hh.current_slot is None
    assert not np.asarray(hh.model.state.cms).any()


@pytest.mark.parametrize("prefetch", [2, 0])
def test_restore_resumes_at_covered_offsets(frames, tmp_path, prefetch):
    ckpt = tmp_path / "ckpt"
    first = _first_half("port", frames, tmp_path / "o.db", ckpt)
    covered = dict(first._covered)
    worker = _worker("port", frames, tmp_path / "o2.db", ckpt,
                     "-feed.prefetch", str(prefetch))
    assert isinstance(worker.consumer, PrefetchConsumer) == bool(prefetch)
    try:
        assert worker.restore()
        assert worker._covered == covered
        if prefetch:  # the feed thread starts at the first poll, not before
            assert worker.consumer._thread is None
        assert worker.consumer.positions == covered
        batch = worker.consumer.poll(1024)
        assert (batch.partition, batch.first_offset) == (0, covered[0])
    finally:
        _stop(worker)


def _plain(x):
    """A state tree as a loaded checkpoint gives it back: NamedTuples as
    field dicts."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {f: _plain(getattr(x, f)) for f in x._fields}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_equal, a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("barrier", [None, "fsync", "fsync_dir", "replace"])
def test_crash_points_over_the_port_save(frames, tmp_path, barrier):
    """Two snapshots of a live port worker under the op recorder; every
    crash state must restore (through StreamWorker.restore) the complete
    first or second snapshot, and the second once it was acked. With a
    barrier dropped from the protocol, the checker must find a state
    that breaks this."""
    root = tmp_path / "root"
    ckpt = root / "ckpt" / "snap"
    worker = _worker("port", frames, tmp_path / "o.db", ckpt,
                     "-model.ports=false", "-model.ddos=false")
    rec = fsutil.OpRecorder()
    wanted = []
    try:
        with fsutil.observed(rec):
            for label in ("s1", "s2"):
                # the snapshots after emits inside run_once write nothing:
                # the op log holds exactly the two saves
                worker.checkpoint_path = None
                for _ in range(2):
                    assert worker.run_once()
                worker.checkpoint_path = str(ckpt)
                if barrier is None:
                    worker.snapshot_and_commit()
                else:
                    with fsutil.suppressed(barrier):
                        worker.snapshot_and_commit()
                rec.mark(label)
                wanted.append(load_checkpoint(str(ckpt)))
    finally:
        _stop(worker)
    # the recovery target: a fresh worker's restore from the crash state
    fresh = _worker("port", frames, tmp_path / "f.db", ckpt,
                    "-model.ports=false", "-model.ddos=false",
                    "-feed.prefetch", "0")

    def check(croot, acked):
        path = os.path.join(croot, "ckpt", "snap")
        if not acked and not checkpoint_exists(path):
            return  # crashed before anything was published
        assert fresh.restore(path), "acked checkpoint missing"
        got = load_checkpoint(path)
        assert _equal(_plain(fresh._state()), got)
        if "s2" in acked:
            assert _equal(got, wanted[1]), "acked s2 did not restore"
        else:
            assert _equal(got, wanted[0]) or _equal(got, wanted[1]), \
                "restored a torn state"

    report = crashsim.explore(rec, str(root), check,
                              fail_fast=barrier is not None)
    if barrier is None:
        assert report.crash_points > 10 and report.states_explored > 10
        assert report.ok, report.render()
    else:
        assert not report.ok, report.render()


def test_commit_sequence_matches_reference(frames, tmp_path, monkeypatch):
    commits = {"port": [], "jax": []}
    for pkg, cls in (("port", TBus), ("jax", JBus)):
        orig = cls.commit

        def record(self, group, topic, partition, next_offset, _o=orig,
                   _log=commits[pkg]):
            _log.append((partition, next_offset))
            _o(self, group, topic, partition, next_offset)
        monkeypatch.setattr(cls, "commit", record)
    for pkg in ("port", "jax"):
        _run(pkg, frames, tmp_path / f"{pkg}.db", "-flush.count", "2")
    assert commits["port"] == commits["jax"]
    # every second batch commits, emits or not: more commit rounds than
    # the emitting batches alone would make
    emit_only = []
    monkeypatch.setattr(TBus, "commit", lambda self, g, t, p, o:
                        emit_only.append((p, o)))
    _run("port", frames, tmp_path / "e.db", "-flush.count", "0")
    assert len(commits["port"]) > len(emit_only)
    assert commits["port"][-2:] == emit_only[-2:] == [(0, 4000), (1, 4000)]
