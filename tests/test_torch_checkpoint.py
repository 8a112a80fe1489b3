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

The same holds on the host sketch backend and with the spread detectors
(tests/test_torch_checkpoint_hostpaths.py); the checkpoint's format and
protocol are held in tests/test_torch_checkpoint_protocol.py. Both share
this file's stream and helpers.
"""

import sqlite3

import pytest
import torch

from flow_pipeline_tpu import cli as jcli
from flow_pipeline_tpu.engine import StreamWorker as JWorker
from flow_pipeline_tpu.transport import Consumer as JConsumer
from flow_pipeline_tpu.utils import faults as jfaults
from flow_pipeline_tpu_torch import cli as tcli
from flow_pipeline_tpu_torch.engine import StreamWorker as TWorker
from flow_pipeline_tpu_torch.engine.checkpoint import checkpoint_exists
from flow_pipeline_tpu_torch.transport import Consumer as TConsumer
from flow_pipeline_tpu_torch.utils import faults as tfaults
import torch_cpu  # noqa: F401  (one torch thread; see the module)

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
