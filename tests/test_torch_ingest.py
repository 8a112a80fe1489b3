"""The port's ingest runtime (ingest/executor.py, ingest/flush.py) and the
worker's pipelined mode, on the CPU.

- PipelinedExecutor: batches come out in poll order; the prepared queue
  never holds more than ``depth`` batches (backpressure); a poll or
  prepare error is raised from ``next()``; ``stop()`` drops prepared
  batches; the thread is named ``ingest-group`` and exposes ``_stop``.
- AsyncFlusher: jobs run in submission order on ``ingest-flush``; the
  first failure is latched and raised as FlushError from the next
  submit or drain, and a worker whose flush failed commits nothing past
  the failed step.
- A processor's sink rows in pipelined mode equal the serial loop's and
  the reference's pipelined run's (tolerance: none).
"""

import sqlite3
import threading
import time

import numpy as np
import pytest

from flow_pipeline_tpu import cli as jcli
from flow_pipeline_tpu_torch import cli as tcli
from flow_pipeline_tpu_torch.engine import StreamWorker
from flow_pipeline_tpu_torch.engine.hostfused import HostGroupPipeline
from flow_pipeline_tpu_torch.ingest import (AsyncFlusher, FlushError,
                                            PipelinedExecutor)
from flow_pipeline_tpu_torch.schema import wire
from flow_pipeline_tpu_torch.transport import Consumer, InProcessBus
import torch_cpu  # noqa: F401  (one torch thread; see the module)

TABLES = ("flows_5m", "top_talkers", "top_src_ips", "top_dst_ips",
          "top_src_ports", "top_dst_ports", "ddos_alerts")
NARROW = ["-processor.batch", "1024", "-sketch.width", "4096",
          "-sketch.capacity", "128", "-metrics.addr", "",
          "-loglevel", "warning", "-spread.enabled"]


class _Batch(list):
    chunk_id = -1


class _Feed:
    """A consumer of numbered batches; ``fail_at`` raises on that poll."""

    def __init__(self, n, fail_at=None):
        self.items = [_Batch([i]) for i in range(n)]
        self.fail_at = fail_at
        self.polls = 0

    def poll(self, max_messages):
        self.polls += 1
        if self.fail_at is not None and self.polls == self.fail_at:
            raise OSError("broker gone")
        return self.items.pop(0) if self.items else None


def _drain(ex):
    out = []
    while True:
        item = ex.next()
        if item is None:
            return out
        out.append(item)


def test_executor_keeps_poll_order_under_jitter():
    rng = np.random.default_rng(0)
    delays = rng.random(40) * 0.004

    def prepare(batch):
        time.sleep(delays[batch[0]])
        return ("prep", batch[0])

    ex = PipelinedExecutor(_Feed(40), prepare, depth=3, idle_sleep=0.002)
    try:
        got = _drain(ex)
        assert ex._thread.name == "ingest-group"
        assert isinstance(ex._stop, threading.Event)
    finally:
        ex.stop()
    assert got == [("prep", i) for i in range(40)]
    assert ex.prepared == 40


def test_executor_backpressure_bounds_the_queue():
    """A slow consumer of prepared batches: the group thread stops at
    ``depth`` queued batches and waits."""
    prepared = []
    ex = PipelinedExecutor(_Feed(30), lambda b: prepared.append(b[0]) or b,
                           depth=2, idle_sleep=0.002)
    try:
        first = ex.next()
        time.sleep(0.1)  # the group thread runs ahead, then blocks
        # one taken, `depth` waiting in the queue
        assert len(prepared) - 1 <= 2 + 1
        assert ex._out.qsize() <= 2 and ex.high_water <= 2
        rest = _drain(ex)
    finally:
        ex.stop()
    assert [first[0]] + [b[0] for b in rest] == list(range(30))


@pytest.mark.parametrize("where", ["poll", "prepare"])
def test_executor_raises_stage_errors(where):
    if where == "poll":
        ex = PipelinedExecutor(_Feed(10, fail_at=4), lambda b: b,
                               idle_sleep=0.002)
        err = OSError
    else:
        def prepare(b):
            if b[0] == 3:
                raise ValueError("poison batch")
            return b
        ex = PipelinedExecutor(_Feed(10), prepare, idle_sleep=0.002)
        err = ValueError
    got = []
    with pytest.raises(err):
        while True:
            got.append(ex.next()[0])
    assert got == [0, 1, 2]  # every batch before the bad one, in order
    ex.stop()
    assert ex._error is None and ex._out.qsize() == 0


def test_flusher_runs_jobs_in_order_and_latches_errors():
    fl = AsyncFlusher(max_queue=2)
    done = []
    for i in range(20):
        fl.submit(lambda i=i: (time.sleep(0.001), done.append(i)))
    fl.drain()
    assert done == list(range(20)) and fl.jobs_run == 20
    assert fl._thread.name == "ingest-flush"

    def boom():
        raise OSError("sink down")

    fl.submit(boom)
    fl.submit(lambda: done.append("after"))  # still runs, in order
    with pytest.raises(FlushError, match="sink down") as e:
        fl.drain()
    assert isinstance(e.value.__cause__, OSError)
    fl.drain()  # latched once: the error was raised
    assert done[-1] == "after"
    fl.submit(boom)
    time.sleep(0.05)
    with pytest.raises(FlushError):
        fl.submit(lambda: None)  # the next submit sees it
    fl.stop()
    assert fl._thread is None
    fl.stop()  # twice is safe


def _frames(tmp_path):
    path = tmp_path / "frames.bin"
    assert tcli.main(["mocker", "-out", str(path), "-produce.profile",
                      "zipf", "-zipf.spread", "0.05", "-produce.count",
                      "8000", "-produce.rate", "20", "-produce.seed",
                      "2"]) == 0
    return path


def _rows(db):
    conn = sqlite3.connect(db)
    try:
        return {t: sorted(conn.execute(f"SELECT * FROM {t}").fetchall())
                for t in (*TABLES, "journal")}
    finally:
        conn.close()


def test_pipelined_rows_equal_serial_and_reference(tmp_path):
    """The port's pipelined run (group thread, flusher, lazy window
    closes) writes the rows of its serial run and of the reference's
    pipelined run, all on the host-grouped pipeline."""
    frames = _frames(tmp_path)
    dbs = {k: tmp_path / f"{k}.db" for k in ("pipe", "serial", "jax")}
    pipe = tcli.run_processor(["-device", "cpu", "-in", str(frames), "-sink",
                               f"sqlite:{dbs['pipe']}", *NARROW])
    serial = tcli.run_processor(["-device", "cpu", "-in", str(frames),
                                 "-sink", f"sqlite:{dbs['serial']}",
                                 "-ingest.mode", "serial", *NARROW])
    assert jcli.main(["processor", "-in", str(frames), "-sink",
                      f"sqlite:{dbs['jax']}", "-processor.backend", "cpu",
                      *NARROW]) == 0
    assert pipe.executor is not None and pipe.flusher is not None
    assert pipe.flusher.jobs_run > 0
    assert serial.executor is None and serial.flusher is None
    assert all(isinstance(w.fused, HostGroupPipeline)
               for w in (pipe, serial))
    want = _rows(dbs["jax"])
    assert all(want[t] for t in (*TABLES[:-1], "journal"))
    assert _rows(dbs["pipe"]) == want
    assert _rows(dbs["serial"]) == want
    # the group, flush and feed threads are stopped and joined
    assert pipe.executor._thread is None and pipe.flusher._thread is None
    assert pipe.consumer._thread is None


def test_pipelined_needs_the_prefetch_wrap(tmp_path, caplog):
    """Without the prefetch wrap the worker logs why and runs the serial
    loop (only the feed thread may drive the bus client)."""
    bus = InProcessBus()
    bus.create_topic("flows", 2)
    bus.produce_many("flows", wire.iter_raw_frames(
        _frames(tmp_path).read_bytes()))
    vals = tcli._processor_flags(tcli._common_flags(
        tcli.FlagSet("processor"))).parse(["-in", "x", *NARROW])
    with caplog.at_level("INFO", logger="flow_pipeline_tpu_torch"):
        w = StreamWorker(Consumer(bus, "flows"),
                         tcli._build_models(vals, "cpu"), prefetch=0,
                         poll_max=1024)
    assert isinstance(w.fused, HostGroupPipeline) and w.executor is None
    assert "needs the prefetch wrap" in caplog.text


def test_flush_failure_fails_the_step_before_its_commit(tmp_path,
                                                       monkeypatch):
    """A sink that fails on the flusher thread: the worker's next submit
    or drain raises before the failed window's offsets are committed
    (nothing is committed: the first commit would follow the first
    emit)."""
    frames = _frames(tmp_path)
    commits = []
    orig = InProcessBus.commit

    def record(self, group, topic, partition, next_offset):
        commits.append((partition, next_offset))
        orig(self, group, topic, partition, next_offset)

    monkeypatch.setattr(InProcessBus, "commit", record)

    class Failing:
        writes = 0

        def write(self, table, rows):
            Failing.writes += 1
            raise OSError("sink down")

    workers = []
    orig_init = StreamWorker.__init__

    def keep(self, *a, **kw):
        orig_init(self, *a, **kw)
        workers.append(self)

    monkeypatch.setattr(StreamWorker, "__init__", keep)
    with pytest.raises(FlushError):
        tcli.run_processor(["-device", "cpu", "-in", str(frames), "-sink",
                            "", "-sink.retries", "1", *NARROW],
                           sinks=[Failing()])
    assert Failing.writes >= 1
    assert not commits
    # the unwind stopped the group and feed threads
    (w,) = workers
    assert w.executor._thread is None and w.consumer._thread is None
