"""The port's prefetch feed (engine/prefetch.py) against the reference's
PrefetchConsumer, both wrapping consumers of one in-memory bus: the same
batches in the same order, at most ``depth`` batches fetched ahead,
commits carried back to the feed thread that owns the consumer, errors
raised to the caller, and a clean stop. Every wait is bounded."""

import threading
import time

import numpy as np
import pytest

from flow_pipeline_tpu.engine.prefetch import PrefetchConsumer as JPrefetch
from flow_pipeline_tpu.schema import wire as jwire
from flow_pipeline_tpu.transport import Consumer as JConsumer
from flow_pipeline_tpu.transport import InProcessBus as JBus
from flow_pipeline_tpu_torch.engine import PrefetchConsumer, StreamWorker
from flow_pipeline_tpu_torch.engine import WindowedHeavyHitter
from flow_pipeline_tpu_torch.gen import FlowGenerator, ZipfProfile
from flow_pipeline_tpu_torch.models import HeavyHitterConfig
from flow_pipeline_tpu_torch.transport import Consumer, InProcessBus

N_FLOWS, POLL = 3000, 256


def _frames():
    return FlowGenerator(ZipfProfile(n_keys=200), seed=4,
                         rate=40.0).batch(N_FLOWS).to_wire()


def _drain(consumer, limit=1000):
    out = []
    for _ in range(limit):
        b = consumer.poll(POLL)
        if b is None:
            return out
        out.append(b)
    raise AssertionError("consumer never went idle")


def _signature(batches):
    return [(b.partition, b.first_offset, b.last_offset, len(b),
             int(b.columns["bytes"].sum())) for b in batches]


def test_order_matches_reference_on_one_bus():
    """Port and reference prefetchers (two consumer groups of one bus)
    and a bare consumer yield the same batches in the same order."""
    bus = JBus()
    bus.create_topic("flows", 2)
    bus.produce_many("flows", jwire.iter_raw_frames(_frames()))
    port = PrefetchConsumer(JConsumer(bus, group="port", fixedlen=True),
                            depth=2, poll_max=POLL)
    ref = JPrefetch(JConsumer(bus, group="ref", fixedlen=True), depth=2,
                    poll_max=POLL)
    bare = JConsumer(bus, group="bare", fixedlen=True)
    try:
        got, want = _drain(port), _drain(ref)
    finally:
        port.stop()
        ref.stop()
    assert _signature(got) == _signature(want) == _signature(_drain(bare))
    for g, w in zip(got, want):
        for name, col in w.columns.items():
            np.testing.assert_array_equal(g.columns[name], col)


class _CountingConsumer:
    """A consumer that counts polls and records the thread of each
    commit."""

    def __init__(self, n_batches=20):
        self.polls = 0
        self.n_batches = n_batches
        self.commits = []

    def poll(self, max_messages):
        if self.polls >= self.n_batches:
            return None
        self.polls += 1
        return _Batch(self.polls)

    def commit(self, partition, next_offset):
        self.commits.append((partition, next_offset,
                             threading.current_thread().name))


class _Batch:
    def __init__(self, i):
        self.i = i

    def __len__(self):
        return 1

    def nbytes(self):  # the reference's guard accounting reads it
        return 8


def _wait_for(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return pred()


@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("impl", ["port", "reference"])
def test_depth_bounds_fetch_ahead(impl, depth):
    inner = _CountingConsumer()
    cls = PrefetchConsumer if impl == "port" else JPrefetch
    pre = cls(inner, depth=depth, poll_max=POLL, idle_sleep=0.005)
    try:
        first = pre.poll(POLL)
        assert first.i == 1
        # the feed thread refills up to depth, and no further
        assert _wait_for(lambda: inner.polls == 1 + depth)
        time.sleep(0.05)
        assert inner.polls == 1 + depth
        assert [pre.poll(POLL).i for _ in range(3)] == [2, 3, 4]
        assert _wait_for(lambda: inner.polls == 4 + depth)
    finally:
        pre.stop()


@pytest.mark.parametrize("impl", ["port", "reference"])
def test_commits_run_on_the_feed_thread(impl):
    inner = _CountingConsumer()
    cls = PrefetchConsumer if impl == "port" else JPrefetch
    pre = cls(inner, depth=2, poll_max=POLL, idle_sleep=0.005)
    # before the first poll no thread owns the consumer: direct commit
    pre.commit(0, 1)
    assert inner.commits == [(0, 1, threading.current_thread().name)]
    try:
        pre.poll(POLL)
        pre.commit(1, 7)
        pre.commit(0, 9)
        pre.flush_commits(timeout=10)
        assert inner.commits[1:] == [(1, 7, "feed-prefetch"),
                                     (0, 9, "feed-prefetch")]
    finally:
        pre.stop()
    pre.commit(1, 8)  # stopped: direct again
    assert inner.commits[-1] == (1, 8, threading.current_thread().name)


@pytest.mark.parametrize("impl", ["port", "reference"])
def test_stop_and_idle(impl):
    inner = _CountingConsumer(n_batches=3)
    cls = PrefetchConsumer if impl == "port" else JPrefetch
    pre = cls(inner, depth=2, poll_max=POLL, idle_sleep=0.005)
    got = []
    while (b := pre.poll(POLL)) is not None:
        got.append(b.i)
    assert got == [1, 2, 3]
    thread = pre._thread
    pre.commit(0, 3)
    pre.stop(timeout=10)
    assert not thread.is_alive() and pre._thread is None
    assert inner.commits[-1][:2] == (0, 3)  # drained before the stop
    pre.stop()  # a second stop is a no-op


@pytest.mark.parametrize("impl", ["port", "reference"])
def test_poll_error_reaches_the_caller(impl):
    class Broken(_CountingConsumer):
        def poll(self, max_messages):
            raise OSError("broker gone")

    cls = PrefetchConsumer if impl == "port" else JPrefetch
    pre = cls(Broken(), depth=2, poll_max=POLL, idle_sleep=0.005)
    with pytest.raises(OSError, match="broker gone"):
        pre.poll(POLL)
    with pytest.raises(OSError, match="broker gone"):
        pre.poll(POLL)
    pre._thread.join(10)
    assert not pre._thread.is_alive()


def test_worker_commits_through_prefetch_and_stops_it():
    """A StreamWorker with the default prefetch wraps its consumer,
    commits every offset through the feed thread, and leaves no thread
    behind."""
    bus = InProcessBus()
    bus.create_topic("flows", 2)
    bus.produce_many("flows", jwire.iter_raw_frames(_frames()))
    model = WindowedHeavyHitter(HeavyHitterConfig(
        key_cols=("src_addr",), batch_size=POLL, width=1 << 10,
        capacity=64), k=10, device="cpu")
    worker = StreamWorker(Consumer(bus, "flows"), {"top_src_ips": model},
                          poll_max=POLL)
    assert isinstance(worker.consumer, PrefetchConsumer)
    worker.run()
    assert worker.flows_seen == N_FLOWS
    assert [bus.committed("tpu-processor", "flows", p) for p in (0, 1)] \
        == [N_FLOWS // 2, N_FLOWS // 2]
    assert worker.consumer._thread is None  # stopped and joined
