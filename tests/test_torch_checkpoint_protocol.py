"""The port's checkpoint format and protocol against the JAX package's,
on the CPU, over the stream and helpers of tests/test_torch_checkpoint.py:
the port writes the reference's dtypes; kind and lane-count mismatches
skip loudly in both packages; a restore under ``-feed.prefetch 2`` (and
0) resumes at the covered offsets; the crash-point model checker passes
over the port's save, and catches each barrier dropped from it; under
``-flush.count 2`` the sequence of (partition, offset) commits on the bus
equals the reference's.
"""

import logging
import os

import numpy as np
import pytest
import torch

from flow_pipeline_tpu.engine import StreamWorker as JWorker
from flow_pipeline_tpu.engine import WindowedHeavyHitter as JWHH
from flow_pipeline_tpu.models import HeavyHitterConfig as JHHConfig
from flow_pipeline_tpu.models import WindowAggConfig as JWaggConfig
from flow_pipeline_tpu.models import WindowAggregator as JWagg
from flow_pipeline_tpu.transport.bus import InProcessBus as JBus
from flow_pipeline_tpu_torch.engine import PrefetchConsumer
from flow_pipeline_tpu_torch.engine import StreamWorker as TWorker
from flow_pipeline_tpu_torch.engine import WindowedHeavyHitter as TWHH
from flow_pipeline_tpu_torch.engine.checkpoint import (checkpoint_exists,
                                                       load_checkpoint)
from flow_pipeline_tpu_torch.models import HeavyHitterConfig as THHConfig
from flow_pipeline_tpu_torch.models import WindowAggConfig as TWaggConfig
from flow_pipeline_tpu_torch.models import WindowAggregator as TWagg
from flow_pipeline_tpu_torch.transport.bus import InProcessBus as TBus
from flow_pipeline_tpu_torch.utils import crashsim, fsutil
from test_torch_checkpoint import (_disarm, _first_half, _run,  # noqa: F401
                                   _stop, _worker, frames)
import torch_cpu  # noqa: F401  (one torch thread; see the module)


@pytest.fixture(scope="module")
def port_half(frames, tmp_path_factory):
    """The port's first half (CUT batches, a snapshot, a stop), run once:
    (checkpoint directory, the covered offsets). The tests only read the
    checkpoint."""
    tmp = tmp_path_factory.mktemp("half")
    first = _first_half("port", frames, tmp / "o.db", tmp / "ckpt")
    return tmp / "ckpt", dict(first._covered)


def test_checkpoint_stores_the_reference_dtypes(port_half):
    """The port writes host arrays in the reference's dtypes: u32 lanes
    (table keys, witness addresses) as uint32, not its int64 carriers."""
    snap = load_checkpoint(str(port_half[0]))
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
def test_mismatches_skip_loudly(port_half, caplog, pkg):
    ckpt = port_half[0]
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
def test_restore_resumes_at_covered_offsets(frames, port_half, tmp_path,
                                            prefetch):
    ckpt, covered = port_half
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
