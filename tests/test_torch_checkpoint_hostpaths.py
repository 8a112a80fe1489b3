"""Checkpoints shared by the port and the JAX package on the host sketch
backend and with the spread detectors, on the CPU.

The same cut as tests/test_torch_checkpoint.py (whose stream, helpers
and fixtures these tests share): one package's worker runs 4 batches,
snapshots to ``-checkpoint.path`` and stops; the other package's
processor restores the checkpoint and runs the stream to its end into
the same sqlite file, whose rows must equal an uninterrupted run's, row
for row (tolerance: none). On the host sketch backend (-sketch.backend
host, with the fused native pass and with the staged engine) the
invertible families checkpoint their exact uint64 planes; with
-spread.enabled the superspreader and portscan windows travel in the
reference's format.
"""

import sqlite3

import numpy as np
import pytest
import torch

from flow_pipeline_tpu import cli as jcli
from flow_pipeline_tpu.engine import StreamWorker as JWorker
from flow_pipeline_tpu.transport import Consumer as JConsumer
from flow_pipeline_tpu_torch import cli as tcli
from flow_pipeline_tpu_torch.engine import StreamWorker as TWorker
from flow_pipeline_tpu_torch.engine.checkpoint import load_checkpoint
from flow_pipeline_tpu_torch.transport import Consumer as TConsumer
from test_torch_checkpoint import (CUT, NARROW, TABLES, _disarm,  # noqa: F401
                                   _first_half, _rows, _run, _stop, frames)


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
