"""Port parity: device sharding end to end, torch on the CPU against the
JAX package.

``processor -device cpu -processor.mesh 8 -processor.batch 128`` of both
packages on one seeded Zipf frames file (1,600 flows at 4 flows/s:
windows and DDoS sub-windows close mid-stream) writes the same rows in
all seven tables (tolerance: none; every sum stays below 2^24). A worker
checkpoint of a sharded run (every shard's state stacked on a leading
axis, the reference's layout) cut after CUT polls restores in the port
and in the JAX package to the uninterrupted run's rows. The sharded
models themselves are held in tests/test_torch_parallel.py.
"""

import sqlite3

import pytest
import torch

from flow_pipeline_tpu import cli as jcli
from flow_pipeline_tpu.engine import StreamWorker as JWorker
from flow_pipeline_tpu.transport import Consumer as JConsumer
from flow_pipeline_tpu_torch import cli as tcli
from flow_pipeline_tpu_torch import parallel as tpar
from flow_pipeline_tpu_torch.engine import StreamWorker as TWorker
from flow_pipeline_tpu_torch.transport import Consumer as TConsumer
import torch_cpu  # noqa: F401  (one torch thread; see the module)

TABLES = ("flows_5m", "top_talkers", "top_src_ips", "top_dst_ips",
          "top_src_ports", "top_dst_ports", "ddos_alerts")
MESH = ["-processor.batch", "128", "-processor.mesh", "8",
        "-sketch.width", "1024", "-sketch.capacity", "64",
        "-metrics.addr", "", "-loglevel", "warning"]
CUT = 4  # polls before the snapshot: even, as tests/test_torch_checkpoint.py


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    path = tmp_path_factory.mktemp("frames") / "frames.bin"
    # 1,600 flows at 4 flows/s span 400 s: windows close mid-stream
    assert tcli.main(["mocker", "-out", str(path), "-produce.profile",
                      "zipf", "-produce.count", "1600", "-produce.rate",
                      "4", "-produce.seed", "3"]) == 0
    return path


def _rows(db):
    conn = sqlite3.connect(db)
    try:
        return {t: sorted(conn.execute(f"SELECT * FROM {t}").fetchall())
                for t in TABLES}
    finally:
        conn.close()


def _jax_processor(frames, db, *flags):
    assert jcli.main(["processor", "-in", str(frames), "-sink",
                      f"sqlite:{db}", "-processor.backend", "cpu", *MESH,
                      *flags]) == 0


@pytest.fixture(scope="module")
def full_rows(frames, tmp_path_factory):
    """The JAX processor's rows at -processor.mesh 8."""
    db = tmp_path_factory.mktemp("full") / "jax.db"
    _jax_processor(frames, db)
    rows = _rows(db)
    assert all(rows[t] for t in TABLES[:-1])
    assert len({r[0] for r in rows["flows_5m"]}) >= 2  # a window closed
    return rows


def test_processor_mesh_matches_reference(frames, tmp_path, full_rows):
    worker = tcli.run_processor(["-device", "cpu", "-in", str(frames),
                                 "-sink", f"sqlite:{tmp_path / 'port.db'}",
                                 *MESH])
    assert worker.fused is None  # sharded models take the per-model path
    assert worker.flows_seen == 1600
    assert type(worker.models["flows_5m"]) is tpar.ShardedWindowAggregator
    assert type(worker.models["ddos_alerts"]) is tpar.ShardedDDoSDetector
    assert type(worker.models["top_talkers"].model) is \
        tpar.ShardedHeavyHitter
    assert type(worker.models["top_src_ports"].model) is \
        tpar.ShardedDenseTopK
    # one CMS update per shard per chunk of each heavy-hitter family
    assert worker.chunk_updates % (3 * 8) == 0 and worker.chunk_updates
    assert _rows(tmp_path / "port.db") == full_rows


def _port_worker(frames, db, ckpt):
    vals = tcli._parse_processor(["-in", str(frames), "-sink",
                                  f"sqlite:{db}", *MESH,
                                  "-checkpoint.path", str(ckpt)])
    bus = tcli._load_frames_bus(vals["in"], vals["kafka.topic"])
    return TWorker(TConsumer(bus, vals["kafka.topic"]),
                   tcli._build_models(vals, torch.device("cpu")),
                   tcli._make_sinks(vals["sink"]),
                   **tcli._worker_config(vals).kwargs())


def _jax_worker(frames, db, ckpt):
    vals = jcli._processor_flags(jcli._common_flags(
        jcli.FlagSet("processor"))).parse(
            ["-in", str(frames), "-sink", f"sqlite:{db}", *MESH,
             "-checkpoint.path", str(ckpt)])
    bus = jcli._load_frames_bus(vals["in"], vals["kafka.topic"])
    return JWorker(JConsumer(bus, vals["kafka.topic"], fixedlen=True),
                   jcli._build_models(vals), jcli._vals_sinks(vals),
                   jcli._worker_config(vals))


@pytest.mark.parametrize("writer,reader", [("port", "port"),
                                           ("port", "jax")])
def test_sharded_checkpoint_restores_to_unbroken_rows(frames, tmp_path,
                                                      full_rows, writer,
                                                      reader):
    """A sharded run cut after CUT polls (a snapshot of every shard's
    state, stacked as the reference stacks it), then a processor of
    either package restores it and finishes the stream into the same
    sqlite file: the rows of an unbroken run."""
    db, ckpt = tmp_path / "out.db", tmp_path / "ckpt"
    worker = (_port_worker if writer == "port" else _jax_worker)(
        frames, db, ckpt)
    try:
        for _ in range(CUT):
            assert worker.run_once()
        worker.snapshot_and_commit()
    finally:
        stop = getattr(worker.consumer, "stop", None)
        if stop is not None:
            stop()
    if reader == "port":
        resumed = tcli.run_processor(["-device", "cpu", "-in", str(frames),
                                      "-sink", f"sqlite:{db}", *MESH,
                                      "-checkpoint.path", str(ckpt)])
        assert resumed.batches_seen > CUT and resumed.flows_seen == 1600
    else:
        _jax_processor(frames, db, "-checkpoint.path", str(ckpt))
    assert _rows(db) == full_rows


