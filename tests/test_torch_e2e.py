"""Port end to end on the CPU: the JAX processor and the port's processor
run the same seeded Zipf frames file (about 20k flows, windows and DDoS
sub-windows closing mid-stream) and must write identical sqlite rows in
all seven tables, rank included: on the device-sorted fused step (native
decode, the prefetch feed; ``-processor.hostassist off`` on both, which
makes the JAX side a FusedPipeline on the CPU) and on the per-model path
(``-processor.fused=false`` on both). The port's fused and per-model
runs must agree too. Every sum stays below 2^24 and flows_5m is uint64,
so nothing is excused (tolerance: none). The host-grouped pipeline with
the spread detectors and the host sketch backend are held the same way
in tests/test_torch_e2e_hostpaths.py, which shares this file's stream
and helpers.

Also: the import boundary (a port processor run at defaults, one on the
device-sorted step and one on the host sketch backend, the pipeline entry
with the live query API, the serving tier and the guard armed, a
``gateway`` replica and a ``history`` tier mirroring that serving tier, a
-listen.feed processor and the collector writing frames, the in-process
mesh, the mesh over HTTP with the ``lineage`` entry, and the Kafka
route (mocker and processor over the tests' in-memory broker) with the
invertible twin load no JAX and nothing of the JAX package) and the
CLI's refusals.
"""

import os
import sqlite3
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from flow_pipeline_tpu import cli as jcli
from flow_pipeline_tpu_torch import cli as tcli
from flow_pipeline_tpu_torch.engine import FusedPipeline
from flow_pipeline_tpu_torch.engine.hostfused import HostGroupPipeline
from flow_pipeline_tpu_torch.hostsketch import HostSketchPipeline
import torch_cpu  # noqa: F401  (one torch thread; see the module)

REPO = Path(__file__).resolve().parents[1]
TABLES = ("flows_5m", "top_talkers", "top_src_ips", "top_dst_ips",
          "top_src_ports", "top_dst_ports", "ddos_alerts")
# the default set at narrow sizes; prefilter on (1024 > 2*128); no
# metrics server (xdist runs several processors at once, and the default
# address is a fixed port)
NARROW = ["-processor.batch", "1024", "-sketch.width", "4096",
          "-sketch.capacity", "128", "-metrics.addr", ""]
SHARED = ["-processor.fused=false", *NARROW]  # the per-model path


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    path = tmp_path_factory.mktemp("frames") / "frames.bin"
    # 20k flows at 40 flows/s span 500 s: two windows close mid-stream
    assert tcli.main(["mocker", "-out", str(path), "-produce.profile",
                      "zipf", "-produce.count", "20000", "-produce.rate",
                      "40", "-produce.seed", "3"]) == 0
    return path


def _rows(db, table):
    """Every row; ranked tables in rank order, the others sorted whole
    (flows_5m, the alerts and the spread journal carry no rank)."""
    conn = sqlite3.connect(db)
    try:
        if table in ("flows_5m", "ddos_alerts", "journal"):
            return sorted(conn.execute(f"SELECT * FROM {table}").fetchall())
        return conn.execute(
            f"SELECT * FROM {table} ORDER BY timeslot, rank").fetchall()
    finally:
        conn.close()


def test_port_processor_matches_reference(frames, tmp_path):
    jdb, tdb = tmp_path / "jax.db", tmp_path / "port.db"
    assert jcli.main(["processor", "-in", str(frames), "-sink",
                      f"sqlite:{jdb}", "-processor.backend", "cpu",
                      "-metrics.addr", "", *SHARED]) == 0
    worker = tcli.run_processor(["-device", "cpu", "-in", str(frames),
                                 "-sink", f"sqlite:{tdb}", *SHARED])
    assert worker.flows_seen == 20000
    late = [m.late_flows_dropped for name, m in worker.models.items()
            if name != "flows_5m"]
    assert all(n > 0 for n in late)  # two partitions: the reference drops too
    for table in TABLES:
        want = _rows(jdb, table)
        got = _rows(tdb, table)
        assert got == want, table
        if table != "ddos_alerts":
            assert len({r[0] for r in want}) >= 3  # three windows emitted
    assert _rows(jdb, "ddos_alerts")  # the detector fired mid-stream


def test_fused_processor_matches_reference(frames, tmp_path):
    """The port at CLI defaults (fused step, native decode, prefetch 2)
    against the JAX processor's FusedPipeline, and against the port's own
    per-model run."""
    jdb, tdb, pdb = (tmp_path / f"{n}.db" for n in ("jax", "port", "pm"))
    assert jcli.main(["processor", "-in", str(frames), "-sink",
                      f"sqlite:{jdb}", "-processor.backend", "cpu",
                      "-processor.hostassist", "off", "-metrics.addr", "",
                      *NARROW]) == 0
    worker = tcli.run_processor(["-device", "cpu", "-in", str(frames),
                                 "-sink", f"sqlite:{tdb}",
                                 "-processor.hostassist", "off", *NARROW])
    assert type(worker.fused) is FusedPipeline
    assert worker.flows_seen == 20000
    # every fused step is one CMS update of each of the three families
    assert worker.chunk_updates % 3 == 0
    assert worker.chunk_updates > 3 * worker.batches_seen
    # the per-model path, and no prefetch thread: the same rows
    per_model = tcli.run_processor(["-device", "cpu", "-in", str(frames),
                                    "-sink", f"sqlite:{pdb}", *SHARED,
                                    "-feed.prefetch", "0"])
    assert per_model.fused is None
    assert type(per_model.consumer).__name__ == "Consumer"
    for table in TABLES:
        want = _rows(jdb, table)
        assert _rows(tdb, table) == want, table
        assert _rows(pdb, table) == want, table
    assert _rows(jdb, "ddos_alerts")


def test_frames_match_reference_mocker(frames, tmp_path):
    """The same seed gives the same flows. The bytes equal the JAX
    package's native encoding, which its mocker prefers where its library
    is built (both omit all-zero addresses); against its pure-Python
    encoding, which writes them, the decoded columns are compared."""
    from flow_pipeline_tpu import native as jnative
    from flow_pipeline_tpu.gen import FlowGenerator, ZipfProfile
    from flow_pipeline_tpu.schema import wire as jwire
    from flow_pipeline_tpu.schema.batch import FlowBatch as JBatch
    from flow_pipeline_tpu_torch.schema.batch import FlowBatch as TBatch

    gen = FlowGenerator(ZipfProfile(), seed=3, rate=40.0)
    data = frames.read_bytes()
    batches = [gen.batch(n) for n in [4096] * 4 + [3616]]
    py_bytes = b"".join(jwire.encode_stream(b.to_messages())
                        for b in batches)
    jpath = tmp_path / "jax_frames.bin"
    assert jcli.main(["mocker", "-out", str(jpath), "-produce.profile",
                      "zipf", "-produce.count", "20000", "-produce.rate",
                      "40", "-produce.seed", "3"]) == 0
    jdata = jpath.read_bytes()
    if jnative.available():
        assert data == jdata == b"".join(jnative.encode_stream(b)
                                         for b in batches)
    got = TBatch.from_wire(data)
    assert len(got) == 20000
    for want in (JBatch.from_wire(jdata), JBatch.from_messages(
            jwire.decode_frames(py_bytes))):
        for name, col in want.columns.items():
            assert (got.columns[name] == col).all(), name


_BOUNDARY = r"""
import sys
from flow_pipeline_tpu_torch import cli, native
frames, db = sys.argv[1], sys.argv[2]
assert cli.main(["mocker", "-out", frames, "-produce.profile", "zipf",
                 "-zipf.spread", "0.05", "-produce.count", "3000",
                 "-produce.rate", "40"]) == 0
groups = []
hash_group = native.hash_group
def counted(lanes, threads=1):
    groups.append(len(lanes))
    return hash_group(lanes, threads)
native.hash_group = counted
args = ["-device", "cpu", "-in", frames, "-processor.batch", "512",
        "-sketch.width", "1024", "-sketch.capacity", "32", "-metrics.addr",
        "127.0.0.1:0"]
# at defaults on the CPU: the host-grouped pipeline, the pipelined ingest
# runtime, the native grouping; with the spread detectors
worker = cli.run_processor([*args, "-sink", "sqlite:" + db,
                            "-spread.enabled"])
from flow_pipeline_tpu_torch.engine import FusedPipeline, PrefetchConsumer
from flow_pipeline_tpu_torch.engine.hostfused import HostGroupPipeline
from flow_pipeline_tpu_torch.hostsketch import HostSketchPipeline
from flow_pipeline_tpu_torch.ingest import AsyncFlusher, PipelinedExecutor
from flow_pipeline_tpu_torch.sink import ResilientSink
assert isinstance(worker.fused, HostGroupPipeline)
assert isinstance(worker.executor, PipelinedExecutor)
assert worker.executor.prepared == worker.batches_seen > 0
assert isinstance(worker.flusher, AsyncFlusher) and worker.flusher.jobs_run
assert groups and worker.fused.applied_chunks > 0  # native grouping ran
assert isinstance(worker.consumer, PrefetchConsumer)
assert all(isinstance(s, ResilientSink) for s in worker.sinks)
assert native._lib is not None  # frames went through the native decoder
# the host wiring of the default run: metrics server, trace ring, fault
# plan, retried sinks
for mod in ("obs.server", "obs.trace", "utils.faults", "sink.resilient"):
    assert "flow_pipeline_tpu_torch." + mod in sys.modules, mod
# the device-sorted fused step
fused = cli.run_processor([*args, "-sink", "sqlite:" + db + ".fused",
                           "-processor.hostassist", "off"])
assert type(fused.fused) is FusedPipeline and fused.executor is None
# the host sketch backend: the fused native pass, the invertible family
from flow_pipeline_tpu_torch.hostsketch import HostSketchPipeline
host = cli.run_processor([*args, "-sink", "sqlite:" + db + ".host",
                          "-sketch.backend", "host", "-spread.enabled"])
assert type(host.fused) is HostSketchPipeline and host.fused._fused
assert host.models["top_src_ips"].config.hh_sketch == "invertible"
assert host.fused._spread_stats is not None  # the native spread fold
assert "flow_pipeline_tpu_torch.hostsketch.pipeline" in sys.modules
# the pipeline entry with the live query API, at defaults (the sketch
# audit on the CPU's host grouping)
# and the serving tier (its publisher, lock-free reader and feed)
import json, time, urllib.request
served = {}
def serve_start(worker, services):
    served["port"] = services["serve"].port
def fetch(port, path):
    with urllib.request.urlopen("http://127.0.0.1:%d%s" % (port, path),
                                timeout=30) as r:
        return r.read()
def mirrored(tier, server):
    # a gateway replica or a history tier on the pipeline's serving tier:
    # once it holds the upstream's version, its bodies are the upstream's
    version = json.loads(fetch(served["port"], "/query/version"))["version"]
    deadline = time.monotonic() + 120
    while server.store.current is None or \
            server.store.current.version != version:
        assert time.monotonic() < deadline, type(tier).__name__
        time.sleep(0.02)
    served[type(tier).__name__] = fetch(server.port, "/query/topk?k=3")
def serve_finish(worker, metrics):
    for path in ("/query/topk?k=3", "/query/range", "/sub/snapshot?since=0"):
        served[path] = fetch(served["port"], path)
    upstream = "127.0.0.1:%d" % served["port"]
    assert cli.run_gateway(["-gateway.upstream", upstream, "-gateway.listen",
                            "127.0.0.1:0", "-gateway.poll", "0.02"],
                           on_start=mirrored) == 0
    assert cli.run_history(["-history.upstream", upstream, "-history.listen",
                            "127.0.0.1:0", "-history.poll", "0.02",
                            "-history.dir", db + ".history"],
                           on_start=mirrored) == 0
pipe = cli.run_pipeline([*args, "-sink", "sqlite:" + db + ".pipe",
                         "-produce.count", "3000", "-produce.rate", "40",
                         "-query.addr", "127.0.0.1:0",
                         "-serve.addr", "127.0.0.1:0",
                         # armed, with a budget no run here can exceed:
                         # every flow is produced before the run starts,
                         # so the lag grows with the run's length, which
                         # a loaded box can stretch past a minute
                         "-guard.lag", "3600"],
                        on_start=serve_start, on_finish=serve_finish)
assert pipe.flows_seen == 3000 and pipe.fused.audit is not None
assert pipe.guard.armed and pipe.guard.level == 0
for tier in ("SnapshotGateway", "ArchiveWriter"):
    assert served[tier] == served["/query/topk?k=3"], tier
assert pipe.serve.store.current.flows_seen == 3000
assert json.loads(served["/query/topk?k=3"])["model"] == "top_talkers"
assert json.loads(served["/query/range"])["rows"]  # every window closed
assert served["/sub/snapshot?since=0"].startswith(b"FGWD1")
for mod in ("serve.server", "serve.publisher", "gateway.feed", "mesh.codec",
            "guard.controller", "gateway.subscriber", "history.archive",
            "history.server"):
    assert "flow_pipeline_tpu_torch." + mod in sys.modules, mod
# a -listen.feed processor, fed the frames file over gRPC
import threading
import time
from flow_pipeline_tpu_torch.transport.feed import FeedClient
def on_start(worker, services):
    client = FeedClient("127.0.0.1:%d" % services["feed"].port)
    with open(frames, "rb") as f:
        assert client.publish_frames(f.read()) == 3000
    client.close()
    def stop():
        while worker.flows_seen < 3000:
            time.sleep(0.02)
        worker.request_stop()
    threading.Thread(target=stop, daemon=True).start()
feed = cli.run_processor(["-device", "cpu", "-listen.feed", "127.0.0.1:0",
                          "-sink", "sqlite:" + db + ".feed",
                          "-metrics.addr", ""], on_start=on_start)
assert feed.flows_seen == 3000
# the collector writing frames: one NetFlow v5 datagram of two records
import socket, struct
out = frames + ".collected"
def send(collector):
    dgram = struct.pack(">HHIIIIBBH", 5, 2, 3600000, 1700000000, 0, 1, 0,
                        0, 1) + b"".join(struct.pack(
        ">4s4s4sHHIIIIHHBBBBHHBBH", bytes([10, 0, 0, i]),
        bytes([10, 0, 1, i]), bytes(4), 1, 2, 10, 1000, 0, 0, 1234, 443,
        0, 0, 6, 0, 1, 2, 24, 24, 0) for i in (1, 2))
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.sendto(dgram, ("127.0.0.1", collector.ports["netflow"]))
    sock.close()
    while collector.m_udp_pkts.value() < 1:
        time.sleep(0.01)
    time.sleep(0.1)
assert cli.run_collector(["-out", out, "-listen.netflow", "127.0.0.1:0",
                          "-listen.sflow", "", "-metrics.addr", ""],
                         on_start=send) == 0
from flow_pipeline_tpu_torch.schema.batch import FlowBatch
with open(out, "rb") as f:
    assert len(FlowBatch.from_wire(f.read())) == 2
for mod in ("obs.audit", "engine.query_api", "transport.feed",
            "collector.udp", "collector.netflow"):
    assert "flow_pipeline_tpu_torch." + mod in sys.modules, mod
# the Kafka route over the tests' in-memory broker (patched into the
# port's adapters alone): mocker into it, then a processor fed from it,
# stopped by the drained broker's interrupt; and the invertible twin
import os
sys.path.insert(0, os.path.join(sys.argv[3], "tests"))
from torch_fake_kafka import Broker, installed
from flow_pipeline_tpu_torch.ops import invsketch
broker = Broker(partitions=2)
with installed(broker, modules=("flow_pipeline_tpu_torch.transport.kafka",)):
    assert cli.main(["mocker", "-proto.fixedlen", "-produce.count", "2000",
                     "-produce.rate", "40"]) == 0
    broker.interrupt_when_drained = True
    assert cli.main(["processor", "-device", "cpu", "-proto.fixedlen",
                     "-feed.prefetch", "0", "-processor.hostassist", "off",
                     "-processor.batch", "512", "-sketch.width", "1024",
                     "-metrics.addr", "", "-sink", "sqlite:" + db + ".kafka"]) == 0
assert broker.committed[("tpu-processor", "flows", 0)] == 1000
state = invsketch.inv_init(2, 2, 64, 4, device="cpu")
assert invsketch.inv_decode(*state)[0].shape == (0, 4)
for mod in ("transport.kafka", "ops.invsketch"):
    assert "flow_pipeline_tpu_torch." + mod in sys.modules, mod
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "flow_pipeline_tpu" or m.startswith("flow_pipeline_tpu."))
assert not bad, bad
print("BOUNDARY_OK")
"""


# the in-process mesh as a user starts it: `pipeline -mesh.workers 2`,
# with its merged serving tier
_MESH_BOUNDARY = r"""
import sys
from flow_pipeline_tpu_torch import cli
db = sys.argv[1]
assert cli.main(["pipeline", "-mesh.workers", "2", "-device", "cpu",
                 "-produce.count", "3000", "-produce.rate", "40",
                 "-processor.batch", "512", "-sketch.width", "1024",
                 "-sketch.capacity", "32", "-metrics.addr", "",
                 "-mesh.heartbeat", "3600", "-mesh.journal", db + ".wal",
                 "-serve.addr", "127.0.0.1:0", "-sink", "sqlite:" + db]) == 0
for mod in ("mesh.coordinator", "mesh.member", "mesh.merge", "mesh.runtime",
            "mesh.journal", "mesh.scope", "engine.hostfused",
            "serve.publisher", "serve.server"):
    assert "flow_pipeline_tpu_torch." + mod in sys.modules, mod
# device sharding: processor -processor.mesh 2, and the parallel package
import flow_pipeline_tpu_torch.parallel
frames = db + ".frames"
assert cli.main(["mocker", "-out", frames, "-produce.count", "2000",
                 "-produce.rate", "40"]) == 0
worker = cli.run_processor(["-device", "cpu", "-in", frames,
                            "-processor.mesh", "2", "-processor.batch",
                            "512", "-sketch.width", "1024",
                            "-sketch.capacity", "32", "-metrics.addr", "",
                            "-sink", "sqlite:" + db + ".sharded"])
assert worker.flows_seen == 2000 and worker.chunk_updates > 0
for mod in ("parallel.mesh", "parallel.sharded", "parallel.multihost",
            "utils.shards"):
    assert "flow_pipeline_tpu_torch." + mod in sys.modules, mod
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "flow_pipeline_tpu" or m.startswith("flow_pipeline_tpu."))
assert not bad, bad
print("MESH_BOUNDARY_OK")
"""


# the mesh over HTTP: the coordinator's service entry, one member in the
# same process speaking to it over localhost through a RemoteCoordinator
# and serving its state, then the lineage entry against the coordinator
_HTTP_BOUNDARY = r"""
import sys
import torch
from flow_pipeline_tpu_torch import cli, mesh
from flow_pipeline_tpu_torch.gen import FlowGenerator, MockerProfile
from flow_pipeline_tpu_torch.transport import Consumer, InProcessBus
db = sys.argv[1]
flags = ["-device", "cpu", "-processor.batch", "512", "-sketch.width",
         "1024", "-sketch.capacity", "32", "-metrics.addr", "",
         "-mesh.heartbeat", "3600", "-bus.partitions", "1",
         "-loglevel", "warning"]
bus = InProcessBus()
bus.create_topic("flows", 1)
gen = FlowGenerator(MockerProfile(), seed=0, rate=40.0)
n = 0
while n < 3000:
    n += mesh.produce_sharded(bus, "flows", gen.batch(1000), 1)
vals = cli._parse_processor(flags)
def on_start(coord, services):
    base = "http://127.0.0.1:%d" % services["mesh"].port
    remote = mesh.RemoteCoordinator(base, timeout=60)
    member = mesh.MeshMember(
        "w0", remote,
        lambda parts: Consumer(bus, "flows", group="w0",
                               partitions=list(parts)),
        lambda: cli._build_models(vals, torch.device("cpu")),
        config=cli._worker_config(vals))
    state = mesh.MemberStateServer(member, 0).start()
    remote.state_url = state.url
    try:
        while coord.status()["covered"] != [n]:
            member.step()
        member.finalize()
    finally:
        state.stop()
    assert cli.main(["lineage", "-mesh.coordinator", base]) == 0
assert cli.run_coordinator([*flags, "-mesh.role", "coordinator",
                            "-mesh.listen", "127.0.0.1:0",
                            "-sink", "sqlite:" + db], on_start=on_start) == 0
for mod in ("mesh.server", "mesh.member", "mesh.coordinator", "mesh.codec",
            "engine.hostfused"):
    assert "flow_pipeline_tpu_torch." + mod in sys.modules, mod
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "flow_pipeline_tpu" or m.startswith("flow_pipeline_tpu."))
assert not bad, bad
print("HTTP_BOUNDARY_OK")
"""


def test_import_boundary(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _BOUNDARY, str(tmp_path / "f.bin"),
         str(tmp_path / "o.db"), str(REPO)], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BOUNDARY_OK" in proc.stdout
    mesh = subprocess.run(
        [sys.executable, "-c", _MESH_BOUNDARY, str(tmp_path / "m.db")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert mesh.returncode == 0, mesh.stderr[-3000:]
    assert "MESH_BOUNDARY_OK" in mesh.stdout
    http = subprocess.run(
        [sys.executable, "-c", _HTTP_BOUNDARY, str(tmp_path / "h.db")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert http.returncode == 0, http.stderr[-3000:]
    assert "HTTP_BOUNDARY_OK" in http.stdout
    assert " @ " in http.stdout  # the lineage entry's summary lines
    for db in ("o.db", "o.db.fused", "o.db.host", "o.db.pipe", "o.db.feed",
               "o.db.kafka", "m.db", "m.db.sharded", "h.db"):
        for table in TABLES[:-1]:  # the full model set ran (3000 flows at
            assert _rows(tmp_path / db, table), table  # 40 flows/s: no alert)
    assert _rows(tmp_path / "o.db", "journal")


@pytest.mark.parametrize("flag", ["-processor.fused=true",
                                  "-model.flows5m=true", "-model.ports=true",
                                  "-model.ddos=true"])
def test_processor_refuses_unported_parts(frames, flag):
    """The fused engine, its host-grouped form and the host sketch
    backend are ported: -processor.fused=true with
    -processor.hostassist=on runs the host-grouped pipeline (with the
    heavy-hitter families alone), and with -sketch.backend=host its host
    sketch form, the cascade families on the invertible sketch
    (-hh.sketch auto). The flows_5m, port and DDoS flags build their
    models (each alone beside nothing else)."""
    args = [a for a in SHARED if a.split("=")[0] != flag.split("=")[0]]
    if flag == "-processor.fused=true":
        hh_only = ["-model.flows5m=false", "-model.ports=false",
                   "-model.ddos=false"]
        for backend, pipeline in (("device", HostGroupPipeline),
                                  ("host", HostSketchPipeline)):
            worker = tcli.run_processor(["-device", "cpu", "-in",
                                         str(frames), *args, flag,
                                         "-processor.hostassist=on",
                                         "-sketch.backend", backend,
                                         *hh_only])
            assert type(worker.fused) is pipeline
            assert set(worker.models) == {"top_talkers", "top_src_ips",
                                          "top_dst_ips"}
            assert {n: m.config.hh_sketch for n, m in
                    worker.models.items()} == {
                "top_talkers": "table",
                "top_src_ips": "table" if backend == "device"
                else "invertible",
                "top_dst_ips": "table" if backend == "device"
                else "invertible"}
        return
    off = [f"-model.{m}=false" for m in ("flows5m", "talkers", "ips",
                                         "ports", "ddos")
           if f"-model.{m}=" not in flag]
    worker = tcli.run_processor(["-device", "cpu", "-in", str(frames),
                                 *args, *off, flag])
    want = {"-model.flows5m=true": {"flows_5m"},
            "-model.ports=true": {"top_src_ports", "top_dst_ports"},
            "-model.ddos=true": {"ddos_alerts"}}[flag]
    assert set(worker.models) == want


def test_processor_refuses_unknown_flag_and_invertible(frames):
    """An undeclared flag, a sketch family, backend or mode that does not
    exist, and -ingest.fused on without the host sketch backend are
    refused before any flow is read (exit code 2). -hh.sketch invertible
    itself is ported: on the per-model path it runs the numpy fold."""
    assert tcli.main(["processor", "-device", "cpu", "-in", str(frames),
                      "-sketch.cms", "pallas", *SHARED]) == 2
    for flags in (["-hh.sketch", "bloom"], ["-ingest.fused", "on"],
                  ["-sketch.backend", "tpu"], ["-ingest.fused", "always"],
                  ["-processor.hostassist", "always"]):
        assert tcli.main(["processor", "-device", "cpu", "-in", str(frames),
                          *flags, *SHARED]) == 2, flags
    worker = tcli.run_processor(["-device", "cpu", "-in", str(frames),
                                 "-hh.sketch", "invertible", *SHARED])
    assert worker.fused is None
    assert {m.model.config.hh_sketch for n, m in worker.models.items()
            if n in ("top_talkers", "top_src_ips", "top_dst_ips")} == \
        {"invertible"}


def test_processor_default_device_is_cuda(frames):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    for flags in ([], ["-processor.fused=true", "-processor.hostassist",
                       "on"]):
        with pytest.raises(RuntimeError, match="cuda"):
            tcli.run_processor(["-in", str(frames), *SHARED, *flags])
