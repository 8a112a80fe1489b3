"""The port's single-worker entry points against the JAX package's, on
the CPU (tolerance: none; every row below 2^24, flows_5m in uint64):

- ``pipeline``: the rows of all seven tables equal the JAX pipeline's on
  the same generator flags;
- the live query API: the JSON of ``/healthz``, ``/topk``, ``/windows``
  and ``/alerts`` equals the JAX QueryServer's over workers that read the
  same bus (equal states), and the port's errors answer 404 and 400;
- the gRPC feed: a round trip (the JAX client into the port's server
  too), and ``processor -listen.feed`` writes the ``-in`` run's rows;
- the collector: the port's sFlow and NetFlow v5/v9/IPFIX decoders give
  the reference's messages for the same datagrams, over UDP (port 0) as
  well, and ``collector -out`` writes frames the processor reads;
- ``inserter``: the ``flows`` rows equal the JAX inserter's;
- the ClickHouse sink sends the reference sink's HTTP requests, byte for
  byte, to a stdlib fake server, the ``-archive.raw`` run's flows_raw
  posts and schema check included; the Postgres statements are equal;
- ``replay`` re-ingests a dead-letter spill into the fault-free rows;
- the supervisor restarts a crashing worker.
"""

import dataclasses
import json
import socket
import sqlite3
import struct
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from flow_pipeline_tpu import cli as jcli
from flow_pipeline_tpu_torch import cli as tcli
import torch_cpu  # noqa: F401  (one torch thread; see the module)

TABLES = ("flows_5m", "top_talkers", "top_src_ips", "top_dst_ips",
          "top_src_ports", "top_dst_ports", "ddos_alerts")
NARROW = ["-processor.batch", "1024", "-sketch.width", "4096",
          "-sketch.capacity", "128", "-metrics.addr", ""]
GEN = ["-produce.profile", "zipf", "-produce.count", "4000",
       "-produce.rate", "8", "-produce.seed", "4"]
NOW = 1_700_000_000
# the DDoS detector's 10-s sub-windows split this slow stream into about
# a hundred device steps per run; tests whose subject is not the
# detector run without it
NO_DDOS = ["-model.ddos=false"]


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    path = tmp_path_factory.mktemp("entries") / "frames.bin"
    assert tcli.main(["mocker", "-out", str(path), *GEN]) == 0
    return path


def _rows(db, table, cols="*"):
    conn = sqlite3.connect(db)
    try:
        return sorted(conn.execute(f"SELECT {cols} FROM {table}")
                      .fetchall(), key=repr)
    finally:
        conn.close()


def _assert_tables_equal(got_db, want_db, tables=TABLES):
    for table in tables:
        want = _rows(want_db, table)
        if table != "ddos_alerts":
            assert want, table
        assert _rows(got_db, table) == want, table


# ---- pipeline -------------------------------------------------------------


@pytest.mark.parametrize("flags", [(), ("-bus.partitions", "3",
                                         *NO_DDOS)],
                         ids=["defaults", "three-partitions"])
def test_pipeline_matches_reference(tmp_path, flags):
    """At defaults on the CPU both run host grouping with the audit on."""
    jdb, tdb = tmp_path / "j.db", tmp_path / "t.db"
    assert jcli.main(["pipeline", "-processor.backend", "cpu", "-sink",
                      f"sqlite:{jdb}", *GEN, *NARROW, *flags]) == 0
    worker = tcli.run_pipeline(["-device", "cpu", "-sink", f"sqlite:{tdb}",
                                *GEN, *NARROW, *flags])
    assert worker.flows_seen == 4000
    assert worker.fused.audit is not None
    _assert_tables_equal(tdb, jdb, TABLES if not flags else TABLES[:-1])


def test_pipeline_refuses_bad_flags():
    assert tcli.main(["pipeline", "-device", "cpu", "-produce.count",
                      "0", *NARROW]) == 2
    # the mesh runs (tests/test_torch_mesh.py); its merged serving tier
    # is not ported, and a negative member count is no mesh
    assert tcli.main(["pipeline", "-device", "cpu", "-mesh.workers", "2",
                      "-serve.addr", "127.0.0.1:0", *NARROW]) == 2
    assert tcli.main(["pipeline", "-device", "cpu", "-mesh.workers", "-1",
                      *NARROW]) == 2


# ---- the live query API ---------------------------------------------------


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as resp:
        return json.loads(resp.read())


def _served_workers(frames):
    """A JAX and a port worker over the same frames, drained but not
    finalized: the open window stays live."""
    from flow_pipeline_tpu.engine import StreamWorker as JWorker
    from flow_pipeline_tpu.engine import WindowedHeavyHitter as JW
    from flow_pipeline_tpu.engine import WorkerConfig
    from flow_pipeline_tpu.models import DDoSConfig as JDC
    from flow_pipeline_tpu.models import DDoSDetector as JDD
    from flow_pipeline_tpu.models import HeavyHitterConfig as JHC
    from flow_pipeline_tpu.models import WindowAggConfig as JWC
    from flow_pipeline_tpu.models import WindowAggregator as JWA
    from flow_pipeline_tpu.sink import MemorySink as JSink
    from flow_pipeline_tpu.transport import Consumer as JConsumer
    from flow_pipeline_tpu.transport import InProcessBus as JBus
    from flow_pipeline_tpu.schema import wire as jwire
    from flow_pipeline_tpu_torch.engine import StreamWorker
    from flow_pipeline_tpu_torch.engine import WindowedHeavyHitter
    from flow_pipeline_tpu_torch.schema import wire as twire
    from flow_pipeline_tpu_torch.models import (DDoSConfig, DDoSDetector,
                                                HeavyHitterConfig,
                                                WindowAggConfig,
                                                WindowAggregator)
    from flow_pipeline_tpu_torch.sink import SQLiteSink
    from flow_pipeline_tpu_torch.transport import Consumer, InProcessBus

    data = frames.read_bytes()
    hh = dict(batch_size=512, width=1 << 12, capacity=64)
    jbus = JBus()
    jbus.create_topic("flows", 1)
    jbus.produce_many("flows", jwire.iter_raw_frames(data))
    jworker = JWorker(
        JConsumer(jbus, fixedlen=True),
        {"flows_5m": JWA(JWC(batch_size=512)),
         "top_talkers": JW(JHC(**hh), k=10),
         "ddos_alerts": JDD(JDC(batch_size=512, n_buckets=256))},
        [JSink()], WorkerConfig(snapshot_every=0, prefetch=0))
    tbus = InProcessBus()
    tbus.create_topic("flows", 1)
    tbus.produce_many("flows", twire.iter_raw_frames(data))
    tworker = StreamWorker(
        Consumer(tbus),
        {"flows_5m": WindowAggregator(WindowAggConfig(batch_size=512),
                                      device="cpu"),
         "top_talkers": WindowedHeavyHitter(HeavyHitterConfig(**hh), k=10,
                                            device="cpu"),
         "ddos_alerts": DDoSDetector(DDoSConfig(batch_size=512,
                                                n_buckets=256),
                                     device="cpu")},
        [SQLiteSink()], poll_max=8192, prefetch=0, snapshot_every=0)
    for w in (jworker, tworker):
        while w.run_once():
            pass
    return jworker, tworker


def test_query_api_matches_reference(frames):
    from flow_pipeline_tpu.engine.query_api import QueryServer as JQuery
    from flow_pipeline_tpu_torch.engine.query_api import QueryServer

    jworker, tworker = _served_workers(frames)
    assert type(tworker.fused).__name__ == type(jworker.fused).__name__
    jq = JQuery(jworker, port=0).start()
    tq = QueryServer(tworker, port=0).start()
    try:
        for path in ("/healthz", "/topk", "/topk?k=5",
                     "/topk?model=top_talkers&k=64", "/windows",
                     "/windows?model=flows_5m", "/alerts",
                     "/alerts?limit=3"):
            want = _get(jq.port, path)
            assert _get(tq.port, path) == want, path
        assert _get(tq.port, "/healthz")["flows_seen"] == 4000
        assert _get(tq.port, "/topk?k=5")["rows"]
        for path, code in (("/nope", 404), ("/topk?model=flows_5m", 400),
                           ("/topk?model=ghost", 400), ("/topk?k=abc", 400),
                           ("/alerts?limit=x", 400)):
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(tq.port, path)
            assert e.value.code == code, path
            assert "error" in json.loads(e.value.read())
    finally:
        jq.stop()
        tq.stop()


def test_processor_query_addr_serves_the_live_run(frames, tmp_path):
    """-query.addr on a processor: queried from the run's on_start hook
    (before the first poll) and from a thread while it runs."""
    answers = {}

    def on_start(worker, services):
        port = services["query"].port
        answers["healthz"] = _get(port, "/healthz")
        answers["topk"] = _get(port, "/topk?k=3")

    worker = tcli.run_processor(["-device", "cpu", "-in", str(frames),
                                 "-sink", f"sqlite:{tmp_path / 'q.db'}",
                                 "-query.addr", "127.0.0.1:0", *NARROW,
                                 *NO_DDOS],
                                on_start=on_start)
    assert answers["healthz"]["ok"] and answers["healthz"]["flows_seen"] == 0
    assert answers["topk"] == {"model": "top_talkers", "window_start": None,
                               "rows": []}
    assert worker.flows_seen == 4000


# ---- the gRPC feed --------------------------------------------------------


def test_feed_round_trip(frames):
    from flow_pipeline_tpu.transport import feed as jfeed
    from flow_pipeline_tpu_torch.schema.batch import FlowBatch
    from flow_pipeline_tpu_torch.transport import Consumer, InProcessBus
    from flow_pipeline_tpu_torch.transport import feed

    assert feed.available()
    bus = InProcessBus()
    server = feed.FeedServer(bus, address="127.0.0.1:0").start()
    clients = [feed.FeedClient(f"127.0.0.1:{server.port}"),
               jfeed.FeedClient(f"127.0.0.1:{server.port}")]
    try:
        batch = FlowBatch.from_wire(frames.read_bytes())
        half = len(batch) // 2
        assert clients[0].publish_batch(batch.slice(0, half)) == half
        assert clients[1].publish_frames(
            batch.slice(half, len(batch)).to_wire()) == len(batch) - half
        with pytest.raises(Exception) as e:
            clients[0].publish_frames(b"\xff\xff\xff garbage")
        assert "INVALID_ARGUMENT" in str(e.value.code())
    finally:
        for c in clients:
            c.close()
        server.stop()
    cons = Consumer(bus)
    got = []
    while (b := cons.poll(4096)) is not None:
        got.append(b)
    got = FlowBatch.concat(got)
    assert len(got) == len(batch)
    for name in ("bytes", "packets", "src_port", "time_received"):
        assert sorted(got.columns[name].tolist()) == \
            sorted(batch.columns[name].tolist()), name


def test_listen_feed_rows_equal_in_rows(frames, tmp_path):
    """Eight publishes land before the first poll, so the polls (and the
    window lifecycle) are the -in run's; the run stops on request once
    every flow is applied."""
    from flow_pipeline_tpu_torch.schema import wire
    from flow_pipeline_tpu_torch.transport.feed import FeedClient

    data = frames.read_bytes()
    raw = list(wire.iter_raw_frames(data))
    assert len(raw) == 4000

    def on_start(worker, services):
        client = FeedClient(f"127.0.0.1:{services['feed'].port}")
        try:
            for i in range(8):
                assert client.publish_frames(
                    b"".join(raw[i * 500:(i + 1) * 500])) == 500
        finally:
            client.close()

        def stop_when_done():
            deadline = time.monotonic() + 120
            while worker.flows_seen < len(raw) and \
                    time.monotonic() < deadline:
                time.sleep(0.05)
            worker.request_stop()

        threading.Thread(target=stop_when_done, daemon=True).start()

    fdb, idb = tmp_path / "feed.db", tmp_path / "in.db"
    worker = tcli.run_processor(["-device", "cpu", "-listen.feed",
                                 "127.0.0.1:0", "-sink", f"sqlite:{fdb}",
                                 *NARROW, *NO_DDOS], on_start=on_start)
    assert worker.flows_seen == 4000
    tcli.run_processor(["-device", "cpu", "-in", str(frames), "-sink",
                        f"sqlite:{idb}", *NARROW, *NO_DDOS])
    _assert_tables_equal(fdb, idb, TABLES[:-1])


# ---- the collector --------------------------------------------------------


def _v5(n=3, sampling=100):
    header = struct.pack(">HHIIIIBBH", 5, n, 3_600_000, NOW, 0, 42, 0, 0,
                         sampling)
    recs = b"".join(struct.pack(
        ">4s4s4sHHIIIIHHBBBBHHBBH", bytes([10, 0, 0, i + 1]),
        bytes([192, 168, 1, i + 1]), bytes(4), 1, 2, 10 + i, 1000 + i,
        3_590_000, 3_599_000, 1234 + i, 443, 0, 0x18, 6, 0, 65001, 65002,
        24, 24, 0) for i in range(n))
    return header + recs


def _v9(seq=1):
    fields = [(8, 4), (12, 4), (1, 4), (2, 4), (4, 1), (7, 2), (11, 2),
              (16, 2)]
    tmpl = struct.pack(">HH", 256, len(fields)) + b"".join(
        struct.pack(">HH", t, ln) for t, ln in fields)
    tmpl_set = struct.pack(">HH", 0, 4 + len(tmpl)) + tmpl
    recs = b"".join(bytes([10, 1, 1, i]) + bytes([10, 2, 2, i])
                    + struct.pack(">II", 5000 + i, 7) + bytes([17])
                    + struct.pack(">HHH", 53, 5353, 64512)
                    for i in range(1, 5))
    data_set = struct.pack(">HH", 256, 4 + len(recs)) + recs
    return struct.pack(">HHIIII", 9, 2, 1_000_000, NOW, seq, 1) + \
        tmpl_set + data_set


def _ipfix(seq=5):
    fields = [(8, 4), (12, 4), (1, 4), (2, 4), (4, 1), (150, 4), (151, 4)]
    tmpl = struct.pack(">HH", 300, len(fields)) + b"".join(
        struct.pack(">HH", t, ln) for t, ln in fields)
    tmpl_set = struct.pack(">HH", 2, 4 + len(tmpl)) + tmpl
    recs = b"".join(bytes([172, 16, 0, i]) + bytes([172, 16, 1, i])
                    + struct.pack(">II", 900 + i, 3) + bytes([6])
                    + struct.pack(">II", NOW - 10, NOW - 1)
                    for i in range(1, 4))
    data_set = struct.pack(">HH", 300, 4 + len(recs)) + recs
    total = 16 + len(tmpl_set) + len(data_set)
    return struct.pack(">HHIII", 10, total, NOW, seq, 5) + tmpl_set + \
        data_set


def _sflow(rate=512, n=2):
    eth = bytes(6) + bytes(6) + struct.pack(">H", 0x0800)
    samples = b""
    for i in range(n):
        ip = bytes([0x45, 0x10]) + struct.pack(">H", 100 + i) + bytes(4)
        ip += bytes([62, 6]) + bytes(2)
        ip += bytes([10, 9, 8, 7 + i]) + bytes([10, 6, 5, 4])
        tcp = struct.pack(">HH", 55555, 443) + bytes(9) + bytes([0x12]) + \
            bytes(2)
        pkt = eth + ip + tcp
        raw = struct.pack(">IIII", 1, 1500, 4, len(pkt)) + pkt
        rec = struct.pack(">II", 1, len(raw)) + raw
        body = struct.pack(">IIIIIIII", i + 1, 1, rate, 1000, 0, 5, 6, 1) \
            + rec
        samples += struct.pack(">II", 1, len(body)) + body
    header = struct.pack(">II", 5, 1) + bytes([192, 0, 2, 1])
    return header + struct.pack(">IIII", 0, 77, 123456, n) + samples


def _fields(msg, skip=()):
    return {k: v for k, v in dataclasses.asdict(msg).items()
            if k not in skip}


def test_collector_decode_matches_reference():
    from flow_pipeline_tpu.collector import TemplateCache as JCache
    from flow_pipeline_tpu.collector import decode_netflow as jnf
    from flow_pipeline_tpu.collector import decode_sflow as jsf
    from flow_pipeline_tpu_torch.collector import (TemplateCache,
                                                   decode_netflow,
                                                   decode_sflow)

    jc, tc = JCache(), TemplateCache()
    for data in (_v5(), _v9(), _ipfix(), _v5(7, sampling=0)):
        want = jnf(data, jc, "10.0.0.1:2055", now=NOW)
        got = decode_netflow(data, tc, "10.0.0.1:2055", now=NOW)
        assert want and [_fields(m) for m in got] == \
            [_fields(m) for m in want]
    assert len(tc) == len(jc) == 2
    want = jsf(_sflow())
    assert len(want) == 2
    assert [_fields(m) for m in decode_sflow(_sflow())] == \
        [_fields(m) for m in want]
    for bad in (b"\x00\x63bogus", _v9()[:30]):
        with pytest.raises((ValueError, struct.error)):
            decode_netflow(bad, TemplateCache(), "x:1", now=NOW)


def _send(ports, datagrams):
    """(kind, bytes) datagrams to the collector's bound ports."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        for kind, data in datagrams:
            sock.sendto(data, ("127.0.0.1", ports[kind]))
            time.sleep(0.005)  # keep the v9/IPFIX templates first
    finally:
        sock.close()


DATAGRAMS = [("netflow", _v9()), ("netflow", _ipfix()),
             ("sflow", _sflow()), ("netflow", _v5()),
             ("netflow", _v9(seq=2)), ("sflow", _sflow(rate=64, n=1))]


def test_collector_udp_round_trip_matches_reference():
    from flow_pipeline_tpu.collector import TemplateCache as JCache
    from flow_pipeline_tpu.collector import decode_netflow as jnf
    from flow_pipeline_tpu.collector import decode_sflow as jsf
    from flow_pipeline_tpu_torch.collector import (CollectorConfig,
                                                   CollectorServer)
    from flow_pipeline_tpu_torch.obs.metrics import MetricsRegistry
    from flow_pipeline_tpu_torch.transport import Consumer, InProcessBus
    from flow_pipeline_tpu_torch.transport import Producer

    jc = JCache()
    want = []
    for kind, data in DATAGRAMS:
        want += (jnf(data, jc, "127.0.0.1:1", now=NOW) if kind == "netflow"
                 else jsf(data))
    bus = InProcessBus()
    bus.create_topic("flows", 1)
    producer = Producer(bus, fixedlen=True)
    server = CollectorServer(producer, CollectorConfig(
        netflow_addr=("127.0.0.1", 0), sflow_addr=("127.0.0.1", 0)),
        registry=MetricsRegistry()).start()
    try:
        assert sorted(t.name for t in server._threads) == [
            "collector-netflow", "collector-sflow"]
        _send(server.ports, DATAGRAMS)
        deadline = time.monotonic() + 10
        while producer.produced < len(want) and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        server.stop()
    assert producer.produced == len(want) == 17
    from flow_pipeline_tpu_torch.schema import wire

    from flow_pipeline_tpu_torch.schema.message import FlowType

    got = wire.decode_frames(bus.fetch_span("flows", 0, 0, 100)[0])
    # the server stamps receive time (and v9 derives the flow times from
    # it); everything else is the decode's. Each listener keeps its own
    # socket's order; the two listener threads interleave as the
    # scheduler runs them, so each listener's records are held in order
    skip = ("time_received", "time_flow_start", "time_flow_end")
    for sflow in (False, True):
        assert [_fields(m, skip) for m in got
                if (m.type == FlowType.SFLOW_5) == sflow] == [
            _fields(m, skip) for m in want
            if (m.type == FlowType.SFLOW_5) == sflow]
    assert all(m.time_received >= NOW for m in got)


def test_collector_out_then_processor(tmp_path):
    """collector -out F on loopback, then processor -in F: flows_5m
    equals the oracle over the decoded frames (17 records)."""
    from flow_pipeline_tpu_torch.models.oracle import flows_5m
    from flow_pipeline_tpu_torch.schema.batch import FlowBatch

    out = tmp_path / "collected.bin"

    def on_start(collector):
        _send(collector.ports, DATAGRAMS)
        deadline = time.monotonic() + 10
        while collector.m_nf_records.value(router="127.0.0.1") < 14 and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.05)

    assert tcli.run_collector(["-out", str(out), "-listen.netflow",
                               "127.0.0.1:0", "-listen.sflow",
                               "127.0.0.1:0", "-metrics.addr", ""],
                              on_start=on_start) == 0
    batch = FlowBatch.from_wire(out.read_bytes())
    assert len(batch) == 17
    db = tmp_path / "c.db"
    tcli.run_processor(["-device", "cpu", "-in", str(out), "-sink",
                        f"sqlite:{db}", *NARROW])
    want = flows_5m(batch)
    got = _rows(db, "flows_5m")
    assert sum(r[6] for r in got) == 17
    assert len(got) == len(want["timeslot"])
    assert tcli.main(["collector", "-metrics.addr", ""]) == 2  # no Kafka


# ---- inserter and the sinks ----------------------------------------------


def test_inserter_matches_reference(frames, tmp_path):
    cols = ("time_flow, type, sampling_rate, src_as, dst_as, src_ip, "
            "dst_ip, bytes, packets, etype, proto, src_port, dst_port")
    jdb, tdb = tmp_path / "j.db", tmp_path / "t.db"
    assert jcli.main(["inserter", "-in", str(frames), "-sqlite",
                      str(jdb)]) == 0
    assert tcli.main(["inserter", "-in", str(frames), "-sqlite",
                      str(tdb)]) == 0
    conn = sqlite3.connect(tdb)
    got = conn.execute(f"SELECT {cols} FROM flows ORDER BY id").fetchall()
    conn.close()
    conn = sqlite3.connect(jdb)
    want = conn.execute(f"SELECT {cols} FROM flows ORDER BY id").fetchall()
    conn.close()
    assert len(got) == 4000 and got == want
    assert tcli.main(["inserter", "-sqlite", str(tdb)]) == 2  # no Kafka


class _FakeClickHouse:
    """A stdlib HTTP server recording every request (method, path, body).
    With ``raw_schema`` it answers the flows_raw column query as a
    server whose flows_raw has the IPv6 address columns."""

    RAW_SCHEMA = b"".join(
        json.dumps({"name": c, "type": "IPv6"}).encode() + b"\n"
        for c in ("SrcAddr", "DstAddr", "SamplerAddress"))

    def __init__(self, raw_schema=False):
        self.requests = []
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802
                n = int(self.headers.get("Content-Length", 0))
                outer.requests.append(("POST", self.path, self.rfile.read(n)))
                body = b""
                if raw_schema and "system.columns" in \
                        urllib.parse.unquote(self.path):
                    body = outer.RAW_SCHEMA
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                outer.requests.append(("GET", self.path, b""))
                body = b"Ok.\n"
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       name="fake-clickhouse", daemon=True)
        self.thread.start()

    def stop(self):
        self.server.shutdown()
        self.server.server_close()


def _sink_rows():
    rng = np.random.default_rng(3)
    n = 5
    flows = {"timeslot": np.full(n, 1_700_000_100, np.uint64),
             "src_as": rng.integers(0, 70000, n).astype(np.uint32),
             "dst_as": rng.integers(0, 70000, n).astype(np.uint32),
             "etype": np.full(n, 0x800, np.uint32),
             "bytes": rng.integers(0, 2**40, n).astype(np.uint64),
             "packets": rng.integers(0, 2**20, n).astype(np.uint64),
             "count": rng.integers(1, 99, n).astype(np.uint64),
             "bytes_scaled": rng.integers(0, 2**40, n).astype(np.uint64),
             "packets_scaled": rng.integers(0, 2**20, n).astype(np.uint64)}
    talkers = {"timeslot": np.full(3, 1_700_000_100, np.uint64),
               "src_addr": rng.integers(0, 2**32, (3, 4)).astype(np.uint32),
               "dst_addr": np.array([[0, 0, 0, 0x0A000001]] * 3, np.uint32),
               "src_port": np.arange(3, dtype=np.uint32),
               "dst_port": np.arange(3, dtype=np.uint32),
               "proto": np.full(3, 6, np.uint32),
               "bytes": np.array([9.0, 7.0, 5.0], np.float32),
               "packets": np.array([3.0, 2.0, 1.0], np.float32),
               "count": np.array([3.0, 2.0, 1.0], np.float32),
               "bytes_est": np.array([9.0, 8.0, 5.0], np.float32),
               "valid": np.array([True, True, False])}
    alerts = [{"sub_window": 1_700_000_010, "bucket": 7,
               "dst_addr": np.array([0, 0, 0, 0x0A000002], np.uint32),
               "rate": np.float32(1234.5), "zscore": 9.25,
               "baseline_quantile": 100.0}]
    return [("flows_5m", flows), ("top_talkers", talkers),
            ("ddos_alerts", alerts), ("superspreaders", [{"x": 1}])]


def test_clickhouse_sink_requests_match_reference():
    from flow_pipeline_tpu.sink import ClickHouseSink as JClickHouse
    from flow_pipeline_tpu_torch.sink import ClickHouseSink

    recorded = []
    for cls in (JClickHouse, ClickHouseSink):
        fake = _FakeClickHouse()
        try:
            sink = cls(fake.url)
            assert sink.ping()
            for table, rows in _sink_rows():
                sink.write(table, rows)
        finally:
            fake.stop()
        recorded.append(fake.requests)
    want, got = recorded
    assert len(want) > 12 and got == want


def test_archive_raw_requests_match_reference(frames):
    """-archive.raw on a ClickHouse sink (wrapped in the retried sink,
    which forwards the archive): the schema check at start, then every
    batch posted to flows_raw before its step, and the flows_5m rows;
    the HTTP requests equal the JAX processor's byte for byte, in order
    (the inline flush path)."""
    from flow_pipeline_tpu_torch.obs.metrics import REGISTRY

    archived = REGISTRY.counter("raw_rows_archived", "")
    before = archived.value()
    recorded = []
    for pkg in ("jax", "port"):
        fake = _FakeClickHouse(raw_schema=True)
        # flows_5m alone beside the archive: the raw rows are the subject
        args = ["-in", str(frames), "-sink", f"clickhouse:{fake.url}",
                "-archive.raw", "-processor.hostassist", "off", *NARROW,
                *NO_DDOS, "-model.talkers=false", "-model.ips=false",
                "-model.ports=false"]
        try:
            if pkg == "port":
                tcli.run_processor(["-device", "cpu", *args])
            else:
                assert jcli.processor_main([*args, "-processor.backend",
                                            "cpu"]) == 0
        finally:
            fake.stop()
        recorded.append(fake.requests)
    want, got = recorded
    assert got == want
    raw = [body for _, path, body in got
           if "INSERT INTO flows_raw" in urllib.parse.unquote(path)]
    assert sum(len(body.splitlines()) for body in raw) == 4000
    assert archived.value() - before == 4000
    assert any("system.columns" in urllib.parse.unquote(path)
               for _, path, _ in got)


def test_archive_raw_refuses_an_old_flows_raw():
    """A flows_raw without the IPv6 address columns stops the processor
    before its first poll, with the reference's remediation message."""
    from flow_pipeline_tpu.sink import ClickHouseSink as JClickHouse
    from flow_pipeline_tpu_torch.sink import ClickHouseSink

    errors = []
    for cls in (JClickHouse, ClickHouseSink):
        fake = _FakeClickHouse()
        try:
            with pytest.raises(RuntimeError) as e:
                cls(fake.url).check_raw_schema()
            errors.append(str(e.value))
        finally:
            fake.stop()
    assert errors[1] == errors[0] and "SamplerAddress" in errors[1]


def test_postgres_statements_match_reference():
    from flow_pipeline_tpu.sink import postgres as jpg
    from flow_pipeline_tpu_torch.sink import base, postgres

    assert postgres.DDL == jpg.DDL
    for table, rows in _sink_rows()[:3]:
        want = jpg.insert_sql(table, base.rows_to_records(rows))
        assert postgres.insert_sql(table, base.rows_to_records(rows)) == want
    assert not postgres.available()  # psycopg2 is not installed here
    assert tcli.main(["processor", "-device", "cpu", "-in", "x", "-sink",
                      "postgres:dbname=flows", *NARROW]) == 2


# ---- replay ----------------------------------------------------------------


def test_replay_reingests_deadletter(frames, tmp_path):
    """Every write fails (-faults sink.write:p=1), the batches spill, the
    run exits clean; replay drains the spill into the fault-free rows."""
    from flow_pipeline_tpu_torch.sink.resilient import deadletter_files
    from flow_pipeline_tpu_torch.utils.faults import FAULTS

    spill, db, clean = tmp_path / "dlq", tmp_path / "r.db", tmp_path / "c.db"
    try:
        worker = tcli.run_pipeline(["-device", "cpu", "-sink",
                                    f"sqlite:{db}", *GEN, *NARROW,
                                    *NO_DDOS, "-sink.retries", "2",
                                    "-sink.deadletter", str(spill),
                                    "-faults", "sink.write:p=1@seed=3"])
    finally:
        FAULTS.configure("")
    assert worker.flows_seen == 4000
    assert not _rows(db, "flows_5m")
    files = deadletter_files(str(spill))
    assert files
    assert tcli.main(["replay", "-replay.dir", str(spill), "-sink",
                      f"sqlite:{db}"]) == 0
    assert not deadletter_files(str(spill))
    tcli.run_pipeline(["-device", "cpu", "-sink", f"sqlite:{clean}", *GEN,
                       *NARROW, *NO_DDOS])
    _assert_tables_equal(db, clean, TABLES[:-1])
    assert tcli.main(["replay", "-sink", f"sqlite:{db}"]) == 2


# ---- the supervisor --------------------------------------------------------


def test_supervisor_restarts_until_success():
    from flow_pipeline_tpu_torch.engine import Supervisor, SupervisorConfig

    attempts = []

    class Flaky:
        def run(self):
            attempts.append(1)
            if len(attempts) < 3:
                raise RuntimeError("transient")

        def finalize(self):
            pass

    sleeps = []
    sup = Supervisor(Flaky, SupervisorConfig(backoff_initial=0.5),
                     sleep_fn=sleeps.append)
    sup.run()
    assert len(attempts) == 3 and sup.restarts == 2
    assert sleeps == [0.5, 1.0]

    class AlwaysCrashes(Flaky):
        def run(self):
            raise RuntimeError("permanent")

    sup = Supervisor(AlwaysCrashes, SupervisorConfig(max_restarts=2),
                     sleep_fn=lambda s: None)
    with pytest.raises(RuntimeError, match="permanent"):
        sup.run()
    assert sup.restarts == 3
