"""The port's Kafka transport (flow_pipeline_tpu_torch/transport/kafka.py)
and every entry's Kafka route against the JAX package's, on the CPU,
over one in-memory broker behind the kafka-python surface
(tests/torch_fake_kafka.py) installed for both packages at once.
Tolerance: none.

- The producers' bytes and partitions, per message, framed
  (``-proto.fixedlen``) and bare; the consumers' batches column for
  column with their partition and offsets, several partitions' records
  of one broker poll queued; commit, close and resume re-reading exactly
  the uncommitted records (kafka-python's two OffsetAndMetadata
  arities); the ``assign`` route's ``positions`` seek; both fault seams
  under one ``-faults`` plan.
- ``mocker`` without ``-out`` (``-produce.shard -bus.partitions 4``, and
  the client's partitioner with bare messages): the same messages on the
  same partitions.
- ``processor`` without ``-in``: the seven sqlite tables equal the JAX
  processor's (both ``-processor.hostassist off``, the poll on the
  entry's thread, which stops, as the reference's does, at the
  interrupt a drained broker raises), flows_5m equal to the oracle, and
  every offset committed; at the port's defaults as well.
- ``inserter`` from Kafka: the same ``flows`` rows; ``collector`` into
  Kafka: the same records.
- ``processor -mesh.role member``: the port's entry against the
  reference's, each against its own coordinator server over one
  assigned partition, merge the same rows; two port members built by
  ``cli.build_member`` over two assigned partitions merge flows_5m equal
  to the oracle.
- Without a client every Kafka route exits 2 in both packages; every
  ``flowtpu-*`` command line of deploy/compose/*.yml parses with the
  port's flags, and ``-processor.backend`` maps onto ``-device``.
"""

import json
import shlex
import sqlite3
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from flow_pipeline_tpu import cli as jcli
from flow_pipeline_tpu import mesh as jmesh
from flow_pipeline_tpu.obs import REGISTRY as JREGISTRY
from flow_pipeline_tpu.obs import TRACER as JTRACER
from flow_pipeline_tpu.transport import kafka as jkafka
from flow_pipeline_tpu.utils.faults import FAULTS as JFAULTS
from flow_pipeline_tpu_torch import cli as tcli
from flow_pipeline_tpu_torch import mesh as tmesh
from flow_pipeline_tpu_torch.models.oracle import flows_5m as oracle_5m
from flow_pipeline_tpu_torch.obs import REGISTRY as TREGISTRY
from flow_pipeline_tpu_torch.obs import TRACER as TTRACER
from flow_pipeline_tpu_torch.schema import wire as twire
from flow_pipeline_tpu_torch.schema.batch import FlowBatch
from flow_pipeline_tpu_torch.transport import kafka as tkafka
from flow_pipeline_tpu_torch.utils.faults import FAULTS as TFAULTS
from test_torch_entries import DATAGRAMS, NOW, _fields, _send
from torch_fake_kafka import Broker, installed
import torch_cpu  # noqa: F401  (one torch thread; see the module)

REPO = Path(__file__).resolve().parents[1]
TABLES = ("flows_5m", "top_talkers", "top_src_ips", "top_dst_ips",
          "top_src_ports", "top_dst_ports", "ddos_alerts")
GEN = ["-produce.profile", "zipf", "-produce.rate", "20",
       "-produce.seed", "5"]
NARROW = ["-processor.batch", "1024", "-sketch.width", "4096",
          "-sketch.capacity", "128", "-metrics.addr", ""]
# the poll on the entry's own thread: the drained broker's interrupt
# reaches the entry's loop
DRAIN = ["-feed.prefetch", "0", "-processor.hostassist", "off"]
MESH_FLAGS = ["-processor.batch", "512", "-sketch.width", "1024",
              "-sketch.capacity", "64", "-sketch.topk", "50",
              "-model.ddos=false", "-metrics.addr", ""]
FOREVER = 3600.0  # a heartbeat timeout and deadline no suite load reaches
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """Fresh metric registries in both packages; trace rings and fault
    plans back at their defaults afterwards."""
    monkeypatch.setattr(JREGISTRY, "_metrics", {})
    monkeypatch.setattr(TREGISTRY, "_metrics", {})
    yield
    for tracer in (JTRACER, TTRACER):
        tracer.configure("ring")
        tracer.paused = False
    for faults in (JFAULTS, TFAULTS):
        faults.configure("")


def _fill(broker, count, *flags):
    """The port's mocker into ``broker``; returns the flows sent."""
    with installed(broker):
        assert tcli.main(["mocker", "-produce.count", str(count), *GEN,
                          *flags]) == 0
    blobs = [m for part in broker.messages() for m in part]
    assert len(blobs) == count
    if "-proto.fixedlen" in flags:
        return FlowBatch.from_wire(b"".join(blobs))
    return FlowBatch.from_messages(twire.decode_message(b) for b in blobs)


def _rows(db, table, cols="*"):
    conn = sqlite3.connect(db)
    try:
        return sorted(conn.execute(f"SELECT {cols} FROM {table}")
                      .fetchall(), key=repr)
    finally:
        conn.close()


def _assert_oracle(db, flows):
    """flows_5m's rows, folded by key (late partials included), equal
    the exact rollup."""
    want = oracle_5m(flows)
    exact = {(int(want["timeslot"][i]), int(want["src_as"][i]),
              int(want["dst_as"][i]), int(want["etype"][i])):
             (int(want["bytes"][i]), int(want["packets"][i]),
              int(want["count"][i])) for i in range(len(want["count"]))}
    got = {}
    for ts, sa, da, et, b, p, c in _rows(
            db, "flows_5m", "timeslot, src_as, dst_as, etype, bytes, "
            "packets, count"):
        acc = got.setdefault((ts, sa, da, et), [0, 0, 0])
        for i, v in enumerate((b, p, c)):
            acc[i] += v
    assert {k: tuple(v) for k, v in got.items()} == exact


# ---- the adapters ----------------------------------------------------------


def _messages(n=40):
    from flow_pipeline_tpu_torch.gen import FlowGenerator, ZipfProfile

    gen = FlowGenerator(ZipfProfile(n_keys=50), seed=2, rate=100.0)
    return gen.batch(n).to_messages()


@pytest.mark.parametrize("fixedlen", [True, False],
                         ids=["fixedlen", "bare"])
def test_producers_send_the_same_bytes(fixedlen):
    from flow_pipeline_tpu.schema.message import FlowMessage as JMessage

    msgs = _messages()
    logs = {}
    for pkg, adapter in (("jax", jkafka), ("port", tkafka)):
        broker = Broker(partitions=3)
        with installed(broker):
            prod = adapter.KafkaProducerAdapter("b1:9092,b2:9092", "flows",
                                                fixedlen)
            for i, m in enumerate(msgs):
                if pkg == "jax":
                    m = JMessage(**{k: getattr(m, k)
                                    for k in m.__dataclass_fields__})
                prod.send(m, partition=2 if i % 5 == 0 else None)
            prod.flush()
        assert prod.produced == len(msgs) and broker.flushes == 1
        assert prod._producer.bootstrap_servers == ["b1:9092", "b2:9092"]
        logs[pkg] = broker.messages()
    assert logs["port"] == logs["jax"]
    enc = twire.encode_frame if fixedlen else twire.encode_message
    assert sorted(b for p in logs["port"] for b in p) == \
        sorted(enc(m) for m in msgs)
    assert len(logs["port"][2]) > len(msgs) // 5  # pinned and round-robin


def _drain(consumer):
    out = []
    while True:
        b = consumer.poll(7)
        if b is None:
            return out
        out.append(b)


def _batch_doc(batch):
    return (batch.partition, batch.first_offset, batch.last_offset,
            {k: np.asarray(v).tolist() for k, v in batch.columns.items()})


@pytest.mark.parametrize("fixedlen", [True, False],
                         ids=["fixedlen", "bare"])
def test_consumers_return_the_same_batches(fixedlen):
    broker = Broker(partitions=3)
    flows = _fill(broker, 50, *(["-proto.fixedlen"] if fixedlen else []))
    got = {}
    with installed(broker):
        for pkg, adapter in (("jax", jkafka), ("port", tkafka)):
            consumer = adapter.KafkaConsumerAdapter(
                "127.0.0.1:9092", "flows", group=f"g-{pkg}",
                fixedlen=fixedlen)
            queued = []
            orig = consumer._consumer.poll

            def poll(*a, _orig=orig, _q=queued, **k):
                out = _orig(*a, **k)
                _q.append(len(out))
                return out

            consumer._consumer.poll = poll
            got[pkg] = [_batch_doc(b) for b in _drain(consumer)]
            assert max(queued) > 1  # one broker poll, several partitions
    assert got["port"] == got["jax"]
    # every record once, in offset order per partition
    for p in range(3):
        spans = [(b[1], b[2]) for b in got["port"] if b[0] == p]
        assert spans[0][0] == 0 and all(
            a[1] + 1 == b[0] for a, b in zip(spans, spans[1:]))
    cols = {k: np.concatenate([np.asarray(b[3][k]) for b in got["port"]])
            for k in ("bytes", "src_port")}
    assert sorted(zip(cols["bytes"], cols["src_port"])) == sorted(
        zip(flows.columns["bytes"].tolist(),
            flows.columns["src_port"].tolist()))


@pytest.mark.parametrize("arity", [3, 2], ids=["omd3", "omd2"])
def test_commit_then_resume_rereads_the_uncommitted(arity):
    broker = Broker(partitions=2)
    _fill(broker, 40, "-proto.fixedlen")
    runs = {}
    with installed(broker, offset_arity=arity):
        for pkg, adapter in (("jax", jkafka), ("port", tkafka)):
            group = f"resume-{pkg}"
            first = adapter.KafkaConsumerAdapter("k:9092", "flows",
                                                 group=group, fixedlen=True)
            a = first.poll(6)
            b = first.poll(6)
            assert a.partition != b.partition or a.first_offset > 0
            first.commit(a.partition, a.last_offset + 1)
            first.close()
            assert first._consumer.closed
            again = adapter.KafkaConsumerAdapter("k:9092", "flows",
                                                 group=group, fixedlen=True)
            rest = _drain(again)
            runs[pkg] = [_batch_doc(x) for x in rest]
            # exactly the records past the commit: partition a from its
            # committed offset, every other partition from 0
            starts = {}
            for x in rest:
                starts.setdefault(x.partition, x.first_offset)
            assert starts[a.partition] == a.last_offset + 1
            assert all(v == 0 for p, v in starts.items() if p != a.partition)
            assert sum(len(x) for x in rest) == 40 - len(a)
            assert broker.committed[(group, "flows", a.partition)] == \
                a.last_offset + 1
    assert runs["port"] == runs["jax"]


def test_assign_and_positions_seek():
    broker = Broker(partitions=3)
    _fill(broker, 60, "-proto.fixedlen")
    got = {}
    with installed(broker):
        for pkg, adapter in (("jax", jkafka), ("port", tkafka)):
            c = adapter.KafkaConsumerAdapter("k:9092", "flows",
                                             group="mesh-w0", fixedlen=True,
                                             partitions=[2, 0])
            c.positions[2] = 5
            got[pkg] = [_batch_doc(b) for b in _drain(c)]
            assert {b[0] for b in got[pkg]} == {0, 2}
            assert min(b[1] for b in got[pkg] if b[0] == 2) == 5
            assert min(b[1] for b in got[pkg] if b[0] == 0) == 0
    assert got["port"] == got["jax"]


def test_fault_seams_fire_alike():
    plan = "kafka.send:p=0.3;kafka.poll:p=0.4@seed=7"
    msgs = _messages(30)
    seen = {}
    for pkg, adapter, faults in (("jax", jkafka, JFAULTS),
                                 ("port", tkafka, TFAULTS)):
        broker = Broker(partitions=2)
        faults.configure(plan)
        with installed(broker):
            prod = adapter.KafkaProducerAdapter("k:9092", "flows", True)
            sends = []
            for m in msgs:
                try:
                    prod.send(m)
                    sends.append(1)
                except OSError:
                    sends.append(0)
            cons = adapter.KafkaConsumerAdapter("k:9092", "flows",
                                                fixedlen=True)
            polls = []
            for _ in range(20):
                try:
                    b = cons.poll(4)
                    polls.append(-1 if b is None else len(b))
                except OSError:
                    polls.append("fault")
        faults.configure("")
        seen[pkg] = (sends, polls, broker.messages())
    assert seen["port"] == seen["jax"]
    sends, polls, _ = seen["port"]
    assert 0 < sum(sends) < len(sends) and "fault" in polls


# ---- the entries -----------------------------------------------------------


@pytest.mark.parametrize("flags", [
    ["-proto.fixedlen", "-produce.shard", "-bus.partitions", "4"],
    [],
], ids=["shard-fixedlen", "roundrobin-bare"])
def test_mocker_puts_the_same_frames_on_the_same_partitions(flags):
    logs = {}
    for pkg, cli in (("jax", jcli), ("port", tcli)):
        broker = Broker(partitions=4)
        with installed(broker):
            assert cli.main(["mocker", "-produce.count", "3000", *GEN,
                             *flags]) == 0
        logs[pkg] = broker.messages()
    assert logs["port"] == logs["jax"]
    parts = logs["port"]
    assert sum(map(len, parts)) == 3000 and all(parts)
    if "-produce.shard" in flags:
        # every key on one partition: the mesh's shard contract
        owner = {}
        for p, msgs in enumerate(parts):
            for b in msgs:
                m = twire.decode_frames(b)[0]
                key = (m.src_addr, m.dst_addr, m.src_port, m.dst_port,
                       m.proto)
                assert owner.setdefault(key, p) == p
    else:
        assert [len(p) for p in parts] == [750] * 4


def _processor(cli, broker, db, *flags, backend=True):
    args = ["processor", "-sink", f"sqlite:{db}", *NARROW, *flags]
    args += ["-processor.backend", "cpu"] if backend else ["-device", "cpu"]
    broker.reset_groups()
    broker.interrupt_when_drained = True
    try:
        with installed(broker):
            assert cli.main(args) == 0
    finally:
        broker.interrupt_when_drained = False
    # every offset committed at the drained end
    for p, msgs in enumerate(broker.messages()):
        assert broker.committed[("tpu-processor", "flows", p)] == len(msgs)


@pytest.mark.parametrize("n,fixed", [(6000, True), (1500, False)],
                         ids=["fixedlen", "bare"])
def test_processor_from_kafka_matches_reference(tmp_path, n, fixed):
    broker = Broker(partitions=2)
    framing = ["-proto.fixedlen"] if fixed else []
    flows = _fill(broker, n, *framing)
    jdb, tdb = tmp_path / "jax.db", tmp_path / "port.db"
    _processor(jcli, broker, jdb, *framing, *DRAIN)
    _processor(tcli, broker, tdb, *framing, *DRAIN)
    for table in TABLES:
        want = _rows(jdb, table)
        if table != "ddos_alerts":
            assert want, table
        assert _rows(tdb, table) == want, table
    _assert_oracle(tdb, flows)


def test_processor_from_kafka_at_defaults(tmp_path):
    """The port's processor at its defaults on -device cpu (the
    host-grouped pipeline, the prefetch feed), stopped the way a caller
    stops a live run: flows_5m equals the oracle."""
    from flow_pipeline_tpu_torch.engine.hostfused import HostGroupPipeline

    broker = Broker(partitions=2)
    flows = _fill(broker, 4000, "-proto.fixedlen")
    db = tmp_path / "d.db"

    def on_start(worker, services):
        def stop():
            deadline = time.monotonic() + FOREVER
            while worker.flows_seen < len(flows):
                assert time.monotonic() < deadline
                time.sleep(0.01)
            worker.request_stop()

        threading.Thread(target=stop, daemon=True).start()

    with installed(broker):
        worker = tcli.run_processor(
            ["-device", "cpu", "-proto.fixedlen", "-sink", f"sqlite:{db}",
             *NARROW], on_start=on_start)
    assert type(worker.fused) is HostGroupPipeline
    assert type(worker.consumer.inner).__name__ == "KafkaConsumerAdapter"
    assert worker.flows_seen == len(flows)
    _assert_oracle(db, flows)


def test_inserter_from_kafka_matches_reference(tmp_path):
    cols = ("time_flow, type, sampling_rate, src_as, dst_as, src_ip, "
            "dst_ip, bytes, packets, etype, proto, src_port, dst_port")
    broker = Broker(partitions=2)
    _fill(broker, 900)
    got = {}
    for pkg, cli in (("jax", jcli), ("port", tcli)):
        db = tmp_path / f"{pkg}.db"
        broker.reset_groups()
        broker.interrupt_when_drained = True
        with installed(broker):
            assert cli.main(["inserter", "-sqlite", str(db)]) == 0
        broker.interrupt_when_drained = False
        conn = sqlite3.connect(db)
        got[pkg] = conn.execute(
            f"SELECT {cols} FROM flows ORDER BY id").fetchall()
        conn.close()
        assert broker.committed[("postgres-inserter", "flows", 1)] == 450
    assert len(got["port"]) == 900 and got["port"] == got["jax"]


def test_collector_into_kafka_matches_reference():
    from flow_pipeline_tpu.collector import CollectorConfig as JConfig
    from flow_pipeline_tpu.collector import CollectorServer as JServer
    from flow_pipeline_tpu.schema.message import FlowType

    want_n = 17
    logs = {}
    # the reference's collector_main, its loop replaced by the sends
    broker = Broker(partitions=1)
    with installed(broker):
        prod = jkafka.KafkaProducerAdapter("k:9092", "flows", True)
        server = JServer(prod, JConfig(netflow_addr=("127.0.0.1", 0),
                                       sflow_addr=("127.0.0.1", 0))).start()
        try:
            _send(server.ports, DATAGRAMS)
            _wait(lambda: broker.sent >= want_n)
        finally:
            server.stop()
            prod.flush()
    logs["jax"] = broker.messages()[0]
    broker = Broker(partitions=1)

    def on_start(collector):
        _send(collector.ports, DATAGRAMS)
        _wait(lambda: broker.sent >= want_n)

    with installed(broker):
        assert tcli.run_collector(
            ["-proto.fixedlen", "-listen.netflow", "127.0.0.1:0",
             "-listen.sflow", "127.0.0.1:0", "-metrics.addr", ""],
            on_start=on_start) == 0
    assert broker.flushes == 1  # the client drained at the end
    logs["port"] = broker.messages()[0]
    msgs = {pkg: [twire.decode_frames(b)[0] for b in log]
            for pkg, log in logs.items()}
    assert len(msgs["port"]) == len(msgs["jax"]) == want_n
    skip = ("time_received", "time_flow_start", "time_flow_end")
    for sflow in (False, True):
        assert [_fields(m, skip) for m in msgs["port"]
                if (m.type == FlowType.SFLOW_5) == sflow] == [
            _fields(m, skip) for m in msgs["jax"]
            if (m.type == FlowType.SFLOW_5) == sflow]
    assert all(m.time_received >= NOW for m in msgs["port"])


def _wait(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.01)


# ---- the mesh member -------------------------------------------------------


class ListSink:
    def __init__(self):
        self.tables = {}
        self._lock = threading.Lock()

    def write(self, table, rows):
        with self._lock:
            self.tables.setdefault(table, []).append(rows)


def _canon(tables) -> dict:
    return {name: sorted(json.dumps({k: np.asarray(v).tolist()
                                     for k, v in sorted(rows.items())})
                         for rows in batches)
            for name, batches in tables.items()}


def _coordinator(pkg, partitions, sink):
    if pkg == "port":
        vals = tcli._parse_processor(["-device", "cpu", *MESH_FLAGS])
        specs = tmesh.spec_from_models(tcli._build_models(vals, CPU))
        coord = tmesh.MeshCoordinator(specs, partitions, sinks=[sink],
                                      heartbeat_timeout=FOREVER)
        return coord, tmesh.MeshCoordinatorServer(coord, 0).start()
    vals = jcli._processor_flags(jcli._common_flags(
        jcli.FlagSet("t"))).parse(MESH_FLAGS)
    specs = jmesh.spec_from_models(jcli._build_models(vals))
    coord = jmesh.MeshCoordinator(specs, partitions, sinks=[sink],
                                  heartbeat_timeout=FOREVER)
    return coord, jmesh.MeshCoordinatorServer(coord, 0).start()


def _member_argv(server, mid):
    return ["processor", "-mesh.role", "member", "-mesh.id", mid,
            "-mesh.coordinator", f"http://127.0.0.1:{server.port}",
            "-processor.backend", "cpu", "-proto.fixedlen",
            "-kafka.brokers", "kafka:9092", *MESH_FLAGS, *DRAIN]


def test_member_entry_matches_reference():
    """Each package's ``processor -mesh.role member`` entry against its
    own coordinator server, over the one partition the coordinator
    assigns it; the drained broker's interrupt ends both loops (a last
    submit, then leave)."""
    broker = Broker(partitions=1)
    flows = _fill(broker, 4096, "-proto.fixedlen")
    merged = {}
    for pkg, cli in (("jax", jcli), ("port", tcli)):
        sink = ListSink()
        coord, server = _coordinator(pkg, 1, sink)
        broker.reset_groups()
        broker.interrupt_when_drained = True
        try:
            with installed(broker):
                assert cli.main(_member_argv(server, "m0")) == 0
            assert coord.status()["covered"] == [len(flows)]
        finally:
            broker.interrupt_when_drained = False
            server.stop()
            coord.close()
        merged[pkg] = _canon(sink.tables)
    assert merged["port"] == merged["jax"]
    assert merged["port"]["flows_5m"] and merged["port"]["top_talkers"]
    total = sum(sum(json.loads(d)["count"])
                for d in merged["port"]["flows_5m"])
    assert total == len(flows)


def test_two_members_over_assigned_partitions():
    """Two members of ``cli.build_member`` (Kafka consumers over the
    partitions assigned to each, one each) against the port's
    coordinator server; the key-hash sharded stream's merged flows_5m
    equals the oracle."""
    broker = Broker(partitions=2)
    flows = _fill(broker, 6000, "-proto.fixedlen", "-produce.shard",
                  "-bus.partitions", "2")
    sink = ListSink()
    coord, server = _coordinator("port", 2, sink)
    stop = threading.Event()
    members, services, threads = [], [], []
    try:
        with installed(broker):
            for i in range(2):
                argv = _member_argv(server, f"w{i}")[1:]
                m, svc = tcli.build_member(argv + ["-mesh.listen",
                                                   "127.0.0.1:0"])
                members.append(m)
                services.append(svc)
            assert all(svc["state"] is not None for svc in services)
            for m in members:
                m.coordinator.join(m.member_id)
                m._joined = True
            threads = [threading.Thread(target=m.run, args=(stop,),
                                        daemon=True) for m in members]
            for t in threads:
                t.start()
            _wait(lambda: coord.status()["covered"] == [
                len(p) for p in broker.messages()]
                and all(m.idle_streak >= 20 for m in members), FOREVER)
            stop.set()
            for t in threads:
                t.join(FOREVER)
            owned = sorted((type(m.worker.consumer).__name__,
                            m.worker.consumer.partitions) for m in members)
            for m in members:
                m.finalize()
    finally:
        stop.set()
        for svc in services:
            tcli.stop_services(svc)
        server.stop()
        coord.close()
    assert owned == [("KafkaConsumerAdapter", [0]),
                     ("KafkaConsumerAdapter", [1])]
    got = {}
    for rows in sink.tables["flows_5m"]:
        for i in range(len(rows["timeslot"])):
            key = (int(rows["timeslot"][i]), int(rows["src_as"][i]),
                   int(rows["dst_as"][i]), int(rows["etype"][i]))
            acc = got.setdefault(key, [0, 0, 0])
            for j, col in enumerate(("bytes", "packets", "count")):
                acc[j] += int(rows[col][i])
    want = oracle_5m(flows)
    assert {k: tuple(v) for k, v in got.items()} == {
        (int(want["timeslot"][i]), int(want["src_as"][i]),
         int(want["dst_as"][i]), int(want["etype"][i])):
        (int(want["bytes"][i]), int(want["packets"][i]),
         int(want["count"][i])) for i in range(len(want["count"]))}


# ---- without a client, the command lines, the backend flag ---------------


@pytest.mark.parametrize("argv", [
    ["mocker", "-produce.count", "10"],
    ["processor", "-metrics.addr", ""],
    ["inserter"],
    ["collector", "-metrics.addr", ""],
    ["processor", "-metrics.addr", "", "-mesh.role", "member",
     "-mesh.coordinator", "http://127.0.0.1:9"],
], ids=["mocker", "processor", "inserter", "collector", "member"])
def test_kafka_routes_exit_2_without_a_client(argv):
    assert not tkafka.available() and not jkafka.available()
    extra = ["-processor.backend", "cpu"] if argv[0] == "processor" else []
    assert jcli.main([*argv, *extra]) == 2
    assert tcli.main([*argv, *extra]) == 2
    with pytest.raises(RuntimeError, match="Kafka transport unavailable"):
        tkafka.KafkaConsumerAdapter("k:9092")


def _compose_lines():
    import yaml

    out = []
    for path in sorted((REPO / "deploy" / "compose").glob("*.yml")):
        doc = yaml.safe_load(path.read_text())
        for name, svc in doc.get("services", {}).items():
            cmd = svc.get("command")
            if isinstance(cmd, list):
                cmd = " ".join(cmd)
            if cmd and cmd.strip().startswith("flowtpu-"):
                out.append(pytest.param(cmd.strip(),
                                        id=f"{path.stem}-{name}"))
    return out


@pytest.mark.parametrize("cmd", _compose_lines())
def test_compose_command_line_parses(cmd):
    prog, *argv = shlex.split(cmd)
    command = prog.removeprefix("flowtpu-")
    fs = tcli.flagset(command)
    vals = fs.parse(argv)
    if command == "processor":
        tcli._resolve_backend(vals, fs.given)
        want = "cpu" if "-processor.backend cpu" in cmd else "cuda"
        assert vals["device"] == want
    assert set(fs.given) == {a.lstrip("-").split("=")[0] for a in argv
                             if a.startswith("-")}


@pytest.mark.parametrize("flags,device", [
    ([], "cuda"),
    (["-processor.backend", "cpu"], "cpu"),
    (["-processor.backend", "tpu"], "cuda"),
    (["-device", "cpu"], "cpu"),
    (["-device", "cpu", "-processor.backend", "cpu"], "cpu"),
    (["-device", "cuda:0", "-processor.backend", "tpu"], "cuda:0"),
    (["-device", "cuda", "-processor.backend", "cpu"], ValueError),
    (["-device", "cpu", "-processor.backend", "tpu"], ValueError),
    (["-processor.backend", "gpu"], ValueError),
])
def test_processor_backend_maps_onto_device(flags, device):
    if device is ValueError:
        with pytest.raises(ValueError, match="processor.backend"):
            tcli._parse_processor(flags)
        return
    assert tcli._parse_processor(flags)["device"] == device
