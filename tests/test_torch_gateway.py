"""The port's gateway (flow_pipeline_tpu_torch/gateway/{subscriber,ring}.py,
the ``gateway`` entry) against the JAX package's, on the CPU (tolerance:
none).

A port worker on one seeded Zipf frames file with spreader legs (3,000
flows at 5 flows/s: two 5-minute windows close mid-stream; small widths,
the spread detectors and the audit on) publishes a snapshot after every
batch. Each snapshot's canonical state is published, unchanged, into a
port SnapshotStore and (rebuilt by the reference's ``state_to_snapshot``)
into a JAX SnapshotStore, each behind its package's ServeServer; so both
upstreams serve the same states. Then:

- ``apply_delta(prev, diff_states(prev, cur))`` is ``cur``, array for
  array, equal to the reference's, with byte-equal delta frames; a chain
  hole raises ``DeltaGapError`` in both;
- a port gateway mirroring the port server over HTTP and a JAX gateway
  mirroring the JAX server take the same sync kinds (full, delta, none)
  and serve ``/query/*`` bodies byte-equal to each other and to their
  upstream at every version; the hot set is pre-rendered;
- ``HashRing`` assignments equal the reference's, with dead nodes
  skipped; ``GatewayClient`` fails over a stopped replica;
- the ``gateway`` entry exits 2 without an upstream, as the reference's
  does, and run in process it mirrors a live upstream.

Every server binds 127.0.0.1:0, polls run at 0.02 s, and every thread a
test starts is stopped in a ``finally``.
"""

import http.client
import time
import types

import numpy as np
import pytest
import torch

from flow_pipeline_tpu import cli as jcli
from flow_pipeline_tpu.gateway import delta as jdelta
from flow_pipeline_tpu.gateway import ring as jring
from flow_pipeline_tpu.gateway.subscriber import SnapshotGateway as JGateway
from flow_pipeline_tpu.obs import REGISTRY as JREGISTRY
from flow_pipeline_tpu.serve import ServeServer as JServe
from flow_pipeline_tpu.serve import SnapshotStore as JStore
from flow_pipeline_tpu_torch import cli as tcli
from flow_pipeline_tpu_torch.engine import StreamWorker as TWorker
from flow_pipeline_tpu_torch.gateway import GatewayClient, HashRing
from flow_pipeline_tpu_torch.gateway import delta as tdelta
from flow_pipeline_tpu_torch.gateway.subscriber import \
    SnapshotGateway as TGateway
from flow_pipeline_tpu_torch.obs import REGISTRY as TREGISTRY
from flow_pipeline_tpu_torch.serve import ServeServer as TServe
from flow_pipeline_tpu_torch.serve import SnapshotStore as TStore
from flow_pipeline_tpu_torch.serve import attach_worker as tattach
from flow_pipeline_tpu_torch.transport import Consumer as TConsumer

FLAGS = ["-processor.batch", "512", "-sketch.width", "1024",
         "-sketch.capacity", "64", "-sketch.topk", "50", "-spread.enabled",
         "-spread.width", "512", "-spread.capacity", "64", "-spread.topk",
         "32", "-model.ddos=false", "-feed.prefetch", "0", "-ingest.mode",
         "serial", "-flush.count", "0", "-metrics.addr", "", "-sink", ""]
POLL = 0.02


def port_states(tmp_dir) -> list:
    """The canonical states (gateway.delta.snapshot_state) of the
    snapshots a port worker publishes after each batch of a seeded Zipf
    stream, in version order."""
    frames = tmp_dir / "frames.bin"
    assert tcli.main(["mocker", "-out", str(frames), "-produce.profile",
                      "zipf", "-zipf.spread", "0.05", "-produce.count",
                      "3000", "-produce.rate", "5", "-produce.seed",
                      "11"]) == 0
    vals = tcli._processor_flags(tcli._common_flags(
        tcli.FlagSet("processor"))).parse(["-device", "cpu", "-in",
                                           str(frames), *FLAGS])
    bus = tcli._load_frames_bus(vals["in"], vals["kafka.topic"])
    worker = TWorker(TConsumer(bus, vals["kafka.topic"]),
                     tcli._build_models(vals, torch.device("cpu")), [],
                     poll_max=vals["processor.batch"], prefetch=0,
                     snapshot_every=0, **tcli._ingest_kwargs(vals))
    pub = tattach(worker, refresh=0.0)
    states = []
    while worker.run_once():
        with worker.lock:
            states.append(tdelta.snapshot_state(pub.publish(worker)))
    worker.finalize()
    return states


def assert_states_equal(a: dict, b: dict) -> None:
    """Two canonical states hold equal metadata and arrays of equal
    dtype, shape and words."""
    assert {k: v for k, v in a.items() if k not in ("families", "ranges")} \
        == {k: v for k, v in b.items() if k not in ("families", "ranges")}
    assert list(a["families"]) == list(b["families"])
    for name, fa in a["families"].items():
        fb = b["families"][name]
        assert {k: v for k, v in fa.items()
                if k not in ("rows", "cms", "regs")} == \
            {k: v for k, v in fb.items() if k not in ("rows", "cms", "regs")}
        assert list(fa["rows"]) == list(fb["rows"]), name
        for col, arr in fa["rows"].items():
            _same(arr, fb["rows"][col], f"{name}.{col}")
        for plane in ("cms", "regs"):
            assert (fa[plane] is None) == (fb[plane] is None), name
            if fa[plane] is not None:
                _same(fa[plane], fb[plane], f"{name}.{plane}")
    assert list(a["ranges"]) == list(b["ranges"])
    for table, slots in a["ranges"].items():
        other = b["ranges"][table]
        assert [int(s) for s, _ in slots] == [int(s) for s, _ in other]
        for (_, ra), (_, rb) in zip(slots, other):
            assert list(ra) == list(rb)
            for col in ra:
                _same(ra[col], rb[col], f"{table}.{col}")


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """Fresh metric registries in both packages for each test (other
    tests in the process read process totals)."""
    monkeypatch.setattr(JREGISTRY, "_metrics", {})
    monkeypatch.setattr(TREGISTRY, "_metrics", {})


@pytest.fixture(scope="module")
def states(tmp_path_factory):
    out = port_states(tmp_path_factory.mktemp("gateway"))
    assert len(out) >= 6
    return out


def test_apply_delta_round_trip_equals_reference(states):
    for prev, cur in zip(states, states[1:]):
        tree = tdelta.diff_states(prev, cur)
        got = tdelta.apply_delta(prev, tree)
        assert_states_equal(got, cur)
        assert_states_equal(got, jdelta.apply_delta(
            prev, jdelta.diff_states(prev, cur)))
        frame = tdelta.encode_delta(prev, cur)
        assert frame == jdelta.encode_delta(prev, cur)
        (decoded,) = tdelta.decode_frames(frame)
        assert_states_equal(tdelta.apply_delta(prev, decoded), cur)
    hole = tdelta.diff_states(states[0], states[2])
    for mod in (tdelta, jdelta):
        with pytest.raises(mod.DeltaGapError):
            mod.apply_delta(states[1], hole)
    assert issubclass(tdelta.DeltaGapError, tdelta.DeltaError)


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.getheader("ETag"), resp.read()
    finally:
        conn.close()


def _queries(state) -> list:
    fam = state["families"]["top_talkers"]
    rows = fam["rows"]
    key = [int(x) for col in ("src_addr", "dst_addr", "src_port",
                              "dst_port", "proto")
           for x in np.atleast_1d(rows[col][0])]
    out = ["/query/topk", "/query/topk?k=5",
           "/query/topk?model=top_src_ips&k=20",
           "/query/topk?model=top_dst_ports&k=7",
           "/query/estimate?key=" + ",".join(map(str, key)),
           "/query/estimate?model=top_src_ips&key=1,2,3,4",
           "/query/spread", "/query/spread?model=portscan&k=3",
           "/query/audit", "/query/topk?model=ghost", "/query/nope"]
    if state["ranges"].get("flows_5m"):
        out.append("/query/range")
    return out


def _pair(upstream_server, gateway_cls, serve_cls):
    gw = gateway_cls([f"127.0.0.1:{upstream_server.port}"], poll=POLL,
                     timeout=10.0)
    server = serve_cls(gw.store, port=0).start()
    gw.serve_on(server)
    return gw, server


def test_gateway_mirror_bodies_equal_reference(states):
    """Publish the states one by one (twice two at a time, so a delta
    chain spans versions) into both upstreams; after each sync the port
    gateway's bodies equal the JAX gateway's and the port upstream's."""
    tstore, jstore = TStore(), JStore()
    servers, gws = [], []
    try:
        tup, jup = TServe(tstore, port=0).start(), \
            JServe(jstore, port=0).start()
        servers += [tup, jup]
        tgw, tsrv = _pair(tup, TGateway, TServe)
        jgw, jsrv = _pair(jup, JGateway, JServe)
        warmed = [gw._m["prerendered"].value() for gw in (tgw, jgw)]
        servers += [tsrv, jsrv]
        gws += [tgw, jgw]
        kinds = []
        steps = [states[0:1], states[1:3], states[3:4], states[4:6],
                 states[6:]]
        for step in steps:
            if not step:
                continue
            for state in step:
                assert tstore.publish_snapshot(
                    tdelta.state_to_snapshot(state)) is not None
                assert jstore.publish_snapshot(
                    jdelta.state_to_snapshot(state)) is not None
            kind = tgw.sync_once()
            assert jgw.sync_once() == kind
            kinds.append(kind)
            assert tgw.sync_once() == jgw.sync_once() == "none"
            version = step[-1]["version"]
            assert tgw.store.current.version == version
            assert jgw.store.current.version == version
            for path in _queries(step[-1]):
                got = _get(tsrv.port, path)
                assert got == _get(jsrv.port, path), path
                assert got == _get(tup.port, path), path
            code, _, body = _get(tsrv.port, "/query/version")
            assert code == 200 and f'"version": {version}'.encode() in body
        assert kinds[0] == "full" and set(kinds[1:]) == {"delta"}
        got, want = (gw._m["prerendered"].value() - w
                     for gw, w in zip((tgw, jgw), warmed))
        assert got == want > 0
        # a replayed older snapshot never moves the mirror backwards
        assert tgw.store.publish_snapshot(
            tdelta.state_to_snapshot(states[0])) is None
    finally:
        for gw in gws:
            gw.stop()
        for s in servers:
            s.stop()


def test_gateway_threads_mirror(states):
    """The mirror thread at a 0.02-s poll catches up with a live
    upstream."""
    store = TStore()
    store.publish_snapshot(tdelta.state_to_snapshot(states[0]))
    up = TServe(store, port=0).start()
    gw, srv = _pair(up, TGateway, TServe)
    try:
        gw.start()
        for state in states[1:]:
            store.publish_snapshot(tdelta.state_to_snapshot(state))
        deadline = time.monotonic() + 120
        while gw.store.current is None or \
                gw.store.current.version != states[-1]["version"]:
            assert time.monotonic() < deadline, "mirror did not catch up"
            time.sleep(POLL)
        assert _get(srv.port, "/query/topk") == _get(up.port, "/query/topk")
    finally:
        gw.stop()
        srv.stop()
        up.stop()
    assert not any(t.is_alive() for t in gw._threads)


def test_gateway_resyncs_equal_reference(states):
    """A chain hole and a corrupt frame force full resyncs in both
    packages alike; the mirror keeps serving through them, and the
    post-resync full frame at the served version is refused (counted as
    an upstream restart), not un-published."""
    out = {}
    for tag, store_cls, serve_cls, gw_cls, delta in (
            ("port", TStore, TServe, TGateway, tdelta),
            ("jax", JStore, JServe, JGateway, jdelta)):
        store = store_cls()
        for state in states[:4]:
            store.publish_snapshot(delta.state_to_snapshot(state))
        up = serve_cls(store, port=0).start()
        gw, srv = _pair(up, gw_cls, serve_cls)
        try:
            assert gw.sync_once() == "full"
            before = _get(srv.port, "/query/topk?k=3")
            up_ = gw.upstreams[0]
            fetch = up_.fetch
            m = gw._m
            counts0 = (m["resyncs"].value(reason="gap"),
                       m["resyncs"].value(reason="crc"),
                       m["upstream_restarts"].value(
                           upstream=up_.name))
            gap = delta.encode_delta(states[1], states[2])
            torn = bytearray(delta.encode_delta(states[3], states[4]))
            torn[-3] ^= 0xFF
            kinds = []
            for frame in (gap, bytes(torn)):
                up_.fetch = lambda since, f=frame: f
                kinds.append(gw.sync_once())
                assert _get(srv.port, "/query/topk?k=3") == before
            up_.fetch = fetch
            kinds.append(gw.sync_once())
            counts1 = (m["resyncs"].value(reason="gap"),
                       m["resyncs"].value(reason="crc"),
                       m["upstream_restarts"].value(
                           upstream=up_.name))
            out[tag] = (kinds, [b - a for a, b in zip(counts0, counts1)],
                        gw.store.current.version)
            assert _get(srv.port, "/query/topk?k=3") == before
        finally:
            gw.stop()
            srv.stop()
            up.stop()
    assert out["port"] == out["jax"]
    assert out["port"][0] == ["resync", "resync", "full"]
    assert out["port"][1] == [1, 1, 1]


def test_hash_ring_equals_reference():
    nodes = [f"127.0.0.1:{8000 + i}" for i in range(5)]
    tr, jr = HashRing(nodes), jring.HashRing(nodes)
    keys = [f"/query/topk?model=m{i}&k={i % 7}" for i in range(500)]
    for skip in ((), (nodes[1],), tuple(nodes[:4]), tuple(nodes)):
        got = [tr.node_for(k, skip=skip) for k in keys]
        assert got == [jr.node_for(k, skip=skip) for k in keys]
    assert len({tr.node_for(k) for k in keys}) == 5
    assert HashRing([]).node_for("x") is None


def test_client_fails_over_a_stopped_replica(states):
    store = TStore()
    store.publish_snapshot(tdelta.state_to_snapshot(states[-1]))
    replicas = [TServe(store, port=0).start() for _ in range(2)]
    client = GatewayClient([f"127.0.0.1:{r.port}" for r in replicas],
                           timeout=5.0, dead_for=30.0)
    try:
        path = "/query/topk?k=3"
        code, doc = client.get_json(path)
        assert code == 200 and doc["version"] == states[-1]["version"]
        owner = client.ring.node_for(path)
        next(r for r in replicas
             if f"127.0.0.1:{r.port}" == owner).stop()
        code, doc2 = client.get_json(path)
        assert code == 200 and doc2 == doc and client.retries >= 1
    finally:
        client.close()
        for r in replicas:
            r.stop()


def test_gateway_entry_needs_an_upstream():
    for main in (tcli.gateway_main, jcli.gateway_main):
        assert main(["-gateway.listen", "127.0.0.1:0"]) == 2
    assert tcli.main(["gateway"]) == 2


def test_gateway_entry_mirrors_in_process(states):
    """``gateway`` through the CLI in process: its replica mirrors a live
    upstream and answers its bodies until ``on_start`` returns."""
    store = TStore()
    for state in states[:3]:
        store.publish_snapshot(tdelta.state_to_snapshot(state))
    up = TServe(store, port=0).start()
    seen = types.SimpleNamespace(body=None, mirror=None)

    def on_start(gw, server):
        deadline = time.monotonic() + 120
        while gw.store.current is None or \
                gw.store.current.version != states[2]["version"]:
            assert time.monotonic() < deadline
            time.sleep(POLL)
        seen.body = _get(server.port, "/query/topk?k=4")
        seen.mirror = gw

    try:
        assert tcli.run_gateway(
            ["-gateway.upstream", f"127.0.0.1:{up.port}", "-gateway.listen",
             "127.0.0.1:0", "-gateway.poll", str(POLL), "-loglevel",
             "warning"], on_start=on_start) == 0
        assert seen.body == _get(up.port, "/query/topk?k=4")
        assert not any(t.is_alive() for t in seen.mirror._threads)
    finally:
        up.stop()
