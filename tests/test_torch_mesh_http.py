"""The port's mesh over HTTP (flow_pipeline_tpu_torch/mesh/server.py:
MeshCoordinatorServer, RemoteCoordinator, MemberStateServer; cli.py
``processor -mesh.role coordinator|member`` and ``lineage``) against the
JAX package's, on the CPU (tolerance: none).

One numpy-seeded Zipf stream (8,192 flows of 200 keys at 40 flows/s,
the reference's mesh stream, key-hash sharded over 2 partitions: one
per member, so each member's watermark is its partition's and the
merged rows reach the sink in the same chunks on every run) feeds:

- the port's coordinator server with two port members, each speaking
  to it over real localhost HTTP through a RemoteCoordinator and
  answering the ``/topk`` fan-out from its MemberStateServer;
- the same topology built from the JAX package, and the JAX in-process
  mesh;
- the two packages crossed: a JAX member against the port's server,
  a port member against the JAX server.

All of them write the same merged tables. The servers' answers
(``/healthz``, ``/state``, ``/topk``, the 400s and 404s,
``/debug/lineage``), the ``lineage`` entry's text, the member state
bytes and the ``/debug/trace`` fan-out are held against the JAX
package's over the same coordinator state. Nothing here waits on wall
time: meshes wait for idle rounds, with a heartbeat timeout no run
reaches.
"""

import functools
import http.client
import json
import threading
import time
import types
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

from flow_pipeline_tpu import cli as jcli
from flow_pipeline_tpu import mesh as jmesh
from flow_pipeline_tpu.engine import WorkerConfig as JWorkerConfig
from flow_pipeline_tpu.mesh import codec as jcodec
from flow_pipeline_tpu.mesh import coordinator as jcoord
from flow_pipeline_tpu.models import heavy_hitter as jhh
from flow_pipeline_tpu.models import window_agg as jwagg
from flow_pipeline_tpu.obs import REGISTRY as JREGISTRY
from flow_pipeline_tpu.obs import TRACER as JTRACER
from flow_pipeline_tpu.schema.batch import FlowBatch as JBatch
from flow_pipeline_tpu.transport import Consumer as JConsumer
from flow_pipeline_tpu.transport import InProcessBus as JBus
from flow_pipeline_tpu_torch import cli as tcli
from flow_pipeline_tpu_torch import mesh as tmesh
from flow_pipeline_tpu_torch.engine import WorkerConfig as TWorkerConfig
from flow_pipeline_tpu_torch.gen import FlowGenerator, ZipfProfile
from flow_pipeline_tpu_torch.mesh import codec as tcodec
from flow_pipeline_tpu_torch.mesh import coordinator as tcoord
from flow_pipeline_tpu_torch.models import heavy_hitter as thh
from flow_pipeline_tpu_torch.models import window_agg as twagg
from flow_pipeline_tpu_torch.obs import REGISTRY as TREGISTRY
from flow_pipeline_tpu_torch.obs import TRACER as TTRACER
from flow_pipeline_tpu_torch.transport import Consumer as TConsumer
from flow_pipeline_tpu_torch.transport import InProcessBus as TBus
from test_torch_mesh import FOREVER, ListSink
import torch_cpu  # noqa: F401  (one torch thread; see the module)

PARTITIONS = 2
CPU = torch.device("cpu")
FLAGS = ["-processor.batch", "512", "-sketch.width", "1024",
         "-sketch.capacity", "64", "-sketch.topk", "50",
         "-model.ddos=false"]
TIMEOUT = 60  # every HTTP request of a test


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """Fresh metric registries in both packages for each test; both trace
    rings back at ring mode and unpaused afterwards."""
    monkeypatch.setattr(JREGISTRY, "_metrics", {})
    monkeypatch.setattr(TREGISTRY, "_metrics", {})
    yield
    for tracer in (JTRACER, TTRACER):
        tracer.configure("ring")
        tracer.paused = False


def _batches() -> list:
    gen = FlowGenerator(ZipfProfile(n_keys=200, alpha=1.3), seed=7,
                        t0=1_700_000_000, rate=40.0)
    return [gen.batch(2048) for _ in range(4)]


BATCHES = _batches()


def _bus(pkg):
    if pkg == "port":
        bus = TBus()
        bus.create_topic("flows", PARTITIONS)
        for b in BATCHES:
            tmesh.produce_sharded(bus, "flows", b, PARTITIONS)
        return bus
    bus = JBus()
    bus.create_topic("flows", PARTITIONS)
    for b in BATCHES:
        jmesh.produce_sharded(bus, "flows", JBatch(dict(b.columns)),
                              PARTITIONS)
    return bus


class _Pkg:
    """One package's mesh surface, as a caller builds it."""

    def __init__(self, name):
        self.name = name
        if name == "port":
            self.mesh, self.cli, self.codec = tmesh, tcli, tcodec
            self.vals = tcli._processor_flags(tcli._common_flags(
                tcli.FlagSet("t"))).parse(["-device", "cpu", *FLAGS])
            self.models = lambda: tcli._build_models(self.vals, CPU)
            self.config = TWorkerConfig(poll_max=512, snapshot_every=0)
            self.consumer = TConsumer
        else:
            # the reference's consumer decodes the fixed-length frames
            self.mesh, self.cli, self.codec = jmesh, jcli, jcodec
            self.vals = jcli._processor_flags(jcli._common_flags(
                jcli.FlagSet("t"))).parse(FLAGS)
            self.models = lambda: jcli._build_models(self.vals)
            self.config = JWorkerConfig(poll_max=512, snapshot_every=0)
            self.consumer = functools.partial(JConsumer, fixedlen=True)

    def coordinator(self, sinks=()):
        return self.mesh.MeshCoordinator(
            self.mesh.spec_from_models(self.models()), PARTITIONS,
            sinks=sinks, heartbeat_timeout=FOREVER)

    def member(self, mid, base_url, bus):
        """A member over HTTP: its RemoteCoordinator advertises the state
        server it is given once that is bound."""
        remote = self.mesh.RemoteCoordinator(base_url, timeout=TIMEOUT)

        def factory(partitions):
            return self.consumer(bus, "flows", group=f"mesh-{mid}",
                                 partitions=list(partitions))

        m = self.mesh.MeshMember(mid, remote, factory, self.models,
                                 config=self.config, sync_interval=0.05)
        state = self.mesh.MemberStateServer(m, 0).start()
        remote.state_url = state.url
        return m, state


PKGS = {"port": _Pkg("port"), "jax": _Pkg("jax")}


def _wait_idle(coord, members, threads, idle_rounds=20):
    """The runtime's quiescence: every member idle for ``idle_rounds``
    steps and every partition owned, on two consecutive polls."""
    streak = 0
    deadline = time.monotonic() + FOREVER
    while streak < 2:
        assert time.monotonic() < deadline, "the mesh never went idle"
        assert all(t.is_alive() for t in threads), "a member thread died"
        ok = all(m.idle_streak >= idle_rounds for m in members)
        if ok:
            st = coord.status()
            ok = sum(len(v["owned"]) for v in st["members"].values()) \
                == st["partitions"]
        streak = streak + 1 if ok else 0
        time.sleep(0.02)


def _http_mesh(coord_pkg, member_pkgs, on_idle=None):
    """A coordinator server of ``coord_pkg`` and one member per entry of
    ``member_pkgs`` over HTTP; runs the stream to its end. ``on_idle(coord,
    server, members)`` runs with the members drained, before they
    finalize. Returns the coordinator's merged tables."""
    sink = ListSink()
    P = PKGS[coord_pkg]
    coord = P.coordinator(sinks=[sink])
    server = P.mesh.MeshCoordinatorServer(coord, 0).start()
    base = f"http://127.0.0.1:{server.port}"
    buses = {pkg: _bus(pkg) for pkg in set(member_pkgs)}
    pairs = [PKGS[pkg].member(f"w{i}", base, buses[pkg])
             for i, pkg in enumerate(member_pkgs)]
    members = [m for m, _ in pairs]
    stop = threading.Event()
    threads = []
    try:
        # every member joins before any consumes: the first assignment
        # covers the whole membership
        for m in members:
            m.coordinator.join(m.member_id)
            m._joined = True
        threads = [threading.Thread(target=m.run, args=(stop,),
                                    name=f"mesh-{m.member_id}", daemon=True)
                   for m in members]
        for t in threads:
            t.start()
        _wait_idle(coord, members, threads)
        if on_idle is not None:
            on_idle(coord, server, members)
        stop.set()
        for t in threads:
            t.join(FOREVER)
        for m in members:
            m.finalize()
    finally:
        stop.set()
        for _, state in pairs:
            state.stop()
        server.stop()
        coord.close()
    return sink.tables


def _canon(tables) -> dict:
    """Every table's row batches as JSON-able lists, in a fixed order."""
    out = {}
    for name, batches in tables.items():
        docs = [json.dumps({k: np.asarray(v).tolist()
                            for k, v in sorted(rows.items())})
                for rows in batches]
        out[name] = sorted(docs)
    return out


RUNS = {}


def _tables(key):
    """The merged tables of one topology, run once per module."""
    if key not in RUNS:
        if key == "jax-inprocess":
            sink = ListSink()
            P = PKGS["jax"]
            jmesh.InProcessMesh(_bus("jax"), "flows", 2,
                                model_factory=P.models, config=P.config,
                                sinks=[sink],
                                heartbeat_timeout=FOREVER).run(
                                    timeout=FOREVER)
            RUNS[key] = _canon(sink.tables)
        else:
            coord_pkg, *member_pkgs = key.split("/")
            RUNS[key] = _canon(_http_mesh(coord_pkg, member_pkgs))
    return RUNS[key]


def _get(url):
    """(status, body bytes) of a GET, errors included."""
    try:
        with urllib.request.urlopen(url, timeout=TIMEOUT) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _post(url, body: bytes, ctype="application/json"):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


# ---- (a), (b): the merged rows ---------------------------------------------


def test_http_mesh_equals_the_jax_topology_and_in_process_mesh():
    port = _tables("port/port/port")
    assert port["flows_5m"] and port["top_talkers"]
    assert set(port) >= {"flows_5m", "top_talkers", "top_src_ips",
                         "top_dst_ips", "top_src_ports", "top_dst_ports"}
    assert port == _tables("jax/jax/jax")
    assert port == _tables("jax-inprocess")
    total = sum(sum(json.loads(d)["count"]) for d in port["flows_5m"])
    assert total == sum(len(b) for b in BATCHES)


def test_cross_package_members_merge_the_same_rows():
    """A JAX member against the port's coordinator server, and a port
    member against the JAX one."""
    want = _tables("port/port/port")
    assert _tables("port/jax/port") == want
    assert _tables("jax/port/jax") == want


def test_topk_equals_a_host_fold_of_the_members_state():
    """With the members drained and idle, the port server's /topk is the
    fold of what their /meshstate endpoints answer, fetched directly."""
    from flow_pipeline_tpu_torch.families import registry
    from flow_pipeline_tpu_torch.sink.base import rows_to_records

    got = {}

    def on_idle(coord, server, members):
        base = f"http://127.0.0.1:{server.port}"
        status, body = _get(f"{base}/topk?model=top_talkers&k=20")
        assert status == 200
        got["topk"] = json.loads(body)
        states = []
        for m in members:
            url = m.coordinator.state_url + "?model=top_talkers"
            status, raw = _get(url)
            assert status == 200
            states.append(tcodec.decode(raw))
        slot = max(s["slot"] for s in states)
        spec = coord._by_name["top_talkers"]
        fam = registry.family(spec.kind)
        merged = registry.hook(fam, "merge")(
            [s["payload"] for s in states if s["slot"] == slot],
            spec.config)
        rows = registry.hook(fam, "top_rows")(merged, spec.config, 20, slot)
        got["fold"] = json.loads(json.dumps(
            {"model": "top_talkers", "window_start": slot,
             "rows": rows_to_records(rows)}, default=str))
        status, body = _get(f"{base}/healthz")
        got["healthz"] = json.loads(body)

    _http_mesh("port", ["port", "port"], on_idle=on_idle)
    assert got["topk"] == got["fold"] and got["topk"]["rows"]
    assert got["healthz"]["members"] == 2 and got["healthz"]["ok"]


# ---- (c), (d): the servers' answers over one coordinator state ------------


def _hh_spec(coord_mod, hh):
    cfg = hh.HeavyHitterConfig(key_cols=("proto",), value_cols=("bytes",),
                               width=128, depth=2, capacity=4,
                               batch_size=64)
    return coord_mod.ModelSpec("talkers", "hh", cfg, 4, 300), cfg


def _wagg_spec(coord_mod, wagg):
    cfg = wagg.WindowAggConfig(key_cols=("src_as",), value_cols=("bytes",),
                               window_seconds=300, scale_col=None,
                               batch_size=256)
    return coord_mod.ModelSpec("flows_5m", "wagg", cfg, 0, 300)


class _StateMember:
    """A member-shaped object whose open window is a fixed table."""

    def __init__(self, state):
        self.state = state

    def _query_state(self, model):
        return self.state if model == "talkers" else None


FIXED_NOW = 1_700_000_321.5


def _frozen_clock(monkeypatch):
    clock = types.SimpleNamespace(time=lambda: FIXED_NOW,
                                  perf_counter=lambda: 42.0,
                                  monotonic=time.monotonic)
    for mod in (tcoord, jcoord):
        monkeypatch.setattr(mod, "time", clock)


def _protocol_answers(pkg):
    """One coordinator server of ``pkg`` driven over HTTP by the same
    calls; the answers of every read path."""
    coord_mod, codec, hh, wagg, init = {
        "port": (tcoord, tcodec, thh, twagg,
                 lambda cfg: thh.hh_init(cfg, CPU)),
        "jax": (jcoord, jcodec, jhh, jwagg, jhh.hh_init)}[pkg]
    mesh = tmesh if pkg == "port" else jmesh
    spec, cfg = _hh_spec(coord_mod, hh)
    coord = coord_mod.MeshCoordinator([_wagg_spec(coord_mod, wagg), spec],
                                      1, heartbeat_timeout=FOREVER)
    table = codec.hh_payload(init(cfg))
    table["table_keys"][0] = (6,)
    table["table_vals"][0] = (30.0, 1.0)
    state = mesh.MemberStateServer(
        _StateMember({"slot": 600, "payload": table}), 0).start()
    server = mesh.MeshCoordinatorServer(coord, 0).start()
    base = f"http://127.0.0.1:{server.port}"
    out = {}
    try:
        post = [
            ("/mesh/join", json.dumps({"member": "a",
                                       "state_url": state.url}).encode()),
            ("/mesh/sync", json.dumps({"member": "a"}).encode()),
        ]
        for path, body in post:
            out[f"POST {path}"] = _post(base + path, body)
        contrib = codec.encode({
            "member": "a", "ranges": {0: [0, 10]}, "watermark": 900,
            "closed": {300: {"flows_5m": codec.wagg_payload(
                {(7,): np.array([50, 1], np.uint64)})}},
            "open": {}, "final": False, "release": False, "flows": 10,
            "span": {"sub": 1, "member": "a", "sent": 1_700_000_300.25,
                     "chunk": 3, "windows": [300]}})
        out["POST /mesh/submit"] = _post(base + "/mesh/submit?member=a",
                                         contrib,
                                         "application/octet-stream")
        for path in ("/healthz", "/state", "/topk", "/topk?model=talkers&k=2",
                     "/topk?k=abc", "/topk?model=nope", "/nope",
                     "/debug/lineage", "/debug/lineage?model=flows_5m&slot=300",
                     "/debug/lineage?model=nope"):
            out[f"GET {path}"] = _get(base + path)
        for path, body in (("/mesh/join", b"{}"), ("/mesh/join", b"{"),
                           ("/mesh/nope", b"{}"),
                           ("/mesh/sync", json.dumps({"member": "a"}).encode())):
            out[f"POST {path} {body!r}"] = _post(base + path, body)
        out["POST /mesh/leave"] = _post(
            base + "/mesh/leave", json.dumps({"member": "a"}).encode())
        out["GET /state after leave"] = _get(base + "/state")
    finally:
        server.stop()
        state.stop()
        coord.close()
    return out


def test_server_answers_equal_the_jax_server(monkeypatch):
    _frozen_clock(monkeypatch)
    got = {pkg: _protocol_answers(pkg) for pkg in PKGS}
    port, jax = got["port"], got["jax"]
    assert port.keys() == jax.keys()
    for key in port:
        (ps, pb), (js, jb) = port[key], jax[key]
        assert ps == js, key
        assert json.loads(pb) == json.loads(jb), key
    codes = {k: v[0] for k, v in port.items()}
    assert codes["GET /topk?k=abc"] == codes["POST /mesh/join b'{}'"] == \
        codes["POST /mesh/join b'{'"] == codes["GET /topk?model=nope"] == 400
    assert codes["GET /nope"] == codes["POST /mesh/nope b'{}'"] == 404
    topk = json.loads(port["GET /topk?model=talkers&k=2"][1])
    assert topk["window_start"] == 600 and topk["rows"][0]["bytes"] == 30.0
    lineage = json.loads(port["GET /debug/lineage"][1])
    assert [r["status"] for r in lineage] == ["merged"]
    assert lineage[0]["members"] == ["a"]
    assert json.loads(port["GET /healthz"][1])["members"] == 1


def test_lineage_entry_equals_the_jax_entry(monkeypatch, capsys):
    """Both packages' ``lineage`` entries read one port coordinator:
    the summary text and ``-lineage.raw`` are equal, and the raw records
    are the server's /debug/lineage body."""
    _frozen_clock(monkeypatch)
    P = PKGS["port"]
    coord = tcoord.MeshCoordinator([_wagg_spec(tcoord, twagg)], 1,
                                   heartbeat_timeout=FOREVER)
    server = tmesh.MeshCoordinatorServer(coord, 0).start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        coord.join("a")
        coord.sync("a")
        for i, slot in enumerate((300, 600)):
            coord.submit("a", P.codec.encode({
                "member": "a", "ranges": {0: [5 * i, 5 * i + 5]},
                "watermark": slot + 600,
                "closed": {slot: {"flows_5m": P.codec.wagg_payload(
                    {(7,): np.array([50, 1], np.uint64)})}},
                "open": {}, "final": False, "release": False, "flows": 5,
                "span": {"sub": i + 1, "member": "a", "sent": 1.5,
                         "chunk": i, "windows": [slot]}}))
        texts = {}
        for name, cli in (("port", tcli), ("jax", jcli)):
            for extra in ([], ["-lineage.raw"],
                          ["-lineage.model", "flows_5m", "-lineage.slot",
                           "600"]):
                capsys.readouterr()
                assert cli.main(["lineage", "-mesh.coordinator", base,
                                 *extra]) == 0
                texts[name, tuple(extra)] = capsys.readouterr().out
        body = _get(base + "/debug/lineage")[1]
    finally:
        server.stop()
        coord.close()
    for extra in ((), ("-lineage.raw",),
                  ("-lineage.model", "flows_5m", "-lineage.slot", "600")):
        assert texts["port", extra] == texts["jax", extra], extra
    summary = texts["port", ()].splitlines()
    assert [line for line in summary if not line.startswith(" ")] and \
        sum(" @ " in line for line in summary) == 2
    assert json.loads(texts["port", ("-lineage.raw",)]) == json.loads(body)
    assert "flows_5m @ 600 [merged]" in \
        texts["port", ("-lineage.model", "flows_5m", "-lineage.slot",
                       "600")]


# ---- (e): the /debug/trace fan-out -----------------------------------------


class _FakeTraceEndpoint:
    """A member-shaped /debug/trace endpoint whose clock runs at a given
    skew: what the coordinator's aggregator must align."""

    def __init__(self, skew_s: float, span_name: str = "member_span"):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                now = time.time() + outer.skew
                body = json.dumps({
                    "traceEvents": [{
                        "name": outer.span_name, "ph": "X",
                        "ts": round(now * 1e6, 1), "dur": 100.0,
                        "pid": 77, "tid": "w",
                    }],
                    "otherData": {"mode": "ring", "dropped_spans": 0,
                                  "now": now},
                }).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self.skew = skew_s
        self.span_name = span_name
        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = (f"http://127.0.0.1:{self._server.server_address[1]}"
                    "/debug/trace")
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def stop(self):
        self._server.shutdown()
        self._server.server_close()


def _trace_doc(server):
    status, body = _get(f"http://127.0.0.1:{server.port}/debug/trace")
    assert status == 200
    return json.loads(body)


def _trace_coordinator():
    return tcoord.MeshCoordinator([_wagg_spec(tcoord, twagg)], 1,
                                  heartbeat_timeout=FOREVER)


@pytest.mark.parametrize("case", ["skewed", "heartbeat", "unreachable"])
def test_trace_fan_out(case):
    """skewed: a member clock 120 s ahead is estimated from the fetch's
    round trip and removed; heartbeat: a member's heartbeat clock report
    wins over that estimate; unreachable: a member that cannot be reached
    is left out, and the coordinator's lane still answers."""
    TTRACER.configure("ring")
    c = _trace_coordinator()
    fake = _FakeTraceEndpoint(skew_s={"skewed": 120.0, "heartbeat": 50.0,
                                      "unreachable": 0.0}[case])
    url = fake.url
    if case == "unreachable":
        fake.stop()  # nothing listens there now
    server = tmesh.MeshCoordinatorServer(c, 0).start()
    try:
        c.join("w0", trace_url=url)
        assert c.trace_sources() == [("w0", url, None, 0.0)]
        if case == "heartbeat":
            # member-measured: coordinator - member = -50 s exactly
            c.sync("w0", clock={"offset": -50.0, "rtt": 0.001})
        with TTRACER.span("coord_probe"):
            pass
        doc = _trace_doc(server)
    finally:
        server.stop()
        if case != "unreachable":
            fake.stop()
    lanes = {lane["name"]: lane for lane in doc["otherData"]["lanes"]}
    assert [e for e in doc["traceEvents"] if e["name"] == "coord_probe"]
    if case == "unreachable":
        assert list(lanes) == ["coordinator"]
        return
    assert set(lanes) == {"coordinator", "w0"}
    pids = {e["pid"] for e in doc["traceEvents"]
            if e["name"] == "process_name"}
    assert len(pids) == 2
    if case == "skewed":
        ev = next(e for e in doc["traceEvents"]
                  if e["name"] == "member_span")
        assert abs(ev["ts"] / 1e6 - time.time()) < 30
        assert lanes["w0"]["clock_offset_ms"] == \
            pytest.approx(120_000.0, abs=5_000)
    else:
        assert lanes["w0"]["clock_offset_ms"] == pytest.approx(50_000.0)
        assert lanes["w0"]["rtt_ms"] == pytest.approx(1.0)


def test_trace_fan_out_aligns_like_the_jax_server():
    """The same member trace and heartbeat offset through both packages'
    fan-out: the member lanes and their events are equal."""
    docs = {}
    fake = _FakeTraceEndpoint(skew_s=0.0)
    try:
        for pkg, mesh, coord_mod, wagg in (
                ("port", tmesh, tcoord, twagg),
                ("jax", jmesh, jcoord, jwagg)):
            c = coord_mod.MeshCoordinator([_wagg_spec(coord_mod, wagg)], 1,
                                          heartbeat_timeout=FOREVER)
            c.join("w0", trace_url=fake.url)
            c.sync("w0", clock={"offset": -2.5, "rtt": 0.004})
            server = mesh.MeshCoordinatorServer(c, 0).start()
            try:
                docs[pkg] = _trace_doc(server)
            finally:
                server.stop()
    finally:
        fake.stop()

    def member_part(doc):
        (lane,) = [lane for lane in doc["otherData"]["lanes"]
                   if lane["name"] == "w0"]
        # the fake stamps its wall clock at each fetch: all else is equal
        events = [dict(e, ts=None) for e in doc["traceEvents"]
                  if e["pid"] == lane["pid"]]
        return lane, events

    assert member_part(docs["port"]) == member_part(docs["jax"])
    assert member_part(docs["port"])[0]["clock_offset_ms"] == 2500.0


# ---- (f): the member state endpoint ----------------------------------------


def test_member_state_server_answers_like_the_jax_one():
    cfg = thh.HeavyHitterConfig(key_cols=("proto",), value_cols=("bytes",),
                                width=64, depth=2, capacity=4,
                                batch_size=64)
    table = tcodec.hh_payload(thh.hh_init(cfg, CPU))
    table["table_keys"][1] = (17,)
    table["table_vals"][1] = (12.0, 3.0)
    state = {"slot": 900, "payload": table}
    got = {}
    for pkg, mesh in (("port", tmesh), ("jax", jmesh)):
        server = mesh.MemberStateServer(_StateMember(state), 0).start()
        base = f"http://127.0.0.1:{server.port}"
        try:
            got[pkg] = [_get(base + path) for path in (
                "/meshstate?model=talkers", "/meshstate?model=other",
                "/meshstate", "/nope", "/healthz")]
            assert server.url == f"{base}/meshstate"
        finally:
            server.stop()
    assert got["port"] == got["jax"]
    (s200, body), (s204, _), (s404a, _), (s404b, _), (sok, ok) = got["port"]
    assert (s200, s204, s404a, s404b, sok) == (200, 204, 404, 404, 200)
    assert body == jcodec.encode(state)
    assert json.loads(ok) == {"ok": True}
    back = tcodec.decode(body)
    assert back["slot"] == 900
    np.testing.assert_array_equal(back["payload"]["table_keys"],
                                  table["table_keys"])


# ---- (g): the CLI ----------------------------------------------------------


def test_coordinator_entry_answers_and_stops(tmp_path):
    """``processor -mesh.role coordinator`` as a library call in a
    thread: its protocol server, query API and serving tier answer, and
    when on_start returns every server stops and the journal closes."""
    seen = {}
    release = threading.Event()

    def on_start(coord, services):
        seen["coord"] = coord
        seen["ports"] = {k: services[k].port
                         for k in ("mesh", "query", "serve")}
        seen["publisher"] = services["publisher"]
        release.wait(FOREVER)

    argv = ["-mesh.role", "coordinator", "-device", "cpu",
            "-mesh.listen", "127.0.0.1:0", "-bus.partitions", "3",
            "-mesh.heartbeat", str(FOREVER),
            "-mesh.journal", str(tmp_path / "wal"),
            "-query.addr", "127.0.0.1:0", "-serve.addr", "127.0.0.1:0",
            "-metrics.addr", "", "-sink", f"sqlite:{tmp_path / 'c.db'}",
            "-loglevel", "warning", *FLAGS]
    result = {}
    t = threading.Thread(
        target=lambda: result.setdefault(
            "rc", tcli.run_coordinator(argv, on_start=on_start)),
        name="coordinator-entry", daemon=True)
    t.start()
    deadline = time.monotonic() + FOREVER
    while "ports" not in seen:
        assert t.is_alive() and time.monotonic() < deadline
        time.sleep(0.01)
    ports = seen["ports"]
    mesh_base = f"http://127.0.0.1:{ports['mesh']}"
    status, body = _get(f"{mesh_base}/healthz")
    assert status == 200 and json.loads(body) == {"ok": True, "epoch": 0,
                                                  "members": 0}
    assert json.loads(_get(f"{mesh_base}/state")[1])["partitions"] == 3
    status, body = _post(f"{mesh_base}/mesh/join",
                         json.dumps({"member": "a"}).encode())
    assert status == 200 and json.loads(body)["epoch"] == 1
    status, body = _get(f"http://127.0.0.1:{ports['query']}/healthz")
    assert status == 200 and json.loads(body)["mesh_members"] == 1
    assert _get(f"http://127.0.0.1:{ports['serve']}/healthz")[0] == 200
    assert seen["publisher"].coordinator is seen["coord"]
    assert [s.name for s in seen["coord"].specs] == [
        "flows_5m", "top_talkers", "top_src_ips", "top_dst_ips",
        "top_src_ports", "top_dst_ports"]
    release.set()
    t.join(FOREVER)
    assert result["rc"] == 0
    for port in ports.values():
        with pytest.raises(OSError):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                   timeout=TIMEOUT)
    names = {th.name for th in threading.enumerate()}
    assert not names & {"mesh-http", "mesh-expiry", "serve-publish"}
    # the journal took the join and was closed with its final fsync
    assert (tmp_path / "wal" / "coordinator.journal").stat().st_size > 0


@pytest.mark.parametrize("argv", [
    ["-mesh.role", "member"],
    ["-mesh.role", "member", "-mesh.coordinator", "http://127.0.0.1:9"],
    ["-mesh.role", "bogus"],
], ids=["member-without-coordinator", "member-without-kafka", "bogus-role"])
def test_processor_mesh_roles_exit_2(argv, capsys):
    assert tcli.main(["processor", "-device", "cpu", "-metrics.addr", "",
                      *argv]) == 2
    assert jcli.main(["processor", "-metrics.addr", "", *argv]) == 2
    if argv[-1] == "bogus":
        assert "mesh.role must be coordinator|member" in \
            capsys.readouterr().err


def test_lineage_is_a_command():
    assert "lineage" in tcli._COMMANDS
    assert tcli.main(["lineage", "-bogus"]) == 2


# ---- (h): the member's transport retries -----------------------------------


def test_member_retries_http_transport_exceptions():
    """A coordinator that dies mid-response surfaces as an
    http.client.HTTPException or a json.JSONDecodeError, not an OSError:
    the member retries both, as the reference does."""
    member = tmesh.MeshMember("t", None, None, None)
    calls = []

    def flaky_sync():
        calls.append(1)
        if len(calls) == 1:
            raise http.client.IncompleteRead(b"partial")
        if len(calls) == 2:
            raise json.JSONDecodeError("truncated", "{", 1)
        return {"ok": True}

    assert member._coord_call("sync", flaky_sync) == {"ok": True}
    assert len(calls) == 3
    assert member.m_retries.value(op="sync") >= 2


def test_member_keeps_running_through_a_dead_coordinator_response():
    """The sync path over HTTP: a coordinator that closes the connection
    mid-response costs a retry, never the member's thread."""
    hits = []

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):  # noqa: N802
            n = int(self.headers.get("Content-Length", 0))
            self.rfile.read(n)
            hits.append(self.path)
            if len(hits) <= 2:
                # headers promise a body the coordinator never sends
                self.send_response(200)
                self.send_header("Content-Length", "50")
                self.end_headers()
                self.wfile.write(b'{"act')
                return
            body = json.dumps({"action": "run", "assign": {},
                               "epoch": 1}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        remote = tmesh.RemoteCoordinator(
            f"http://127.0.0.1:{server.server_address[1]}", timeout=TIMEOUT)
        member = tmesh.MeshMember("w0", remote, None, None)
        member._joined = True
        assert member._call_sync()["action"] == "run"
    finally:
        server.shutdown()
        server.server_close()
    assert hits == ["/mesh/sync"] * 3
    assert member.m_retries.value(op="sync") == 2
