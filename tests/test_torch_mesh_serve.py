"""The port's merged serving tier (serve/publisher.py MeshServePublisher,
attach_mesh, the merged-view captures; cli.py ``pipeline -mesh.workers N
-serve.addr``) against the JAX package's, on the CPU (tolerance: none,
bodies and frames byte-equal).

One numpy-seeded Zipf stream (8,192 flows of 200 keys at 40 flows/s,
the reference's mesh stream, key-hash sharded over 2 partitions) feeds a
JAX InProcessMesh and a port InProcessMesh of 2 members. With one
partition per member each member's watermark is its partition's, so a
window merges only once both partitions passed it: the merged flows_5m
rows reach the sinks in the same chunks on every run. (Over more
partitions than members, a member's watermark runs ahead of its slower
partition, and where a window's late partials split depends on thread
timing in both packages; the sums stay exact, tests/test_torch_mesh.py.)
There are two legs: the reference's own mesh model
set (flows_5m and top_talkers, tests/test_gateway.py
TestMeshGatewayParity), and the CLI builders' set with ``-spread.enabled``
(the hh, dense and spread families) over a stream with spreader legs.
Both packages' snapshot modules share one frozen clock, and each mesh's
publisher is attached with ``start=False`` and driven by ``publish_now``,
so equal states give equal snapshots. The same script runs on both:

1. start, wait until idle, publish (v1);
2. kill member w1 (fenced at once), wait until the rebalance settles,
   publish (v2);
3. stop the member threads, publish (v3);
4. finalize (every window closes and merges), publish (v4).

At each version the ``/query/*`` bodies are byte-equal to the JAX mesh's,
``/query/version`` apart from its live ``age_seconds``, and so are the
``/sub/snapshot`` frames (the full frame at v1, the delta v1 -> v2, the
full frame at v2). On the port's first leg the script also holds:

- readers making a fixed number of requests during the churn get no 5xx
  and see versions that never go back;
- at v3 the read path takes neither coordinator lock, and ``/query/topk``
  equals ``coordinator.query_topk`` at that state;
- at v4 ``/query/range`` is the merged flows_5m rows the sinks got;
- a port gateway mirroring the store answers every endpoint byte-equal
  to the mesh's own surface, and a history tier archives the 4 versions
  and replays them byte-identical.

The failure path (``serve.publish`` faults, the failure counter, the
backoff and the rate-limited traceback) runs count-driven, and ``pipeline
-device cpu -mesh.workers 2 -serve.addr`` runs to its end with the JAX
pipeline's merged flows_5m rows. Nothing here waits on a wall clock:
meshes wait for idle rounds, readers make counted requests.
"""

import json
import logging
import sqlite3
import threading
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from flow_pipeline_tpu import cli as jcli
from flow_pipeline_tpu import mesh as jmesh
from flow_pipeline_tpu.engine import WindowedHeavyHitter as JWindowed
from flow_pipeline_tpu.engine import WorkerConfig as JWorkerConfig
from flow_pipeline_tpu.models import HeavyHitterConfig as JHHConfig
from flow_pipeline_tpu.models import WindowAggConfig as JWaggConfig
from flow_pipeline_tpu.models import WindowAggregator as JWagg
from flow_pipeline_tpu.obs import REGISTRY as JREGISTRY
from flow_pipeline_tpu.obs import TRACER as JTRACER
from flow_pipeline_tpu.schema.batch import FlowBatch as JBatch
from flow_pipeline_tpu.serve import ServeServer as JServe
from flow_pipeline_tpu.serve import attach_mesh as jattach
from flow_pipeline_tpu.serve import snapshot as jsnapshot
from flow_pipeline_tpu.transport import InProcessBus as JBus
from flow_pipeline_tpu_torch import cli as tcli
from flow_pipeline_tpu_torch import mesh as tmesh
from flow_pipeline_tpu_torch.engine import WorkerConfig as TWorkerConfig
from flow_pipeline_tpu_torch.engine.windowed import \
    WindowedHeavyHitter as TWindowed
from flow_pipeline_tpu_torch.gateway import delta as tdelta
from flow_pipeline_tpu_torch.gateway.subscriber import \
    SnapshotGateway as TGateway
from flow_pipeline_tpu_torch.gen import FlowGenerator, ZipfProfile
from flow_pipeline_tpu_torch.history import ArchiveReader as TReader
from flow_pipeline_tpu_torch.history import ArchiveWriter as TWriter
from flow_pipeline_tpu_torch.history import HistoryServer as THistory
from flow_pipeline_tpu_torch.models.heavy_hitter import \
    HeavyHitterConfig as THHConfig
from flow_pipeline_tpu_torch.models.window_agg import \
    WindowAggConfig as TWaggConfig
from flow_pipeline_tpu_torch.models.window_agg import \
    WindowAggregator as TWagg
from flow_pipeline_tpu_torch.obs import REGISTRY as TREGISTRY
from flow_pipeline_tpu_torch.obs import TRACER as TTRACER
from flow_pipeline_tpu_torch.serve import MeshServePublisher
from flow_pipeline_tpu_torch.serve import ServeServer as TServe
from flow_pipeline_tpu_torch.serve import attach_mesh as tattach
from flow_pipeline_tpu_torch.serve import snapshot as tsnapshot
from flow_pipeline_tpu_torch.sink.base import rows_to_records
from flow_pipeline_tpu_torch.transport import InProcessBus as TBus
from flow_pipeline_tpu_torch.utils.faults import FAULTS, FaultInjected
from test_torch_mesh import FOREVER, ListSink
from test_torch_serve import _LockProbe
import torch_cpu  # noqa: F401  (one torch thread; see the module)

PARTITIONS = 2
CREATED = 1_700_000_777.25  # the fixed publish clock of both packages
CPU = torch.device("cpu")
TALKER_COLS = ("src_addr", "dst_addr", "src_port", "dst_port", "proto")
# the CLI builders' hh, dense and spread families at small widths
SPREAD_FLAGS = ["-processor.batch", "512", "-sketch.width", "1024",
                "-sketch.capacity", "64", "-sketch.topk", "50",
                "-spread.enabled", "-spread.width", "512",
                "-spread.capacity", "64", "-spread.topk", "32",
                "-model.ddos=false"]
READERS, READS = 4, 12  # churn readers, requests each


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """Fresh metric registries in both packages for each test, and both
    trace rings unpaused afterwards."""
    monkeypatch.setattr(JREGISTRY, "_metrics", {})
    monkeypatch.setattr(TREGISTRY, "_metrics", {})
    yield
    JTRACER.paused = False
    TTRACER.paused = False


def _batches(spread: bool) -> list:
    """The reference's mesh stream (tests/test_gateway.py
    TestMeshGatewayParity): 2,048-flow batches until 8,000 flows."""
    gen = FlowGenerator(ZipfProfile(n_keys=200, alpha=1.3,
                                    spread_fraction=0.05 if spread else 0.0),
                        seed=7, t0=1_700_000_000, rate=40.0)
    out, done = [], 0
    while done < 8000:
        out.append(gen.batch(2048))
        done += 2048
    return out


def _talker_models(pkg):
    """The reference's mesh_models (tests/test_gateway.py:579-589)."""
    if pkg == "port":
        return {
            "flows_5m": TWagg(TWaggConfig(batch_size=512), device=CPU),
            "top_talkers": TWindowed(THHConfig(
                key_cols=TALKER_COLS, batch_size=512, width=1 << 12,
                capacity=128), k=10, device=CPU),
        }
    return {
        "flows_5m": JWagg(JWaggConfig(batch_size=512)),
        "top_talkers": JWindowed(JHHConfig(
            key_cols=TALKER_COLS, batch_size=512, width=1 << 12,
            capacity=128), k=10),
    }


def _spread_models(pkg):
    if pkg == "port":
        vals = tcli._processor_flags(tcli._common_flags(
            tcli.FlagSet("t"))).parse(SPREAD_FLAGS)
        return tcli._build_models(vals, CPU)
    vals = jcli._processor_flags(jcli._common_flags(
        jcli.FlagSet("t"))).parse(SPREAD_FLAGS)
    return jcli._build_models(vals)


def _mesh(pkg, leg, sink):
    batches = _batches(spread=leg == "spread")
    factory = (lambda: _talker_models(pkg)) if leg == "talkers" else \
        (lambda: _spread_models(pkg))
    if pkg == "port":
        bus = TBus()
        bus.create_topic("flows", PARTITIONS)
        for b in batches:
            tmesh.produce_sharded(bus, "flows", b, PARTITIONS)
        return tmesh.InProcessMesh(
            bus, "flows", 2, model_factory=factory,
            config=TWorkerConfig(poll_max=2048, snapshot_every=0),
            sinks=[sink], heartbeat_timeout=FOREVER)
    bus = JBus()
    bus.create_topic("flows", PARTITIONS)
    for b in batches:
        jmesh.produce_sharded(bus, "flows", JBatch(dict(b.columns)),
                              PARTITIONS)
    return jmesh.InProcessMesh(
        bus, "flows", 2, model_factory=factory,
        config=JWorkerConfig(poll_max=2048, snapshot_every=0),
        sinks=[sink], heartbeat_timeout=FOREVER)


def _fetch(port, path):
    """(status, body); an error answer is an answer too."""
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _key(snap, model, row=0):
    """The uint32 key lanes of one ranked row, in key-column order."""
    fam = snap.families[model]
    lanes = []
    for col, arr in fam.rows.items():
        if col in ("valid", "timeslot") or arr.dtype.kind == "f":
            continue
        lanes.extend(np.atleast_1d(arr[row]).astype(np.uint64).tolist())
        if len(lanes) >= fam.key_lanes:
            break
    return ",".join(str(int(x)) for x in lanes[:fam.key_lanes])


def _paths(snap, leg) -> list:
    """The queries asked at every version of a leg."""
    out = ["/query/topk", "/query/topk?model=top_talkers&k=10",
           "/query/topk?model=top_talkers&k=5000", "/query/range",
           "/query/range?model=flows_5m", "/query/audit",
           "/query/audit?model=top_talkers", "/query/topk?model=ghost",
           "/query/estimate?model=top_talkers&key=1,2,3,4,5,6,7,8,9,10,11"]
    fam = snap.families.get("top_talkers")
    if fam is not None and fam.rows["valid"].any():
        out.append("/query/estimate?model=top_talkers&key="
                   + _key(snap, "top_talkers"))
    if leg == "spread":
        out += ["/query/topk?model=top_src_ips&k=20",
                "/query/topk?model=top_dst_ports&k=7",
                "/query/estimate?model=top_src_ips&key=1,2,3,4",
                "/query/spread", "/query/spread?model=portscan&k=3"]
        fam = snap.families.get("superspreaders")
        if fam is not None and fam.rows["valid"].any():
            out.append("/query/spread?model=superspreaders&key="
                       + _key(snap, "superspreaders"))
    return out


def _version_doc(port):
    code, body = _fetch(port, "/query/version")
    assert code == 200
    doc = json.loads(body)
    assert doc.pop("age_seconds") >= 0
    return doc


def _readers(port, out):
    """READERS threads of READS counted requests each; every answer's
    (status, version) lands in ``out[i]``."""
    def read(i):
        for j in range(READS):
            path = "/query/version" if j % 2 == 0 else "/query/topk?k=5"
            code, body = _fetch(port, path)
            version = json.loads(body).get("version") if code == 200 \
                else None
            out[i].append((code, version))

    threads = [threading.Thread(target=read, args=(i,), daemon=True)
               for i in range(READERS)]
    for t in threads:
        t.start()
    return threads


def _drive(pkg, leg, extras: bool):
    """The script of the module docstring on one package's mesh; returns
    what it recorded. ``extras``: the port-only checks (readers, lock
    probe, gateway and history)."""
    sink = ListSink()
    mesh = _mesh(pkg, leg, sink)
    attach, serve_cls = (tattach, TServe) if pkg == "port" else \
        (jattach, JServe)
    pub = attach(mesh.coordinator, refresh=0.2, start=False)
    serve = serve_cls(pub.store, port=0).start()
    rec = types.SimpleNamespace(snaps=[], bodies=[], versions=[],
                                frames={}, sink=sink, pub=pub)
    gw = gws = writer = None
    if extras:
        writer = TWriter(str(extras), keyframe_every=2)
        gw = TGateway([pub.store], poll=60, archive=writer)
        gws = TServe(gw.store, port=0).start()
        gw.serve_on(gws)
        rec.live, rec.mirror = {}, []

    def publish():
        snap = pub.publish_now()
        rec.snaps.append(snap)
        paths = _paths(snap, leg)
        rec.bodies.append({p: _fetch(serve.port, p) for p in paths})
        rec.versions.append(_version_doc(serve.port))
        if extras:
            assert gw.sync_once() in ("full", "delta")
            assert gw.store.current.version == snap.version
            rec.mirror.append(([(p, _fetch(gws.port, p)) for p in paths],
                               _version_doc(gws.port)))
            for p in ("/query/topk", "/query/topk?model=top_talkers&k=10",
                      "/query/range?model=flows_5m", "/query/audit"):
                rec.live[(snap.version, p)] = rec.bodies[-1][p]
        return snap

    done = False
    try:
        mesh.start()
        mesh.wait_idle(timeout=FOREVER)
        v1 = publish().version
        rec.frames["full1"] = _fetch(serve.port, "/sub/snapshot?since=0")
        reads = [[] for _ in range(READERS)]
        threads = _readers(serve.port, reads) if extras else []
        mesh.kill_member(1)
        mesh.wait_idle(timeout=FOREVER)
        publish()
        for t in threads:
            t.join(FOREVER)
        rec.reads = reads
        rec.frames["delta12"] = _fetch(serve.port,
                                       f"/sub/snapshot?since={v1}")
        rec.frames["full2"] = _fetch(serve.port, "/sub/snapshot?since=0")
        # the member threads stop: their heartbeats take the
        # coordinator's lock, and the probe below must see readers only
        mesh._stop.set()
        for t in mesh._threads:
            t.join(FOREVER)
        publish()
        if extras:
            c = mesh.coordinator
            rec.direct = c.query_topk("top_talkers", 10)
            probes = {"_lock": _LockProbe(c._lock),
                      "_merge_lock": _LockProbe(c._merge_lock)}
            c._lock, c._merge_lock = probes["_lock"], probes["_merge_lock"]
            try:
                rec.probed = [_fetch(serve.port, p) for p in (
                    "/query/topk?model=top_talkers&k=10", "/query/range",
                    "/query/version")]
            finally:
                c._lock = probes["_lock"].inner
                c._merge_lock = probes["_merge_lock"].inner
            rec.lock_counts = {k: p.count for k, p in probes.items()}
        mesh.finalize()
        publish()
        done = True
    finally:
        if not done:  # a failed step leaves no member thread running
            mesh._stop.set()
            for m in mesh.members:
                m.kill()
        serve.stop()
        if gws is not None:
            gws.stop()
        if writer is not None:
            writer.close()
    if extras:
        reader = TReader(str(extras))
        hs = THistory(reader, store=gw.store, port=0).start()
        try:
            rec.archived = set(reader.versions())
            rec.replayed = {
                (v, p): _fetch(hs.port, p + ("&" if "?" in p else "?")
                               + f"version={v}")
                for v, p in rec.live}
        finally:
            hs.stop()
    return rec


LEGS = {}


def _leg(name, tmp_path_factory):
    """Both packages' runs of one leg, once per module."""
    if name not in LEGS:
        fake = types.SimpleNamespace(time=lambda: CREATED)
        saved = (jsnapshot.time, tsnapshot.time)
        jsnapshot.time = tsnapshot.time = fake
        extras = tmp_path_factory.mktemp("history") \
            if name == "talkers" else False
        try:
            runs = {"jax": _drive("jax", name, False),
                    "port": _drive("port", name, extras)}
        finally:
            jsnapshot.time, tsnapshot.time = saved
        LEGS[name] = types.SimpleNamespace(name=name, **runs)
    return LEGS[name]


@pytest.fixture(scope="module", params=["talkers", "spread"])
def leg(request, tmp_path_factory):
    return _leg(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def talkers(tmp_path_factory):
    """The port's run of the first leg, with the port-only checks."""
    return _leg("talkers", tmp_path_factory).port


def _assert_arrays_equal(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


def test_merged_snapshots_bit_equal(leg):
    """Every version's merged families and ranges, the churn publish
    included: rows, CMS planes and registers bit-equal."""
    assert [s.version for s in leg.port.snaps] == \
        [s.version for s in leg.jax.snaps] == [1, 2, 3, 4]
    for ts, js in zip(leg.port.snaps, leg.jax.snaps):
        assert (ts.source, ts.watermark, ts.flows_seen, ts.created) == \
            (js.source, js.watermark, js.flows_seen, js.created) == \
            ("mesh", js.watermark, None, CREATED)
        assert list(ts.families) == list(js.families)
        for name, jf in js.families.items():
            tf = ts.families[name]
            assert (tf.kind, tf.window_start, tf.depth, tf.key_lanes,
                    tf.value_cols) == (jf.kind, jf.window_start, jf.depth,
                                       jf.key_lanes, jf.value_cols), name
            assert list(tf.rows) == list(jf.rows), name
            for col in jf.rows:
                _assert_arrays_equal(tf.rows[col], jf.rows[col],
                                     f"v{ts.version} {name}.{col}")
            assert (tf.cms is None) == (jf.cms is None), name
            if jf.cms is not None:
                _assert_arrays_equal(tf.cms.get(), jf.cms.get(), name)
            assert (tf.regs is None) == (jf.regs is None), name
            if jf.regs is not None:
                _assert_arrays_equal(tf.regs, jf.regs, name)
        assert list(ts.ranges) == list(js.ranges) == ["flows_5m"]
        assert ts.audit == js.audit
    first = leg.port.snaps[0]
    expected = {"talkers": {"top_talkers"}, "spread": {
        "top_talkers", "top_src_ips", "top_dst_ips", "top_src_ports",
        "top_dst_ports", "superspreaders", "portscan"}}[leg.name]
    assert set(first.families) == expected
    assert first.families["top_talkers"].rows["valid"].any()
    if leg.name == "spread":
        assert first.families["superspreaders"].rows["valid"].any()
        assert first.families["top_dst_ports"].rows["valid"].any()
    # the churn publish carries a higher version and the same merged rows
    # as the JAX mesh under the same kill (held above at v2)
    assert leg.port.snaps[1].version > leg.port.snaps[0].version


def test_query_bodies_byte_equal(leg):
    for i, (tb, jb) in enumerate(zip(leg.port.bodies, leg.jax.bodies)):
        assert list(tb) == list(jb)
        for path, want in jb.items():
            assert tb[path] == want, (i + 1, path)
        assert tb["/query/topk?model=top_talkers&k=10"][0] == 200
        assert tb["/query/topk?model=ghost"][0] == 400
    # the last version answers /query/range from every closed window
    code, body = leg.port.bodies[-1]["/query/range?model=flows_5m"]
    assert code == 200 and json.loads(body)["rows"]


def test_version_docs_equal_but_age(leg):
    assert leg.port.versions == leg.jax.versions
    for i, doc in enumerate(leg.port.versions):
        assert doc["version"] == i + 1 and doc["source"] == "mesh"
        assert doc["created"] == CREATED


def test_sub_snapshot_frames_byte_equal(leg):
    for kind in ("full1", "delta12", "full2"):
        assert leg.port.frames[kind] == leg.jax.frames[kind], kind
        assert leg.port.frames[kind][0] == 200
    kinds = {k: [f["t"] for f in tdelta.decode_frames(v[1])]
             for k, v in leg.port.frames.items()}
    assert kinds == {"full1": ["full"], "delta12": ["delta"],
                     "full2": ["full"]}
    # the full frame rebuilds the churn snapshot
    state = next(tdelta.decode_frames(leg.port.frames["full2"][1]))["state"]
    rebuilt = tdelta.state_to_snapshot(state)
    snap = leg.port.snaps[1]
    assert rebuilt.version == snap.version == 2
    for name, fam in snap.families.items():
        for col, arr in fam.rows.items():
            _assert_arrays_equal(rebuilt.families[name].rows[col], arr,
                                 f"{name}.{col}")


def test_read_path_takes_no_coordinator_lock(talkers):
    rec = talkers
    assert rec.lock_counts == {"_lock": 0, "_merge_lock": 0}
    (tcode, tbody), (rcode, rbody), (vcode, _) = rec.probed
    assert tcode == rcode == vcode == 200
    doc = json.loads(tbody)
    assert doc["rows"] == rec.direct["rows"] and doc["rows"]
    assert doc["window_start"] == rec.direct["window_start"]


def test_churn_readers_no_5xx_and_monotone_versions(talkers):
    rec = talkers
    assert [len(r) for r in rec.reads] == [READS] * READERS
    for answers in rec.reads:
        assert all(code == 200 for code, _ in answers), answers
        versions = [v for _, v in answers]
        assert versions == sorted(versions) and versions[0] >= 1


def test_range_rows_are_the_merged_sink_rows(talkers):
    rec = talkers
    doc = json.loads(rec.bodies[-1]["/query/range?model=flows_5m"][1])
    want = [r for rows in rec.sink.tables["flows_5m"]
            for r in rows_to_records(rows)]
    key = lambda r: tuple(sorted(r.items()))  # noqa: E731
    assert sorted(doc["rows"], key=key) == sorted(want, key=key)
    assert doc["slots"] == sorted({r["timeslot"] for r in want})


def test_gateway_mirrors_the_merged_surface(talkers):
    rec = talkers
    assert len(rec.mirror) == 4
    for (answers, version), direct, bodies in zip(rec.mirror, rec.versions,
                                                  rec.bodies):
        assert version == direct
        for path, got in answers:
            assert got == bodies[path], path


def test_history_replays_the_merged_versions(talkers):
    rec = talkers
    versions = {v for v, _ in rec.live}
    assert versions == {1, 2, 3, 4} and versions <= rec.archived
    for key, live in sorted(rec.live.items()):
        assert rec.replayed[key] == live, key
        if live[0] == 200:
            assert json.loads(rec.replayed[key][1])["version"] == key[0]


# ---- the failure path -------------------------------------------------------


def _wagg_publisher(**kw):
    cfg = TWaggConfig(key_cols=("src_as",), value_cols=("bytes",),
                      window_seconds=300, scale_col=None, batch_size=256)
    coord = tmesh.MeshCoordinator(
        [tmesh.ModelSpec("flows_5m", "wagg", cfg, 0, 300)], 1)
    return MeshServePublisher(coord, refresh=0.2, err_backoff_base=0.5,
                              err_backoff_max=4.0, err_log_interval=30.0,
                              **kw).attach()


def test_failure_counter_and_backoff_growth():
    from flow_pipeline_tpu.mesh import MeshCoordinator as JCoord
    from flow_pipeline_tpu.mesh import ModelSpec as JSpec
    from flow_pipeline_tpu.serve.publisher import MeshServePublisher as JPub

    pub = _wagg_publisher()
    jpub = JPub(JCoord([JSpec("flows_5m", "wagg", JWaggConfig(
        key_cols=("src_as",), value_cols=("bytes",), window_seconds=300,
        scale_col=None, batch_size=256), 0, 300)], 1), refresh=0.2,
        err_backoff_base=0.5, err_backoff_max=4.0, err_log_interval=30.0)
    before = pub.store.m_publish_failures.value()
    delays, jdelays = [], []
    for p, out in ((pub, delays), (jpub, jdelays)):
        for _ in range(6):
            p._on_publish_error(RuntimeError("member fetch failed"))
            out.append(p._error_backoff())
    assert pub.store.m_publish_failures.value() == before + 6
    assert delays == sorted(delays) == jdelays  # monotone, the reference's
    assert delays[0] == 0.5 and delays[-1] == 4.0  # floored, capped
    pub._fail_streak = 0
    assert pub._error_backoff() == 0.5
    pub.refresh = 2.0  # the floor is the refresh cadence when larger
    assert pub._error_backoff() == 2.0


def test_exception_log_rate_limited():
    records = []

    class Capture(logging.Handler):
        def emit(self, record):
            records.append(record)

    logger = logging.getLogger("flow_pipeline_tpu_torch.serve")
    handler = Capture(level=logging.DEBUG)
    logger.addHandler(handler)
    old_level = logger.level
    logger.setLevel(logging.DEBUG)
    try:
        pub = _wagg_publisher()
        for _ in range(10):
            pub._on_publish_error(RuntimeError("flap"))
    finally:
        logger.removeHandler(handler)
        logger.setLevel(old_level)
    errors = [r for r in records if r.levelno >= logging.ERROR]
    assert len(errors) == 1 and errors[0].exc_info  # one traceback
    assert len(records) == 10  # the other nine at debug
    assert pub.store.m_publish_failures.value() == 10


def test_zero_5xx_under_publish_faults():
    """``serve.publish:p=0.5@seed=3``: a fixed number of publish attempts,
    each followed by counted reads; every read answers 2xx from the
    newest snapshot that did publish."""
    pub = _wagg_publisher()
    coord = pub.coordinator
    coord.sinks[0].write("flows_5m", {
        "timeslot": np.array([1_700_000_100], np.uint64),
        "src_as": np.array([65000], np.uint32),
        "bytes": np.array([7], np.uint64)})
    server = TServe(pub.store, 0).start()
    failed, codes, versions = 0, [], []
    try:
        assert pub.publish_now().version == 1
        FAULTS.configure("serve.publish:p=0.5@seed=3")
        for _ in range(16):
            try:
                pub.publish_now()
            except FaultInjected as e:
                failed += 1
                pub._on_publish_error(e)
            for path in ("/query/version", "/query/range"):
                code, body = _fetch(server.port, path)
                codes.append(code)
                versions.append(json.loads(body)["version"])
    finally:
        FAULTS.configure("")
        server.stop()
    assert 0 < failed < 16
    assert codes == [200] * 32
    assert versions == sorted(versions)
    assert versions[-1] == pub.store.current.version == 1 + 16 - failed
    assert pub.store.m_publish_failures.value() == failed


# ---- the CLI ------------------------------------------------------------------


def _flows5m(db):
    conn = sqlite3.connect(db)
    try:
        return sorted(conn.execute("SELECT * FROM flows_5m").fetchall())
    finally:
        conn.close()


def test_pipeline_mesh_serve_addr_runs_with_the_jax_rows(tmp_path):
    common = ["-mesh.workers", "2", "-produce.count", "3000",
              "-produce.rate", "40", "-produce.profile", "zipf",
              "-produce.seed", "3", "-processor.batch", "1024",
              "-sketch.width", "4096", "-sketch.capacity", "128",
              "-metrics.addr", "", "-mesh.heartbeat", str(FOREVER),
              "-loglevel", "warning"]
    assert jcli.pipeline_main([*common, "-processor.backend", "cpu",
                               "-sink", f"sqlite:{tmp_path / 'j.db'}"]) == 0
    seen = {}

    def on_start(mesh, services):
        seen["services"] = services
        assert services["publisher"].coordinator is mesh.coordinator
        assert mesh.coordinator.serve is services["publisher"]

    def on_finish(mesh, _metrics):
        pub, serve = seen["services"]["publisher"], \
            seen["services"]["serve"]
        snap = pub.publish_now()
        seen["source"], seen["publishes"] = snap.source, pub.publishes
        seen["range"] = _fetch(serve.port, "/query/range?model=flows_5m")

    sink = ListSink()
    mesh = tcli.run_pipeline([*common, "-device", "cpu", "-serve.addr",
                              "127.0.0.1:0", "-serve.refresh", "0.5",
                              "-sink", f"sqlite:{tmp_path / 't.db'}"],
                             sinks=[sink], on_start=on_start,
                             on_finish=on_finish)
    assert isinstance(mesh, tmesh.InProcessMesh)
    assert seen["source"] == "mesh" and seen["publishes"] >= 1
    assert _flows5m(tmp_path / "t.db") == _flows5m(tmp_path / "j.db")
    code, body = seen["range"]
    want = [r for rows in sink.tables["flows_5m"]
            for r in rows_to_records(rows)]
    key = lambda r: tuple(sorted(r.items()))  # noqa: E731
    assert code == 200
    assert sorted(json.loads(body)["rows"], key=key) == sorted(want, key=key)
    assert not seen["services"]["publisher"]._thread.is_alive()
