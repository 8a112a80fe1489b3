"""The port's serving tier (serve/, gateway/{delta,feed}.py, mesh/codec.py)
against the JAX package's, on the CPU (tolerance: none).

One seeded Zipf frames file (3,000 flows at 5 flows/s with spreader legs:
two 5-minute windows close mid-stream) runs through a JAX worker and a
port worker built by each package's CLI builders at small widths (sketch
width 1,024, capacity 64, the spread detectors on, DDoS off), each with
its package's WorkerServePublisher (window-close publishes only) under a
fixed publish clock, so equal states give equal snapshots. Half the
batches, a subscription poll, the rest, one more publish at the exact
consumed point. Then:

- the snapshots are bit-equal: versions, watermarks, ranges, and per
  family the rows, ``window_start``, ``depth``, key lanes and the frozen
  uint64 CMS planes (spread: the u8 registers);
- the JSON bodies and ETags of ``/query/{topk,estimate,spread,range,
  audit}`` and ``/healthz`` are byte-equal to the JAX ServeServer's for
  the same queries, and so are the error answers (400, 404);
  ``/query/version`` is equal apart from its live ``age_seconds`` and
  ``created``;
- ``/sub/snapshot`` frames (the ``since=0`` full frame at the first
  poll, the delta after it, the none frame) are byte-equal, and a full
  frame rebuilds the snapshot through ``state_to_snapshot``;
- ETag revalidation answers 304, 503 before the first publish, an
  admission shed answers 503 counted in ``guard_shed_total``;
- the query API's ``/topk`` answers from a fresh snapshot without the
  worker's lock, equal to its locked answer, and falls back to the lock
  when the snapshot is stale;
- the mesh codec's envelopes and model payloads equal the reference's,
  the range ledger and the load generator's summaries behave alike.
"""

import http.client
import json
import threading
import types
import urllib.request

import numpy as np
import pytest
import torch

from flow_pipeline_tpu import cli as jcli
from flow_pipeline_tpu.engine import StreamWorker as JWorker
from flow_pipeline_tpu.engine.query_api import QueryServer as JQuery
from flow_pipeline_tpu.gateway import delta as jdelta
from flow_pipeline_tpu.mesh import codec as jcodec
from flow_pipeline_tpu.serve import RangeLedger as JLedger
from flow_pipeline_tpu.serve import ServeServer as JServe
from flow_pipeline_tpu.serve import attach_worker as jattach
from flow_pipeline_tpu.serve import loadgen as jloadgen
from flow_pipeline_tpu.serve import snapshot as jsnapshot
from flow_pipeline_tpu.transport import Consumer as JConsumer
from flow_pipeline_tpu_torch import cli as tcli
from flow_pipeline_tpu_torch.engine import StreamWorker as TWorker
from flow_pipeline_tpu_torch.engine.query_api import QueryServer as TQuery
from flow_pipeline_tpu_torch.gateway import delta as tdelta
from flow_pipeline_tpu_torch.hostsketch.engine import np_cms_query_u64
from flow_pipeline_tpu_torch.mesh import codec as tcodec
from flow_pipeline_tpu_torch.obs.metrics import REGISTRY
from flow_pipeline_tpu_torch.serve import RangeLedger as TLedger
from flow_pipeline_tpu_torch.serve import ServeServer as TServe
from flow_pipeline_tpu_torch.serve import SnapshotStore as TStore
from flow_pipeline_tpu_torch.serve import attach_worker as tattach
from flow_pipeline_tpu_torch.serve import loadgen as tloadgen
from flow_pipeline_tpu_torch.serve import snapshot as tsnapshot
from flow_pipeline_tpu_torch.transport import Consumer as TConsumer
import torch_cpu  # noqa: F401  (one torch thread; see the module)

FLAGS = ["-processor.batch", "512", "-sketch.width", "1024",
         "-sketch.capacity", "64", "-sketch.topk", "50", "-spread.enabled",
         "-spread.width", "512", "-spread.capacity", "64", "-spread.topk",
         "32", "-model.ddos=false", "-feed.prefetch", "0", "-ingest.mode",
         "serial", "-flush.count", "0", "-metrics.addr", "", "-sink", ""]
CREATED = 1_700_000_777.25  # the fixed publish clock of both packages
HALF = 4  # batches before the first subscription poll


class _Rows:
    """A sink keeping every row set it is given."""

    def __init__(self):
        self.tables = {}

    def write(self, table, rows):
        self.tables.setdefault(table, []).append(rows)


def _fixed_clock():
    """Both snapshot modules' ``time`` with a constant wall clock."""
    fake = types.SimpleNamespace(time=lambda: CREATED)
    saved = (jsnapshot.time, tsnapshot.time)
    jsnapshot.time = tsnapshot.time = fake
    return saved


def _workers(frames):
    args = ["-in", str(frames), *FLAGS]
    jvals = jcli._processor_flags(jcli._common_flags(
        jcli.FlagSet("processor"))).parse([*args, "-processor.backend",
                                           "cpu"])
    jbus = jcli._load_frames_bus(jvals["in"], jvals["kafka.topic"])
    jsink = _Rows()
    jworker = JWorker(JConsumer(jbus, jvals["kafka.topic"], fixedlen=True),
                      jcli._build_models(jvals), [jsink],
                      jcli._worker_config(jvals))
    tvals = tcli._processor_flags(tcli._common_flags(
        tcli.FlagSet("processor"))).parse(["-device", "cpu", *args])
    tbus = tcli._load_frames_bus(tvals["in"], tvals["kafka.topic"])
    tsink = _Rows()
    tworker = TWorker(TConsumer(tbus, tvals["kafka.topic"]),
                      tcli._build_models(tvals, torch.device("cpu")),
                      [tsink], poll_max=tvals["processor.batch"],
                      prefetch=0, snapshot_every=0,
                      **tcli._ingest_kwargs(tvals))
    return (jworker, jsink), (tworker, tsink)


def _get(port, path, headers=None):
    """(status, headers, body bytes) of one GET."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    frames = tmp_path_factory.mktemp("serve") / "frames.bin"
    assert tcli.main(["mocker", "-out", str(frames), "-produce.profile",
                      "zipf", "-zipf.spread", "0.05", "-produce.count",
                      "3000", "-produce.rate", "5", "-produce.seed",
                      "11"]) == 0
    (jw, jsink), (tw, tsink) = _workers(frames)
    assert type(jw.fused).__name__ == type(tw.fused).__name__ == \
        "HostGroupPipeline"
    saved = _fixed_clock()
    servers = []
    try:
        jpub, tpub = jattach(jw, refresh=0.0), tattach(tw, refresh=0.0)
        for w in (jw, tw):
            for _ in range(HALF):
                assert w.run_once()
        jserve, tserve = JServe(jpub.store, port=0).start(), \
            TServe(tpub.store, port=0).start()
        servers += [jserve, tserve]
        first = [_get(s.port, "/sub/snapshot?since=0") for s in servers]
        v1 = tpub.store.current.version
        for w in (jw, tw):
            while w.run_once():
                pass
        for w, pub in ((jw, jpub), (tw, tpub)):
            with w.lock:
                pub.publish(w)
        frames_after = [(_get(s.port, f"/sub/snapshot?since={v1}"),
                         _get(s.port, "/sub/snapshot?since=0"))
                        for s in servers]
    finally:
        jsnapshot.time, tsnapshot.time = saved
    jq = JQuery(jw, port=0, serve=jpub.store).start()
    tq = TQuery(tw, port=0, serve=tpub.store).start()
    servers += [jq, tq]
    yield types.SimpleNamespace(
        jw=jw, tw=tw, jpub=jpub, tpub=tpub, jsink=jsink, tsink=tsink,
        jserve=jserve, tserve=tserve, jq=jq, tq=tq, v1=v1, first=first,
        after=frames_after)
    for s in servers:
        s.stop()


def _assert_arrays_equal(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


def test_snapshots_bit_equal(served):
    js, ts = served.jpub.store.current, served.tpub.store.current
    assert ts.version == js.version >= 4  # first batch, closes, publish
    assert (ts.watermark, ts.flows_seen, ts.source, ts.created) == \
        (js.watermark, js.flows_seen, js.source, js.created)
    assert ts.flows_seen == 3000
    assert list(ts.families) == list(js.families) == [
        "top_talkers", "top_src_ips", "top_dst_ips", "top_src_ports",
        "top_dst_ports", "superspreaders", "portscan"]
    for name, jf in js.families.items():
        tf = ts.families[name]
        assert (tf.kind, tf.window_start, tf.depth, tf.key_lanes,
                tf.value_cols) == (jf.kind, jf.window_start, jf.depth,
                                   jf.key_lanes, jf.value_cols), name
        assert list(tf.rows) == list(jf.rows), name
        for col in jf.rows:
            _assert_arrays_equal(tf.rows[col], jf.rows[col], f"{name}.{col}")
        assert (tf.cms is None) == (jf.cms is None), name
        if jf.cms is not None:
            _assert_arrays_equal(tf.cms.get(), jf.cms.get(), f"{name}.cms")
            assert tf.cms.get().dtype == np.uint64
        assert (tf.regs is None) == (jf.regs is None), name
        if jf.regs is not None:
            _assert_arrays_equal(tf.regs, jf.regs, f"{name}.regs")
    assert list(ts.ranges) == list(js.ranges) == ["flows_5m"]
    assert len(ts.ranges["flows_5m"]) == len(js.ranges["flows_5m"]) >= 2
    for (tslot, trows), (jslot, jrows) in zip(ts.ranges["flows_5m"],
                                              js.ranges["flows_5m"]):
        assert tslot == jslot and list(trows) == list(jrows)
        for col in jrows:
            _assert_arrays_equal(trows[col], jrows[col], f"range.{col}")
    assert ts.audit == js.audit and ts.audit  # the audit reports ride


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
    assert len(lanes) == fam.key_lanes
    return ",".join(str(int(x)) for x in lanes)


QUERIES = {
    "topk": lambda s: "/query/topk",
    "topk-k5": lambda s: "/query/topk?k=5",
    "topk-ips": lambda s: "/query/topk?model=top_src_ips&k=20",
    "topk-dense": lambda s: "/query/topk?model=top_dst_ports&k=7",
    "topk-deep": lambda s: "/query/topk?model=top_talkers&k=5000",
    "estimate-talker": lambda s: "/query/estimate?key=" + _key(
        s, "top_talkers"),
    "estimate-ip": lambda s: "/query/estimate?model=top_dst_ips&key="
    + _key(s, "top_dst_ips", 3),
    "estimate-absent": lambda s: "/query/estimate?model=top_src_ips"
    "&key=1,2,3,4",
    "spread": lambda s: "/query/spread",
    "spread-k": lambda s: "/query/spread?model=portscan&k=3",
    "spread-key": lambda s: "/query/spread?model=superspreaders&key="
    + _key(s, "superspreaders"),
    "range": lambda s: "/query/range",
    "range-slot": lambda s: "/query/range?model=flows_5m&from={0}&to={1}"
    .format(s.ranges["flows_5m"][-1][0], s.ranges["flows_5m"][-1][0] + 300),
    "audit": lambda s: "/query/audit",
    "audit-model": lambda s: "/query/audit?model=top_talkers",
    "healthz": lambda s: "/healthz",
    # errors answer the reference's status and body too
    "unknown-path": lambda s: "/query/nope",
    "bad-k": lambda s: "/query/topk?k=abc",
    "negative-k": lambda s: "/query/topk?k=-1",
    "ghost-model": lambda s: "/query/topk?model=ghost",
    "short-key": lambda s: "/query/estimate?key=1",
    "no-key": lambda s: "/query/estimate",
    "lane-range": lambda s: "/query/estimate?model=top_src_ips"
    "&key=4294967296,0,0,1",
    "dense-estimate": lambda s: "/query/estimate?model=top_src_ports&key=1",
    "hh-as-spread": lambda s: "/query/spread?model=top_talkers",
    "ghost-range": lambda s: "/query/range?model=ghost",
    "bad-from": lambda s: "/query/range?from=abc",
    "ghost-audit": lambda s: "/query/audit?model=ghost",
}


@pytest.mark.parametrize("case", sorted(QUERIES))
def test_query_bodies_byte_equal(served, case):
    path = QUERIES[case](served.tpub.store.current)
    jcode, jhead, jbody = _get(served.jserve.port, path)
    tcode, thead, tbody = _get(served.tserve.port, path)
    assert (tcode, tbody) == (jcode, jbody), path
    assert thead.get("ETag") == jhead.get("ETag")
    if case.startswith(("topk", "estimate", "spread", "range", "audit")):
        assert tcode == 200 and json.loads(tbody), path
    elif case != "healthz":
        assert tcode in (400, 404), path


def test_version_equal_but_live_fields(served):
    docs = [json.loads(_get(s.port, "/query/version")[2])
            for s in (served.jserve, served.tserve)]
    for doc in docs:
        assert doc.pop("age_seconds") >= 0 and doc.pop("created") == CREATED
    assert docs[1] == docs[0]
    assert docs[1]["flows_seen"] == 3000 and docs[1]["ranges"]["flows_5m"]


def test_sub_snapshot_frames_byte_equal(served):
    (jfirst, tfirst), after = served.first, served.after
    assert tfirst == jfirst and tfirst[0] == 200
    assert tfirst[1]["ETag"] == f'"sub-v{served.v1}"'
    (jdelta_, jfull), (tdelta_, tfull) = after
    assert tdelta_ == jdelta_ and tfull == jfull
    kinds = [f["t"] for f in tdelta.decode_frames(tdelta_[2])]
    assert kinds == ["delta"]
    assert [f["t"] for f in tdelta.decode_frames(tfull[2])] == ["full"]
    # an already-current subscriber: the none frame, or 304 on its ETag
    cur = served.tpub.store.current.version
    for s in (served.jserve, served.tserve):
        code, head, body = _get(s.port, f"/sub/snapshot?since={cur}")
        assert code == 200 and [f["t"] for f in tdelta.decode_frames(
            body)] == ["none"]
        assert _get(s.port, f"/sub/snapshot?since={cur}",
                    {"If-None-Match": head["ETag"]})[0] == 304
    # the full frame rebuilds the served snapshot, answer for answer
    state = next(tdelta.decode_frames(tfull[2]))["state"]
    rebuilt = tdelta.state_to_snapshot(state)
    assert rebuilt.version == cur
    jstate = next(jdelta.decode_frames(jfull[2]))["state"]
    first = next(tdelta.decode_frames(tfirst[2]))["state"]
    for name, fam in served.tpub.store.current.families.items():
        got = rebuilt.families[name]
        for col, arr in fam.rows.items():
            _assert_arrays_equal(got.rows[col], arr, f"{name}.{col}")
        if fam.cms is not None:
            _assert_arrays_equal(got.cms.get(), fam.cms.get(), name)
            _assert_arrays_equal(jstate["families"][name]["cms"],
                                 fam.cms.get(), name)
    # the delta applied (by the reference's subscriber side) to the first
    # full state gives the second full frame
    applied = jdelta.apply_delta(first, next(tdelta.decode_frames(
        tdelta_[2])))
    assert tdelta.encode_full(applied) == tfull[2]


def test_etag_304_and_cache_hits(served):
    store = served.tpub.store
    hits = store.m_cache_hits.value()
    code, head, body = _get(served.tserve.port, "/query/topk?k=4")
    again = _get(served.tserve.port, "/query/topk?k=4")
    assert code == again[0] == 200 and again[2] == body
    assert again[1]["ETag"] == head["ETag"]
    assert store.m_cache_hits.value() > hits
    code, _, empty = _get(served.tserve.port, "/query/topk?k=4",
                          {"If-None-Match": head["ETag"]})
    assert (code, empty) == (304, b"")
    assert store.m_responses.value(code="304") >= 1


def test_503_before_first_publish_and_admission_shed():
    store = TStore()
    serve = TServe(store, port=0, max_inflight=1, deadline=0.01).start()
    shed = REGISTRY.counter("guard_shed_total", "")
    try:
        code, _, body = _get(serve.port, "/query/topk")
        assert code == 503 and b"no snapshot" in body
        health = json.loads(_get(serve.port, "/healthz")[2])
        assert health == {"ok": True, "version": 0, "degraded": False}
        before = shed.value(stage="serve", reason="queue_full")
        assert serve._sem.acquire(timeout=1)  # the one slot, held
        try:
            code, head, body = _get(serve.port, "/query/topk")
            # liveness bypasses admission
            assert _get(serve.port, "/healthz")[0] == 200
        finally:
            serve._sem.release()
        assert code == 503 and head["Retry-After"] == "1"
        assert json.loads(body) == {"error": "overloaded, retry"}
        assert shed.value(stage="serve", reason="queue_full") == before + 1
        with pytest.raises(ValueError):
            TServe(store, port=0, deadline=-1.0)
    finally:
        serve.stop()


class _LockProbe:
    """A lock wrapper counting acquisitions."""

    def __init__(self, inner):
        self.inner, self.count = inner, 0

    def __enter__(self):
        self.count += 1
        return self.inner.__enter__()

    def __exit__(self, *a):
        return self.inner.__exit__(*a)


def test_query_api_topk_from_fresh_snapshot(served):
    tw = served.tw
    probe = _LockProbe(tw.lock)
    tw.lock = probe
    try:
        fresh = _get(served.tq.port, "/topk?k=5")[2]
        assert probe.count == 0  # answered off the snapshot
        for path in ("/topk?k=5", "/topk?model=top_dst_ports&k=9"):
            assert _get(served.tq.port, path)[2] == \
                _get(served.jq.port, path)[2], path
        tw.flows_seen += 1  # progress no snapshot covers: the lock serves
        stale = _get(served.tq.port, "/topk?k=5")[2]
        assert probe.count == 1
        deep = json.loads(_get(served.tq.port, "/topk?k=60")[2])
        assert probe.count == 2 and len(deep["rows"]) == 60
    finally:
        tw.flows_seen -= 1
        tw.lock = probe.inner
    assert stale == fresh  # the locked answer equals the snapshot's
    with tw.lock:
        tw.sync_sketch_states()
        want = tw.models["top_talkers"].model.top(5)
    doc = json.loads(fresh)
    assert doc["model"] == "top_talkers" and len(doc["rows"]) == 5
    assert [r["bytes"] for r in doc["rows"]] == want["bytes"][:5].tolist()


def test_range_rows_are_the_sinks_rows(served):
    doc = json.loads(_get(served.tserve.port, "/query/range")[2])
    given = {}
    for rows in served.tsink.tables["flows_5m"]:
        for slot in np.unique(rows["timeslot"]):
            idx = np.flatnonzero(rows["timeslot"] == slot)
            given.setdefault(int(slot), []).append(
                {k: v[idx] for k, v in rows.items()})
    assert doc["slots"] == sorted(given)
    from flow_pipeline_tpu_torch.sink.base import rows_to_records

    want = [r for slot in doc["slots"] for chunk in given[slot]
            for r in rows_to_records(chunk)]
    assert doc["rows"] == json.loads(json.dumps(want, default=str))


def test_estimate_is_the_frozen_cms_query(served):
    snap = served.tpub.store.current
    fam = snap.families["top_src_ips"]
    key = _key(snap, "top_src_ips", 1)
    doc = json.loads(_get(served.tserve.port,
                          f"/query/estimate?model=top_src_ips&key={key}")[2])
    lanes = np.asarray([[int(x) for x in key.split(",")]], np.uint32)
    want = np_cms_query_u64(fam.cms.get(), lanes)[0]
    assert list(doc["estimates"].values()) == [int(x) for x in want]
    assert doc["estimates"]["bytes"] >= int(fam.rows["bytes"][1])


def test_publisher_counts_and_window_close_publishes(served):
    pub = served.tpub
    assert pub.publishes == pub.store.current.version == \
        served.jpub.store.current.version
    assert pub.publish_seconds >= pub.capture_seconds > 0
    fam = pub.store.current.families["top_talkers"]
    # the capture is a host copy of the planes, released at the freeze
    assert fam.cms._thunk is None and fam.cms.get().dtype == np.uint64


def test_codec_envelopes_and_payloads_equal_reference(served):
    tree = {"a": np.arange(5, dtype=np.uint64), "b": [1, 2.5, None, "x"],
            "c": (np.zeros((2, 3), np.uint32), {"d": True})}
    assert tcodec.encode(tree) == jcodec.encode(tree)
    back = tcodec.decode(tcodec.encode(tree))
    _assert_arrays_equal(back["a"], tree["a"], "a")
    assert back["b"] == [1, 2.5, None, "x"]
    for name in ("top_talkers", "top_src_ips", "top_dst_ports",
                 "superspreaders"):
        got = tcodec.capture_model(served.tw.models[name].model)
        want = jcodec.capture_model(served.jw.models[name].model)
        assert tcodec.encode(got) == jcodec.encode(want), name
    with pytest.raises(ValueError):
        tcodec.decode(b"nope")
    with pytest.raises(TypeError):
        tcodec.capture_model(object())


def test_range_ledger_matches_reference():
    def rows(slots, vals):
        return {"timeslot": np.asarray(slots, np.uint64),
                "bytes": np.asarray(vals, np.uint64)}

    frozen = []
    for cls in (JLedger, TLedger):
        led = cls(["flows_5m"], max_slots=2)
        led.write("flows_5m", rows([100, 100, 400], [1, 2, 3]))
        led.write("flows_5m", rows([400], [4]))  # a late partial
        led.write("top_talkers", rows([100], [9]))  # not a range table
        led.write("flows_5m", rows([700], [5]))  # evicts slot 100
        frozen.append((led.generation, led.freeze()))
    (jgen, jf), (tgen, tf) = frozen
    assert tgen == jgen == 3
    assert [s for s, _ in tf["flows_5m"]] == [400, 700]
    for (ts, trows), (js, jrows) in zip(tf["flows_5m"], jf["flows_5m"]):
        assert ts == js and trows["bytes"].tolist() == \
            jrows["bytes"].tolist()


def test_loadgen_against_the_live_server(served):
    port = served.tserve.port
    assert tloadgen.wait_ready("127.0.0.1", port, timeout=5)
    stop = threading.Event()
    sampler, ages = tloadgen.sample_ages("127.0.0.1", port, stop,
                                         interval=0.02)
    stats = tloadgen.run_load("127.0.0.1", port, threads=2, duration=0.3)
    stop.set()
    sampler.join(timeout=5)
    assert stats["requests"] > 0 and stats["errors"] == 0
    assert set(stats["codes"]) == {"200"}
    assert stats["p99_ms"] >= stats["p50_ms"] > 0 and ages
    procs = tloadgen.run_load_procs("127.0.0.1", port, procs=1, threads=1,
                                    duration=0.2,
                                    endpoints=("/query/version",))
    assert procs["requests"] > 0 and set(procs["codes"]) == {"200"}
    parts = [stats, procs, {}]
    assert tloadgen.merge_stats(parts) == jloadgen.merge_stats(parts)
    assert tloadgen.merge_stats([]) == jloadgen.merge_stats([])
    # the reader subprocess loads the port's file, not the reference's
    assert tloadgen.__file__.endswith("flow_pipeline_tpu_torch/serve/"
                                      "loadgen.py")


def test_serve_flags_wire_the_cli(tmp_path):
    """-serve.addr on a processor: the publisher rides the worker, the
    query API gets its store, the server answers from on_start and the
    shutdown order stops it; a refused address is an error."""
    frames = tmp_path / "f.bin"
    assert tcli.main(["mocker", "-out", str(frames), "-produce.count",
                      "600", "-produce.rate", "100"]) == 0
    seen = {}

    def on_start(worker, services):
        seen["serve"] = services["serve"]
        seen["code"] = _get(services["serve"].port, "/query/topk")[0]
        assert services["query"].serve is services["publisher"].store

    worker = tcli.run_processor(
        ["-device", "cpu", "-in", str(frames), *FLAGS[:8],
         "-metrics.addr", "", "-sink", "", "-serve.addr", "127.0.0.1:0",
         "-query.addr", "127.0.0.1:0", "-serve.refresh", "0",
         "-guard.serve_queue", "4", "-serve.feed_bytes", "1048576"],
        on_start=on_start)
    assert seen["code"] == 503  # nothing published before the first poll
    assert worker.serve.store.current.flows_seen == 600
    assert seen["serve"].feed_bytes == 1 << 20
    assert seen["serve"]._sem is not None
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{seen['serve'].port}"
                               "/healthz", timeout=2)
    assert tcli.main(["processor", "-device", "cpu", "-in", str(frames),
                      "-serve.addr", "127.0.0.1:x", "-metrics.addr", "",
                      "-sink", ""]) == 2


def test_snapshot_survives_in_place_updates():
    """The capture is a copy: the CPU's plain CMS update writes the
    planes in place as the card's kernel does (tests/test_torch_gpu.py
    runs the same check on the card)."""
    from test_torch_gpu import snapshot_estimate_held

    assert snapshot_estimate_held("cpu") == 0  # no kernel on the CPU
