"""The port's history tier (flow_pipeline_tpu_torch/history/, the
``history`` entry and ``gateway -history.dir``) against the JAX
package's, on the CPU (tolerance: none).

The state sequence is test_torch_gateway.py's: the canonical states of
the snapshots a port worker publishes after each batch of a seeded Zipf
stream with spreader legs (two windows close mid-stream). Then:

- both packages' ArchiveWriters, given the same transitions (keyframe
  every 3, a restart in the middle, and once a byte bound that evicts
  whole segments), write byte-equal segment files;
- each package's ArchiveReader rebuilds every version of the other's
  archive equal to the published state, and both agree on the index
  (versions, ``version_at``, slots, stats) and on the gaps;
- HistoryServer bodies (``/query/*?version=``, ``?at=``, the deep
  ``/query/range``, ``/history/index``, the 404 of an unarchived version)
  are byte-equal to the reference's;
- the subscription writer archives an upstream served over HTTP into the
  same bytes in both packages;
- the ``history`` entry exits 2 without an upstream, as the reference's
  does; run in process (and ``gateway -history.dir``) it archives a live
  upstream and answers time travel.

Every server binds 127.0.0.1:0, polls run at 0.02 s, and every thread a
test starts is stopped in a ``finally``.
"""

import json
import os
import time
import types

import pytest

from flow_pipeline_tpu import cli as jcli
from flow_pipeline_tpu.gateway import delta as jdelta
from flow_pipeline_tpu.history import ArchiveReader as JReader
from flow_pipeline_tpu.history import ArchiveWriter as JWriter
from flow_pipeline_tpu.history import HistoryServer as JHistory
from flow_pipeline_tpu.obs import REGISTRY as JREGISTRY
from flow_pipeline_tpu.serve import ServeServer as JServe
from flow_pipeline_tpu.serve import SnapshotStore as JStore
from flow_pipeline_tpu_torch import cli as tcli
from flow_pipeline_tpu_torch.gateway import delta as tdelta
from flow_pipeline_tpu_torch.history import ArchiveReader as TReader
from flow_pipeline_tpu_torch.history import ArchiveWriter as TWriter
from flow_pipeline_tpu_torch.history import HistoryGapError
from flow_pipeline_tpu_torch.history import HistoryServer as THistory
from flow_pipeline_tpu_torch.obs import REGISTRY as TREGISTRY
from flow_pipeline_tpu_torch.serve import ServeServer as TServe
from flow_pipeline_tpu_torch.serve import SnapshotStore as TStore

from test_torch_gateway import POLL, _get, assert_states_equal, port_states
import torch_cpu  # noqa: F401  (one torch thread; see the module)


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """Fresh metric registries in both packages for each test (other
    tests in the process read process totals)."""
    monkeypatch.setattr(JREGISTRY, "_metrics", {})
    monkeypatch.setattr(TREGISTRY, "_metrics", {})


@pytest.fixture(scope="module")
def states(tmp_path_factory):
    out = port_states(tmp_path_factory.mktemp("history"))
    assert len(out) >= 6
    return out


def _archive(writer_cls, dir_, states, restart_at=None, **kw):
    """Record the transitions, one commit each; with ``restart_at`` the
    writer is closed there and a new one continues (a restart)."""
    writer = writer_cls(str(dir_), keyframe_every=3, **kw)
    prev = None
    for i, state in enumerate(states):
        if i == restart_at:
            writer.close()
            writer = writer_cls(str(dir_), keyframe_every=3, **kw)
        writer.record(prev, state)
        writer.commit()
        prev = state
    writer.close()


def _files(dir_):
    return {name: (dir_ / name).read_bytes()
            for name in sorted(os.listdir(dir_))}


@pytest.mark.parametrize("kw", [dict(restart_at=4), dict(
    retain_bytes=1)], ids=["restart", "evicting"])
def test_segments_byte_equal_and_cross_read(states, tmp_path, kw):
    tdir, jdir = tmp_path / "t", tmp_path / "j"
    _archive(TWriter, tdir, states, **kw)
    _archive(JWriter, jdir, states, **kw)
    files = _files(tdir)
    assert files == _files(jdir) and len(files) >= 2 - ("retain_bytes" in kw)
    for reader_cls, dir_ in ((TReader, jdir), (JReader, tdir),
                             (TReader, tdir)):
        reader = reader_cls(str(dir_))
        versions = reader.versions()
        assert versions == [s["version"] for s in states
                            if s["version"] in versions]
        by_version = {s["version"]: s for s in states}
        for v in versions:
            assert_states_equal(reader.reconstruct(v), by_version[v])
    treader, jreader = TReader(str(tdir)), JReader(str(jdir))
    assert treader.versions() == jreader.versions()
    assert treader.stats() == jreader.stats()
    assert treader.slot_index() == jreader.slot_index()
    for s in states:
        assert treader.version_at(s["created"]) == \
            jreader.version_at(s["created"])
        assert treader.nearest(s["version"]) == jreader.nearest(s["version"])
    if "retain_bytes" in kw:
        with pytest.raises(HistoryGapError) as e:
            treader.reconstruct(states[0]["version"])
        assert e.value.after == treader.versions()[0]


def _history_pair(tmp_path, states):
    """Both packages' archives of ``states`` behind their HistoryServers,
    each with the newest state as its live head."""
    out = []
    for tag, writer_cls, reader_cls, server_cls, store_cls, delta in (
            ("t", TWriter, TReader, THistory, TStore, tdelta),
            ("j", JWriter, JReader, JHistory, JStore, jdelta)):
        _archive(writer_cls, tmp_path / tag, states)
        store = store_cls()
        store.publish_snapshot(delta.state_to_snapshot(states[-1]))
        out.append(server_cls(reader_cls(str(tmp_path / tag)), store=store,
                              port=0).start())
    return out


def test_history_server_bodies_equal_reference(states, tmp_path):
    tsrv, jsrv = _history_pair(tmp_path, states)
    try:
        last = states[-1]["version"]
        paths = ["/history/index", "/query/range", "/query/topk",
                 "/query/range?model=flows_5m&from=0",
                 f"/query/topk?version={last + 50}",
                 "/query/topk?at=1", "/query/topk?version=abc"]
        for s in states:
            v = s["version"]
            paths += [f"/query/topk?version={v}",
                      f"/query/topk?model=top_dst_ips&k=5&version={v}",
                      f"/query/spread?model=superspreaders&version={v}",
                      f"/query/audit?version={v}",
                      f"/query/topk?k=3&at={s['created']}",
                      f"/query/estimate?model=top_src_ips&key=1,2,3,4"
                      f"&version={v}"]
        codes = set()
        for path in paths:
            got = _get(tsrv.port, path)
            assert got == _get(jsrv.port, path), path
            codes.add(got[0])
        assert codes == {200, 400, 404}
        # the archived answer at a version is what the live path served
        live = TServe(TStore(), port=0)
        live.store.publish_snapshot(tdelta.state_to_snapshot(states[2]))
        live.start()
        try:
            v = states[2]["version"]
            assert _get(tsrv.port, f"/query/topk?k=7&version={v}")[2] == \
                _get(live.port, "/query/topk?k=7")[2]
        finally:
            live.stop()
        _, _, index = _get(tsrv.port, "/history/index")
        doc = json.loads(index)
        assert doc["versions"] == len(states) and doc["live_version"] == last
        _, _, body = _get(tsrv.port, "/query/range")
        assert json.loads(body)["slots"]
    finally:
        tsrv.stop()
        jsrv.stop()


def test_subscription_writer_equals_reference(states, tmp_path):
    """ArchiveWriter subscribed over HTTP (the ``history`` tier's mode):
    both packages archive the same upstream states into byte-equal
    segments, one sync per publish, two publishes per sync once."""
    results = {}
    for tag, store_cls, serve_cls, writer_cls, delta in (
            ("t", TStore, TServe, TWriter, tdelta),
            ("j", JStore, JServe, JWriter, jdelta)):
        store = store_cls()
        up = serve_cls(store, port=0).start()
        writer = writer_cls(str(tmp_path / tag), keyframe_every=4,
                            upstream=f"127.0.0.1:{up.port}", poll=POLL)
        try:
            kinds = []
            for i, state in enumerate(states):
                store.publish_snapshot(delta.state_to_snapshot(state))
                if i != 2:
                    kinds.append(writer.sync_once())
            kinds.append(writer.sync_once())
        finally:
            writer.stop()
            up.stop()
        results[tag] = kinds
    assert results["t"] == results["j"]
    assert results["t"][0] == "full" and results["t"][-1] == "none"
    assert _files(tmp_path / "t") == _files(tmp_path / "j")


def test_history_entry_needs_an_upstream(tmp_path):
    for main in (tcli.history_main, jcli.history_main):
        assert main(["-history.dir", str(tmp_path / "h"),
                     "-history.listen", "127.0.0.1:0"]) == 2
    assert tcli.main(["history"]) == 2


def _wait_version(store, version):
    deadline = time.monotonic() + 120
    while store.current is None or store.current.version != version:
        assert time.monotonic() < deadline, "the archive did not catch up"
        time.sleep(POLL)


@pytest.mark.parametrize("entry", ["history", "gateway"])
def test_entry_archives_in_process(states, tmp_path, entry):
    """``history`` (and ``gateway -history.dir``) through the CLI in
    process archive a live upstream: an older version answers by
    ``?version=`` what the upstream served when it was current."""
    store = TStore()
    store.publish_snapshot(tdelta.state_to_snapshot(states[0]))
    up = TServe(store, port=0).start()
    old = _get(up.port, "/query/topk?k=5")
    seen = types.SimpleNamespace(old=None, index=None)

    def on_start(tier, server):
        _wait_version(server.store, states[0]["version"])
        for state in states[1:]:
            store.publish_snapshot(tdelta.state_to_snapshot(state))
            _wait_version(server.store, state["version"])
        v = states[0]["version"]
        seen.old = _get(server.port, f"/query/topk?k=5&version={v}")
        seen.index = json.loads(_get(server.port, "/history/index")[2])

    flags = ["-history.dir", str(tmp_path / "arch"), "-loglevel",
             "warning", "-history.keyframe", "3"]
    try:
        if entry == "history":
            rc = tcli.run_history(
                ["-history.upstream", f"127.0.0.1:{up.port}",
                 "-history.listen", "127.0.0.1:0", "-history.poll",
                 str(POLL), *flags], on_start=on_start)
        else:
            rc = tcli.run_gateway(
                ["-gateway.upstream", f"127.0.0.1:{up.port}",
                 "-gateway.listen", "127.0.0.1:0", "-gateway.poll",
                 str(POLL), *flags], on_start=on_start)
    finally:
        up.stop()
    assert rc == 0
    assert seen.old[0] == 200 and seen.old[2] == old[2]
    assert seen.index["newest"] == states[-1]["version"]
    assert TReader(str(tmp_path / "arch")).versions()[-1] == \
        states[-1]["version"]
