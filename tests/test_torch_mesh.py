"""The port's in-process mesh (flow_pipeline_tpu_torch/mesh) against the
JAX package's, on the CPU.

Each merge is bit-equal to the reference's on seeded payloads; the
coordinator protocol scenarios of tests/test_mesh.py run on both
coordinators and emit equal rows; the same operations write the same
journal bytes, and each package's journal replays in the other. Over one
seeded Zipf stream (24,000 flows, 200 keys, key-hash sharded over 8
partitions: every key stays resident, so the tables are exact), the
port's InProcessMesh at N = 1, 2 and 4 members, at N = 2 on the host
sketch backend, and with one of 3 members killed mid-stream writes the
flows_5m rows of the exact numpy groupby and of the JAX mesh at the same
N, and the JAX mesh's top_talkers rows (tolerance: none). The mesh
``/topk`` and ``/healthz`` bodies are byte-equal to the JAX package's,
and ``pipeline -mesh.workers 2`` writes the JAX pipeline's seven sqlite
tables.

Nothing here waits on wall time: the meshes run with a heartbeat
timeout no test reaches, the churn kill waits for a count of flows, and
the protocol's expiry case drives an explicit clock.
"""

import gc
import shutil
import sqlite3
import threading
import urllib.request
import weakref

import numpy as np
import pytest
import torch

from flow_pipeline_tpu import cli as jcli
from flow_pipeline_tpu import mesh as jmesh
from flow_pipeline_tpu.engine import WorkerConfig as JWorkerConfig
from flow_pipeline_tpu.engine.query_api import QueryServer as JQuery
from flow_pipeline_tpu.mesh import codec as jcodec
from flow_pipeline_tpu.mesh import coordinator as jcoord
from flow_pipeline_tpu.mesh import merge as jmerge
from flow_pipeline_tpu.mesh import scope as jscope
from flow_pipeline_tpu.models import heavy_hitter as jhh
from flow_pipeline_tpu.models import window_agg as jwagg
from flow_pipeline_tpu.models.dense_top import DenseTopConfig as JDenseCfg
from flow_pipeline_tpu.models.oracle import exact_groupby
from flow_pipeline_tpu.models.spread import SpreadConfig as JSpreadCfg
from flow_pipeline_tpu.obs import REGISTRY as JREGISTRY
from flow_pipeline_tpu.obs import TRACER as JTRACER
from flow_pipeline_tpu.schema.batch import FlowBatch as JBatch
from flow_pipeline_tpu.transport import InProcessBus as JBus
from flow_pipeline_tpu_torch import cli as tcli
from flow_pipeline_tpu_torch import mesh as tmesh
from flow_pipeline_tpu_torch.engine import WorkerConfig as TWorkerConfig
from flow_pipeline_tpu_torch.engine.query_api import QueryServer as TQuery
from flow_pipeline_tpu_torch.gen import FlowGenerator, ZipfProfile
from flow_pipeline_tpu_torch.hostsketch import engine as tengine
from flow_pipeline_tpu_torch.hostsketch import state as tstate
from flow_pipeline_tpu_torch.mesh import codec as tcodec
from flow_pipeline_tpu_torch.mesh import coordinator as tcoord
from flow_pipeline_tpu_torch.mesh import merge as tmerge
from flow_pipeline_tpu_torch.mesh import scope as tscope
from flow_pipeline_tpu_torch.models import heavy_hitter as thh
from flow_pipeline_tpu_torch.models import window_agg as twagg
from flow_pipeline_tpu_torch.models.dense_top import DenseTopConfig as TDenseCfg
from flow_pipeline_tpu_torch.models.spread import SpreadConfig as TSpreadCfg
from flow_pipeline_tpu_torch.obs import REGISTRY as TREGISTRY
from flow_pipeline_tpu_torch.obs import TRACER as TTRACER
from flow_pipeline_tpu_torch.ops import cms_cuda
from flow_pipeline_tpu_torch.transport import InProcessBus as TBus
import torch_cpu  # noqa: F401  (one torch thread; see the module)

N_KEYS = 200  # << capacity: admission never collides, tables are exact
N_FLOWS = 24_000
PARTITIONS = 8
BATCH = 4096
FOREVER = 3600.0  # a heartbeat timeout and deadline no suite load reaches
TOP_COLS = ("src_addr", "dst_addr", "src_port", "dst_port", "proto",
            "bytes", "bytes_est", "packets", "packets_est", "count",
            "count_est", "timeslot")
MODEL_FLAGS = ["-produce.profile", "zipf", "-zipf.keys", str(N_KEYS),
               "-model.ports=false", "-model.ddos=false",
               "-model.ips=false", "-processor.batch", str(BATCH),
               "-sketch.capacity", "512"]


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """Fresh metric registries in both packages for each test (the
    coordinators' counters are process totals otherwise), and both trace
    rings unpaused afterwards."""
    monkeypatch.setattr(JREGISTRY, "_metrics", {})
    monkeypatch.setattr(TREGISTRY, "_metrics", {})
    yield
    JTRACER.paused = False
    TTRACER.paused = False


class ListSink:
    def __init__(self):
        self.tables = {}
        self._lock = threading.Lock()

    def write(self, table, rows):
        with self._lock:
            self.tables.setdefault(table, []).append(rows)


def _batches():
    gen = FlowGenerator(ZipfProfile(n_keys=N_KEYS, alpha=1.2), seed=0,
                        rate=100_000.0)
    out, done = [], 0
    while done < N_FLOWS:
        n = min(8192, N_FLOWS - done)
        out.append(gen.batch(n))
        done += n
    return out


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


def _mesh(pkg, n_workers, *flags, sink=None, **kw):
    """An InProcessMesh of ``pkg`` over the shared stream, not started."""
    if pkg == "port":
        vals = tcli._processor_flags(tcli._gen_flags(tcli._common_flags(
            tcli.FlagSet("t")))).parse([*MODEL_FLAGS, *flags])
        cpu = torch.device("cpu")
        return tmesh.InProcessMesh(
            _bus(pkg), "flows", n_workers,
            model_factory=lambda: tcli._build_models(vals, cpu),
            config=TWorkerConfig(poll_max=BATCH, snapshot_every=0,
                                 sketch_backend=vals["sketch.backend"]),
            sinks=[sink] if sink else [], heartbeat_timeout=FOREVER, **kw)
    vals = jcli._processor_flags(jcli._gen_flags(jcli._common_flags(
        jcli.FlagSet("t")))).parse([*MODEL_FLAGS, *flags])
    return jmesh.InProcessMesh(
        _bus(pkg), "flows", n_workers,
        model_factory=lambda: jcli._build_models(vals),
        config=JWorkerConfig(poll_max=BATCH, snapshot_every=0,
                             sketch_backend=vals["sketch.backend"]),
        sinks=[sink] if sink else [], heartbeat_timeout=FOREVER, **kw)


def _fold_flows5m(tables):
    """Partial flows_5m rows -> {(slot, src_as, dst_as, etype): (bytes,
    packets, count)}, the merging sink's semantics."""
    acc = {}
    for rows in tables.get("flows_5m", []):
        for i in range(len(rows["timeslot"])):
            key = (int(rows["timeslot"][i]), int(rows["src_as"][i]),
                   int(rows["dst_as"][i]), int(rows["etype"][i]))
            v = acc.setdefault(key, np.zeros(3, np.uint64))
            v += np.array([rows["bytes"][i], rows["packets"][i],
                           rows["count"][i]], np.uint64)
    return {k: tuple(int(x) for x in v) for k, v in acc.items()}


def _oracle_flows5m():
    full = JBatch.concat([JBatch(dict(b.columns)) for b in BATCHES])
    o = exact_groupby(full, ["src_as", "dst_as", "etype"],
                      ["bytes", "packets"])
    return {(int(o["timeslot"][i]), int(o["src_as"][i]), int(o["dst_as"][i]),
             int(o["etype"][i])):
            (int(o["bytes"][i]), int(o["packets"][i]), int(o["count"][i]))
            for i in range(len(o["timeslot"]))}


ORACLE = {}


def _oracle():
    if not ORACLE:
        ORACLE.update(_oracle_flows5m())
    return ORACLE


def _assert_top_equal(got, want):
    vg, vw = np.asarray(got["valid"]), np.asarray(want["valid"])
    assert int(vg.sum()) == int(vw.sum()) > 0
    for col in TOP_COLS:
        a, b = np.asarray(got[col])[vg], np.asarray(want[col])[vw]
        assert a.shape == b.shape and (a == b).all(), col


JAX_RUNS = {}


def _jax_mesh_tables(n_workers, *flags):
    """The JAX mesh's emitted tables at N members, one run per setting."""
    key = (n_workers, flags)
    if key not in JAX_RUNS:
        sink = ListSink()
        _mesh("jax", n_workers, *flags, sink=sink).run()
        JAX_RUNS[key] = sink.tables
    return JAX_RUNS[key]


# ---- merges ------------------------------------------------------------------


def _hh_cfgs(**kw):
    return (jhh.HeavyHitterConfig(**kw), thh.HeavyHitterConfig(**kw))


def _table_payloads(rng, cfg, n, keys_hi):
    """n seeded hh payloads: u64 CMS planes, real table rows (some keys
    shared between payloads), sentinel-padded tables."""
    out = []
    planes = len(cfg.value_cols) + 1
    kw = jhh.key_width(cfg)
    for _ in range(n):
        cms = rng.integers(0, 2**20, size=(planes, cfg.depth, cfg.width),
                           dtype=np.uint64)
        tk = np.full((cfg.capacity, kw), 0xFFFFFFFF, np.uint32)
        tv = np.zeros((cfg.capacity, planes), np.float32)
        m = int(rng.integers(1, cfg.capacity))
        tk[:m] = rng.integers(0, keys_hi, size=(m, kw), dtype=np.uint32)
        tv[:m] = rng.integers(1, 1000, size=(m, planes)).astype(np.float32)
        out.append({"kind": "hh", "cms": cms, "table_keys": tk,
                    "table_vals": tv})
    return out


def _audit_parts(rng, cfg, n):
    kw = jhh.key_width(cfg)
    planes = len(cfg.value_cols) + 1
    parts = []
    for _ in range(n):
        k = int(rng.integers(0, 20))
        keys = rng.integers(0, 9, size=(k, kw), dtype=np.uint32)
        parts.append({"keys": keys[np.lexsort(keys.T[::-1])],
                      "vals": rng.integers(0, 2**40, size=(k, planes),
                                           dtype=np.uint64),
                      "evictions": int(rng.integers(0, 5)), "scale": 256})
    return parts


def _inv_payloads(rng, n):
    cfg_j, cfg_t = _hh_cfgs(key_cols=("src_port", "proto"), width=64,
                            depth=3, capacity=16, batch_size=256,
                            hh_sketch="invertible")
    out = []
    for _ in range(n):
        st = tstate.host_inv_init(cfg_t)
        keys = rng.integers(0, 4, size=(300, 2), dtype=np.uint32)
        vals = rng.integers(1, 500, size=(300, 3)).astype(np.float32)
        tengine.np_inv_update(st, keys, vals)
        out.append(tcodec.hh_payload(st))
    return out, cfg_j, cfg_t


def _merge_case(case, rng):
    """(reference merged, port merged, reference rows, port rows)."""
    if case == "wagg":
        pays = []
        for _ in range(3):
            k = int(rng.integers(0, 50))
            store = {tuple(int(x) for x in rng.integers(0, 6, size=4)):
                     rng.integers(0, 2**50, size=3, dtype=np.uint64)
                     for _ in range(k)}
            pays.append(tcodec.wagg_payload(store))
        cfg_j = jwagg.WindowAggConfig(batch_size=256)
        cfg_t = twagg.WindowAggConfig(batch_size=256)
        mj, mt = jmerge.merge_wagg(pays), tmerge.merge_wagg(pays)
        return (mj, mt, jwagg.wagg_rows(mj, cfg_j, 0, 600),
                twagg.wagg_rows(mt, cfg_t, 0, 600))
    if case in ("hh", "hh_audit", "hh_ties"):
        cfg_j, cfg_t = _hh_cfgs(key_cols=("src_port", "proto"), width=128,
                                depth=2, capacity=24, batch_size=64)
        pays = _table_payloads(rng, cfg_j, 3,
                               4 if case == "hh_ties" else 100)
        if case == "hh_ties":
            for p in pays:  # equal primaries: the lexicographic tie-break
                p["table_vals"][:, 0] = np.where(
                    (p["table_keys"] != 0xFFFFFFFF).any(axis=1), 7.0, 0.0)
        if case == "hh_audit":
            for p, part in zip(pays, _audit_parts(rng, cfg_j, 3)):
                p["audit"] = part
        mj, mt = jmerge.merge_hh(pays, cfg_j), tmerge.merge_hh(pays, cfg_t)
        return (mj, mt, jmerge.hh_top_rows(mj, cfg_j, 20, 300),
                tmerge.hh_top_rows(mt, cfg_t, 20, 300))
    if case == "hh_inv":
        pays, cfg_j, cfg_t = _inv_payloads(rng, 3)
        mj, mt = jmerge.merge_hh(pays, cfg_j), tmerge.merge_hh(pays, cfg_t)
        return (mj, mt, jmerge.hh_top_rows(mj, cfg_j, 16, 300),
                tmerge.hh_top_rows(mt, cfg_t, 16, 300))
    if case == "spread":
        kw = dict(depth=2, width=64, registers=16, capacity=32,
                  batch_size=256)
        cfg_j, cfg_t = JSpreadCfg(**kw), TSpreadCfg(**kw)
        pays = []
        for _ in range(3):
            tk = np.full((32, 4), 0xFFFFFFFF, np.uint32)
            m = int(rng.integers(1, 32))
            tk[:m] = rng.integers(0, 30, size=(m, 4), dtype=np.uint32)
            pays.append({"kind": "spread",
                         "regs": rng.integers(0, 20, size=(2, 64, 16),
                                              dtype=np.uint8),
                         "table_keys": tk,
                         "table_metric": rng.integers(
                             0, 100, size=32).astype(np.float32)})
        mj = jmerge.merge_spread(pays, cfg_j)
        mt = tmerge.merge_spread(pays, cfg_t)
        return (mj, mt, jmerge.spread_top_rows(mj, cfg_j, 10, 300),
                tmerge.spread_top_rows(mt, cfg_t, 10, 300))
    assert case == "dense"
    cfg_j = JDenseCfg(key_col="dst_port", batch_size=256)
    cfg_t = TDenseCfg(key_col="dst_port", batch_size=256)
    shape = (cfg_j.domain, len(cfg_j.value_cols) + 1, 2)
    pays = [{"kind": "dense", "totals": rng.integers(
        0, 2**15, size=shape).astype(np.int64)} for _ in range(3)]
    mj, mt = jmerge.merge_dense(pays), tmerge.merge_dense(pays)
    return (mj, mt, jmerge.dense_top_rows(mj, cfg_j, 25, 300),
            tmerge.dense_top_rows(mt, cfg_t, 25, 300))


def _same(a, b):
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, np.ndarray):
        b = np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and \
            np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("case", ["wagg", "hh", "hh_ties", "hh_audit",
                                  "hh_inv", "spread", "dense"])
def test_merge_bit_equal(case):
    mj, mt, rj, rt = _merge_case(case, np.random.default_rng(7))
    assert _same(mj, mt)
    assert _same({k: np.asarray(v) for k, v in rj.items()},
                 {k: np.asarray(v) for k, v in rt.items()})
    assert np.asarray(rj.get("valid", rj["timeslot"])).any()


def test_registry_merge_hooks_and_specs():
    from flow_pipeline_tpu.families import registry as jreg
    from flow_pipeline_tpu_torch.families import registry as treg

    for kind in ("hh", "wagg", "dense", "spread"):
        for hook in ("merge", "top_rows", "serve_capture_merged"):
            ref = getattr(jreg.family(kind), hook)
            if ref is None:  # wagg's exact rows ride the range ledger
                assert kind == "wagg" and hook == "serve_capture_merged"
                assert treg.hook(treg.family(kind), hook) is None
                continue
            assert getattr(treg.family(kind), hook) == ref.replace(
                "flow_pipeline_tpu.", "flow_pipeline_tpu_torch.")
            assert callable(treg.hook(treg.family(kind), hook))
    flags = [*MODEL_FLAGS, "-model.ddos=true", "-model.ports=true",
             "-model.ips=true", "-spread.enabled"]
    jvals = jcli._processor_flags(jcli._gen_flags(jcli._common_flags(
        jcli.FlagSet("t")))).parse(flags)
    tvals = tcli._processor_flags(tcli._gen_flags(tcli._common_flags(
        tcli.FlagSet("t")))).parse(flags)
    js = jmesh.spec_from_models(jcli._build_models(jvals))
    ts = tmesh.spec_from_models(tcli._build_models(tvals,
                                                   torch.device("cpu")))
    assert [(s.name, s.kind, s.k, s.window_seconds, s.allowed_lateness)
            for s in ts] == [(s.name, s.kind, s.k, s.window_seconds,
                              s.allowed_lateness) for s in js]
    assert "ddos_alerts" not in {s.name for s in ts}


def test_shard_ids_equal_the_reference():
    for b in BATCHES:
        np.testing.assert_array_equal(
            tmesh.shard_ids(b, PARTITIONS),
            jmesh.shard_ids(JBatch(dict(b.columns)), PARTITIONS))


def test_scope_equals_the_reference():
    for samples in ([(0.0, 0.2, 5.1), (1.0, 1.05, 6.0), (2.0, 2.5, 7.3)],
                    []):
        j, t = jscope.ClockSync(window=2), tscope.ClockSync(window=2)
        for s in samples:
            j.add(*s)
            t.add(*s)
        assert t.report() == j.report()
    trace = {"traceEvents": [{"name": "x", "ph": "X", "ts": 10.0,
                              "dur": 2.0, "pid": 7},
                             {"name": "m", "ph": "M", "pid": 7}],
             "otherData": {"mode": "ring", "dropped_spans": 3}}
    lanes = [("coordinator", trace, 0.0, 0.0), ("w0", trace, 0.25, 0.01)]
    assert tscope.aggregate_traces(
        [tscope.TraceLane(*a) for a in lanes]) == jscope.aggregate_traces(
            [jscope.TraceLane(*a) for a in lanes])


# ---- the coordinator protocol ----------------------------------------------


class _Pkg:
    """One package's protocol surface, for scenarios run on both."""

    def __init__(self, coord, codec, wagg, hh, hh_init):
        self.coord, self.codec, self.wagg, self.hh = coord, codec, wagg, hh
        self.hh_init = hh_init

    def make(self, partitions=2, **kw):
        cfg = self.wagg.WindowAggConfig(key_cols=("src_as",),
                                        value_cols=("bytes",),
                                        window_seconds=300, scale_col=None,
                                        batch_size=256)
        spec = self.coord.ModelSpec("flows_5m", "wagg", cfg, 0, 300)
        return self.coord.MeshCoordinator([spec], partitions, **kw)

    def win(self, key, val):
        return {"flows_5m": self.codec.wagg_payload(
            {(key,): np.array([val, 1], np.uint64)})}


PKGS = {"jax": _Pkg(jcoord, jcodec, jwagg, jhh, jhh.hh_init),
        "port": _Pkg(tcoord, tcodec, twagg, thh,
                     lambda cfg: thh.hh_init(cfg, torch.device("cpu")))}


def _contrib(ranges, wm, closed=None, open_=None, final=False,
             release=False, flows=0):
    return {"ranges": ranges, "watermark": wm, "closed": closed or {},
            "open": open_ or {}, "final": final, "release": release,
            "flows": flows}


def _rows(c, slot=300):
    return [{k: np.asarray(v).tolist() for k, v in r.items()}
            for r in c.merged_rows("flows_5m", slot)]


def _bytes(c, slot=300):
    return [int(r["bytes"][0]) for r in c.merged_rows("flows_5m", slot)]


def sc_join_assign_epoch(P, obs):
    c = P.make()
    obs.append(c.join("a")["epoch"])
    s = c.sync("a")
    obs += [s["action"], sorted(s["assign"])]
    obs += [c.join("b")["epoch"], c.sync("a")["action"]]
    assert obs == [1, "run", [0, 1], 2, "resync"]


def sc_submit_advances_frontier_and_merges(P, obs):
    c = P.make(partitions=1)
    c.join("a")
    c.sync("a")
    obs.append(c.submit("a", _contrib({0: [0, 10]}, wm=900,
                                      closed={300: P.win(7, 50)})))
    obs += [c.status()["covered"], _rows(c)]
    assert obs[1] == [10] and _bytes(c) == [50]


def sc_merge_waits_for_every_partition(P, obs):
    c = P.make(partitions=2)
    c.join("a")
    c.join("b")
    sa, sb = c.sync("a"), c.sync("b")
    c.submit("a", _contrib({list(sa["assign"])[0]: [0, 5]}, wm=900,
                           closed={300: P.win(1, 10)}))
    obs.append(_rows(c))
    c.submit("b", _contrib({list(sb["assign"])[0]: [0, 5]}, wm=900,
                           closed={300: P.win(1, 5)}))
    obs.append(_rows(c))
    assert obs[0] == [] and _bytes(c) == [15]


def sc_zombie_submission_fenced(P, obs):
    c = P.make(partitions=1)
    c.join("a")
    c.sync("a")
    c.fence("a")
    obs += [c.submit("a", _contrib({0: [0, 10]}, wm=900)),
            c.status()["covered"], c.sync("a")["action"]]
    assert obs[0] == {"ok": False, "reason": "fenced"}
    assert obs[1:] == [[0], "rejoin"]


def sc_range_gap_fences(P, obs):
    c = P.make(partitions=1)
    c.join("a")
    c.sync("a")
    obs += [c.submit("a", _contrib({0: [5, 10]}, wm=0)),
            c.sync("a")["action"]]
    assert obs == [{"ok": False, "reason": "range"}, "rejoin"]


def sc_death_promotes_carry_and_successor_resumes(P, obs):
    c = P.make(partitions=1)
    c.join("a")
    c.sync("a")
    c.submit("a", _contrib({0: [0, 8]}, wm=100, open_={300: P.win(2, 30)}))
    c.join("b")
    c.fence("a")
    s = c.sync("b")
    obs += [s["action"], s["assign"]]
    c.submit("b", _contrib({0: [8, 12]}, wm=700,
                           closed={300: P.win(2, 12)}, final=True))
    obs.append(_rows(c))
    assert obs[:2] == ["run", {0: 8}] and _bytes(c) == [42]


def sc_resubmission_replaces_carry(P, obs):
    c = P.make(partitions=1)
    c.join("a")
    c.sync("a")
    c.submit("a", _contrib({0: [0, 4]}, wm=100, open_={300: P.win(2, 10)}))
    c.submit("a", _contrib({0: [4, 9]}, wm=100, open_={300: P.win(2, 25)}))
    c.fence("a")
    c.join("b")
    c.sync("b")
    c.submit("b", _contrib({0: [9, 9]}, wm=700, final=True))
    obs.append(_rows(c))
    assert _bytes(c) == [25]


def sc_heartbeat_expiry_fences(P, obs):
    now = [0.0]
    c = P.make(partitions=1, heartbeat_timeout=1.0, time_fn=lambda: now[0])
    c.join("a")
    c.sync("a")
    now[0] = 10.0
    obs += [c.expire(), c.sync("a")["action"]]
    assert obs == [["a"], "rejoin"]


def sc_late_wagg_contribution_emits_extra_partials(P, obs):
    c = P.make(partitions=1)
    c.join("a")
    c.sync("a")
    c.submit("a", _contrib({0: [0, 5]}, wm=900, closed={300: P.win(3, 10)}))
    c.submit("a", _contrib({0: [5, 6]}, wm=901, closed={300: P.win(3, 4)}))
    obs += [_rows(c), c._m["late"].value(model="flows_5m")]
    assert _bytes(c) == [10, 4] and obs[-1] == 1.0


def sc_rejoin_fence_completes_barrier_and_emits(P, obs):
    c = P.make(partitions=1)
    c.join("a")
    c.sync("a")
    c.submit("a", _contrib({0: [0, 5]}, wm=900, open_={300: P.win(7, 33)}))
    obs.append(_rows(c))
    c.join("a")  # a restart before expiry: death, then join
    obs.append(_rows(c))
    assert obs[0] == [] and _bytes(c) == [33]


def sc_leave_fence_completes_barrier_and_emits(P, obs):
    c = P.make(partitions=1)
    c.join("a")
    c.sync("a")
    c.submit("a", _contrib({0: [0, 5]}, wm=900, open_={300: P.win(2, 21)}))
    c.leave("a")
    obs.append(_rows(c))
    assert _bytes(c) == [21]


def sc_query_topk_live_carry_not_double_counted(P, obs):
    cfg = P.hh.HeavyHitterConfig(key_cols=("proto",), value_cols=("bytes",),
                                 width=128, depth=2, capacity=4,
                                 batch_size=64)
    spec = P.coord.ModelSpec("talkers", "hh", cfg, 4, 300)
    c = P.coord.MeshCoordinator([spec], 1)

    def table(val):
        p = P.codec.hh_payload(P.hh_init(cfg))
        p["table_keys"][0] = (6,)
        p["table_vals"][0] = (val, 1.0)
        return p

    c.join("a", provider=lambda model: {"slot": 300,
                                         "payload": table(30.0)})
    c.sync("a")
    c.submit("a", _contrib({0: [0, 4]}, wm=100,
                           open_={300: {"talkers": table(20.0)}}))
    out = c.query_topk("talkers")
    obs.append(out)
    assert out["window_start"] == 300 and out["rows"][0]["bytes"] == 30.0


def sc_merged_ledger_retention_bounded(P, obs):
    c = P.make(partitions=1)
    c.join("a")
    c.sync("a")
    n = P.coord.MERGED_LEDGER_SLOTS + 4
    for i in range(n):
        slot = 300 * (i + 1)
        c.submit("a", _contrib({0: [i, i + 1]}, wm=slot + 600,
                               closed={slot: P.win(1, 10)}))
    kept = sorted(s for (name, s) in c.merged if name == "flows_5m")
    c.submit("a", _contrib({0: [n, n]}, wm=10**9,
                           closed={300: P.win(1, 4)}))
    obs += [kept, _rows(c), c._m["late"].value(model="flows_5m")]
    assert len(kept) == P.coord.MERGED_LEDGER_SLOTS and obs[-1] == 1.0


def sc_more_members_than_partitions_idles_extra(P, obs):
    c = P.make(partitions=1)
    c.join("a")
    c.join("b")
    obs.append({m: c.sync(m)["action"] for m in ("a", "b")})
    obs.append(sorted(len(v["owned"])
                      for v in c.status()["members"].values()))
    assert obs[-1] == [0, 1]


SCENARIOS = [v for k, v in sorted(globals().items()) if k.startswith("sc_")]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[f.__name__[3:] for f in SCENARIOS])
def test_protocol_scenario_on_both_coordinators(scenario):
    got = {}
    for pkg, P in PKGS.items():
        got[pkg] = []
        scenario(P, got[pkg])
    assert got["port"] == got["jax"]


# ---- the journal -------------------------------------------------------------


def _journal_ops(P, journal):
    """Accepted, rejected and late submissions, a carry promoted by a
    fence, a rejoin, a leave, and a compaction in the middle."""
    c = P.make(partitions=2, journal=journal)
    c.join("a")
    c.join("b")
    sa, sb = c.sync("a"), c.sync("b")
    pa, pb = list(sa["assign"])[0], list(sb["assign"])[0]
    c.submit("a", _contrib({pa: [0, 5]}, wm=900, closed={300: P.win(1, 10)},
                           open_={900: P.win(4, 3)}))
    c.submit("b", _contrib({pb: [0, 7]}, wm=950, closed={300: P.win(1, 5)},
                           open_={900: P.win(5, 8)}))
    c.submit("b", _contrib({pb: [7, 9]}, wm=960, closed={300: P.win(2, 1)}))
    assert c.compact_journal()
    c.submit("a", _contrib({pa: [6, 9]}, wm=960))  # a gap: fenced
    c.join("a")
    c.sync("b")
    c.submit("b", _contrib({pb: [9, 11]}, wm=1300,
                           open_={1200: P.win(9, 2)}))
    c.leave("b")
    c.close()
    return c


def _replay_state(P, journal):
    c = P.make(partitions=2, journal=journal)
    try:
        st = c.status()
        return st, {k: [{f: np.asarray(v).tolist() for f, v in r.items()}
                        for r in rows] for k, rows in c.merged.items()}
    finally:
        c.close()


def test_journal_bytes_equal_and_replay_across_packages(tmp_path):
    files = {}
    for pkg, P in PKGS.items():
        _journal_ops(P, str(tmp_path / pkg))
        files[pkg] = (tmp_path / pkg / "coordinator.journal").read_bytes()
    assert files["port"] == files["jax"] and len(files["port"]) > 100
    recovered = {}
    for writer in PKGS:
        for reader, P in PKGS.items():
            d = tmp_path / f"{writer}-by-{reader}"
            shutil.copytree(tmp_path / writer, d)
            recovered[writer, reader] = _replay_state(P, str(d))
            # recovery journals its fences and epoch bump alike
            recovered[writer, reader] += (
                (d / "coordinator.journal").read_bytes(),)
    first = recovered["jax", "jax"]
    assert first[0]["epoch"] > 0 and first[0]["covered"] != [0, 0]
    for key, got in recovered.items():
        assert got == first, key


# ---- the in-process mesh ----------------------------------------------------


@pytest.mark.parametrize("n_workers", [1, 2, 4])
def test_mesh_equals_the_jax_mesh_and_the_oracle(n_workers):
    sink = ListSink()
    mesh = _mesh("port", n_workers, "-device", "cpu", sink=sink)
    mesh.run(timeout=FOREVER)
    jax_tables = _jax_mesh_tables(n_workers)
    fold = _fold_flows5m(sink.tables)
    assert fold == _oracle() == _fold_flows5m(jax_tables)
    _assert_top_equal(sink.tables["top_talkers"][0],
                      jax_tables["top_talkers"][0])
    assert mesh.coordinator._m["merged"].value(model="top_talkers") == 1.0


def test_mesh_on_the_host_sketch_backend():
    sink = ListSink()
    _mesh("port", 2, "-device", "cpu", "-sketch.backend", "host",
          sink=sink).run(timeout=FOREVER)
    jax_tables = _jax_mesh_tables(2, "-sketch.backend", "host")
    assert _fold_flows5m(sink.tables) == _oracle() == \
        _fold_flows5m(jax_tables)
    _assert_top_equal(sink.tables["top_talkers"][0],
                      jax_tables["top_talkers"][0])


def test_mesh_churn_kill_one_of_three_stays_exact():
    """A member killed mid-stream (no final submission) and fenced: the
    rebalanced mesh's rows equal the oracle's and the JAX mesh's, and
    the dead member's worker and model state are freed while the mesh
    runs on."""
    sink = ListSink()
    mesh = _mesh("port", 3, "-device", "cpu", sink=sink, submit_every=2)
    mesh.start()
    victim = mesh.members[1]
    ready = threading.Event()

    def watch():  # a count, not a clock: the victim processed a batch
        while not ready.is_set():
            w = victim.worker
            if w is not None and w.flows_seen >= BATCH:
                ready.set()
            else:
                threading.Event().wait(0.002)

    threading.Thread(target=watch, daemon=True).start()
    assert ready.wait(FOREVER), "the victim never processed a batch"
    held = weakref.ref(victim.worker.models["top_talkers"])
    mesh.kill_member(1)
    mesh._threads[1].join(FOREVER)
    gc.collect()
    assert held() is None, "the killed member's models are still held"
    mesh.wait_idle(timeout=FOREVER)
    mesh.finalize()
    assert _fold_flows5m(sink.tables) == _oracle()
    _assert_top_equal(sink.tables["top_talkers"][0],
                      _jax_mesh_tables(2)["top_talkers"][0])
    assert mesh.coordinator._m["rebalance"].value(reason="death") >= 1.0


def test_mesh_topk_and_healthz_bodies_equal_the_jax_mesh():
    """The query API's mesh branch, quiesced before the final merge: the
    open window's merged top-K over both packages' members."""
    bodies = {}
    for pkg, server_cls in (("jax", JQuery), ("port", TQuery)):
        flags = ("-device", "cpu") if pkg == "port" else ()
        mesh = _mesh(pkg, 2, *flags)
        server = server_cls(None, 0, "127.0.0.1",
                            mesh=mesh.coordinator).start()
        mesh.start()
        try:
            mesh.wait_idle(timeout=FOREVER)
            base = f"http://127.0.0.1:{server.port}"
            bodies[pkg] = [urllib.request.urlopen(base + path).read()
                           for path in ("/topk?model=top_talkers&k=10",
                                        "/topk", "/healthz")]
        finally:
            mesh.finalize()
            server.stop()
    assert bodies["port"] == bodies["jax"]
    assert b'"window_start": ' in bodies["port"][0]


TABLES = ("flows_5m", "top_talkers", "top_src_ips", "top_dst_ips",
          "top_src_ports", "top_dst_ports", "ddos_alerts")


def _table_rows(db):
    conn = sqlite3.connect(db)
    try:
        return {t: sorted(conn.execute(f"SELECT * FROM {t}").fetchall())
                for t in TABLES}
    finally:
        conn.close()


def test_pipeline_mesh_sqlite_tables_equal_the_jax_pipeline(tmp_path):
    # 5,000 Zipf flows at 40 flows/s: a 5-minute window closes mid-stream,
    # the DDoS detector runs per member shard and alerts once
    common = ["-mesh.workers", "2", "-produce.count", "5000",
              "-produce.rate", "40", "-produce.profile", "zipf",
              "-produce.seed", "3", "-processor.batch", "1024",
              "-sketch.width", "4096", "-sketch.capacity", "128",
              "-metrics.addr", "", "-mesh.heartbeat", str(FOREVER),
              "-loglevel", "warning"]
    assert jcli.pipeline_main([*common, "-processor.backend", "cpu",
                               "-sink", f"sqlite:{tmp_path / 'j.db'}"]) == 0
    mesh = tcli.run_pipeline([*common, "-device", "cpu",
                              "-sink", f"sqlite:{tmp_path / 't.db'}"])
    assert isinstance(mesh, tmesh.InProcessMesh)
    want = _table_rows(tmp_path / "j.db")
    assert all(want.values())
    assert _table_rows(tmp_path / "t.db") == want


def test_mesh_with_serve_addr_exits_2(capsys):
    """``-mesh.workers 2 -serve.addr`` runs (the merged serving tier;
    its bodies are held against the JAX mesh's in
    tests/test_torch_mesh_serve.py); ``-processor.mesh`` inside members
    exits 2."""
    assert tcli.main(["pipeline", "-mesh.workers", "2", "-device", "cpu",
                      "-produce.count", "100", "-metrics.addr", "",
                      "-mesh.heartbeat", str(FOREVER),
                      "-serve.addr", "127.0.0.1:0"]) == 0
    assert "not ported" not in capsys.readouterr().err
    # device sharding inside members is not a flag of the port
    assert tcli.main(["pipeline", "-mesh.workers", "2", "-device", "cpu",
                      "-processor.mesh", "2"]) == 2


def test_counters_are_exact_across_threads(monkeypatch):
    """The launch count and the CMS update tally that chip_smoke.py holds
    equal stay exact with one writer thread per member: more threads than
    cores, a short switch interval, no lost update."""
    import sys

    model = type("M", (), {"chunk_updates": 0,
                           "config": thh.HeavyHitterConfig()})
    monkeypatch.setattr(cms_cuda, "LAUNCHES",
                        {k: 0 for k in cms_cuda.LAUNCHES})
    monkeypatch.setattr(thh, "CHUNK_UPDATES",
                        {k: 0 for k in thh.CHUNK_UPDATES})
    n_threads, n = 16, 5_000

    def hammer():
        m = model()
        for _ in range(n):
            cms_cuda._count_launch("cms_add_conservative")
            thh.count_chunk_update(m)
        assert m.chunk_updates == n

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer)
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(FOREVER)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    k = "cms_add_conservative"
    assert cms_cuda.LAUNCHES[k] == thh.CHUNK_UPDATES[k] == n_threads * n
