"""The port's guard (``-guard.lag``, flow_pipeline_tpu_torch/guard/) and its
lag stamp against the JAX package's, on the CPU (tolerance: none).

- ``admission_mask`` is bit-equal to the reference's at shifts 1-6 on
  seeded columns, and so are the guard's and the audit's lane
  multipliers (``_lane_mults`` with its seed).
- The ladder walks the reference's levels for the same ``observe``
  sequence (explicit ``now``, no wall clock), and ``admit`` sheds the
  same rows with the same scaled ``sampling_rate``.
- ``produced_at`` on polled batches equals the reference consumer's for
  the same produce calls with both buses' clocks patched, through the
  prefetch feed too.
- With the audit ``paused`` its extractions return None in both
  packages, and equal extractions when not.
- A port processor held at a forced level (test_torch_gpu.py
  ``force_level``: the ladder stepped with explicit clocks, then fed a
  fixed lag inside the hysteresis band, so wall time never moves it) writes the seven sqlite tables equal to the
  JAX processor's at the same level, sheds the same rows, and on the
  audited host-grouped path at level 1 closes the same audit reports:
  the host-grouped step (admission on the group thread), the fused step
  and the host sketch backend (admission on the worker thread).
"""

import sqlite3
import types

import numpy as np
import pytest

from flow_pipeline_tpu import cli as jcli
from flow_pipeline_tpu.engine import StreamWorker as JWorker
from flow_pipeline_tpu.guard import controller as jguard
from flow_pipeline_tpu.obs import REGISTRY as JREGISTRY
from flow_pipeline_tpu.obs import TRACER as JTRACER
from flow_pipeline_tpu.obs import audit as jaudit
from flow_pipeline_tpu.schema.batch import FlowBatch as JBatch
from flow_pipeline_tpu.transport import Consumer as JConsumer
from flow_pipeline_tpu.transport import bus as jbus
from flow_pipeline_tpu_torch import cli as tcli
from flow_pipeline_tpu_torch.engine.prefetch import PrefetchConsumer
from flow_pipeline_tpu_torch.gen import FlowGenerator, ZipfProfile
from flow_pipeline_tpu_torch.guard import controller as tguard
from flow_pipeline_tpu_torch.obs import REGISTRY as TREGISTRY
from flow_pipeline_tpu_torch.obs import TRACER as TTRACER
from flow_pipeline_tpu_torch.obs import audit as taudit
from flow_pipeline_tpu_torch.schema import wire
from flow_pipeline_tpu_torch.schema.batch import FlowBatch as TBatch
from flow_pipeline_tpu_torch.transport import Consumer as TConsumer
from flow_pipeline_tpu_torch.transport import bus as tbus
from test_torch_gpu import GUARD_BUDGET as BUDGET
from test_torch_gpu import force_level, guarded_rows

TABLES = ("flows_5m", "top_talkers", "top_src_ips", "top_dst_ips",
          "top_src_ports", "top_dst_ports", "ddos_alerts")
NARROW = ["-processor.batch", "1024", "-sketch.width", "4096",
          "-sketch.capacity", "128", "-metrics.addr", "", "-guard.lag",
          str(BUDGET)]


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """Fresh metric registries in both packages for each test (other
    tests in the process read process totals), and both trace
    rings unpaused afterwards (a worker at level >= 1 pauses its
    package's ring, which only a later configure() would undo)."""
    monkeypatch.setattr(JREGISTRY, "_metrics", {})
    monkeypatch.setattr(TREGISTRY, "_metrics", {})
    yield
    JTRACER.paused = False
    TTRACER.paused = False


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    # 4,000 Zipf flows at 100 flows/s: 40 s, four DDoS sub-windows
    path = tmp_path_factory.mktemp("guard") / "frames.bin"
    assert tcli.main(["mocker", "-out", str(path), "-produce.profile",
                      "zipf", "-produce.count", "4000", "-produce.rate",
                      "100", "-produce.seed", "11"]) == 0
    return path


def _columns(seed: int, n: int = 5000) -> dict:
    return FlowGenerator(ZipfProfile(n_keys=700), seed=seed).batch(n).columns


@pytest.mark.parametrize("shift", range(1, 7))
def test_admission_mask_bit_equal(shift):
    cols = _columns(shift)
    got = tguard.admission_mask(cols, shift)
    np.testing.assert_array_equal(got, jguard.admission_mask(cols, shift))
    np.testing.assert_array_equal(tguard.flow_key_lanes(cols),
                                  jguard.flow_key_lanes(cols))
    assert 0 < got.sum() < len(got)
    assert tguard.GUARD_SAMPLE_SEED == jguard.GUARD_SAMPLE_SEED
    for seed in (taudit.AUDIT_SAMPLE_SEED, tguard.GUARD_SAMPLE_SEED):
        assert taudit._lane_mults(16, seed) == jaudit._lane_mults(16, seed)
    assert taudit._lane_mults(16) == jaudit._lane_mults(16)


def test_ladder_levels_equal():
    """One seeded lag sequence with explicit clocks through both
    controllers: the same level after every observe, the same metadata,
    both directions and the ceiling included."""
    rng = np.random.default_rng(3)
    lags = np.concatenate([rng.uniform(1.5, 9.0, 12),
                           rng.uniform(0.5, 1.0, 5),
                           rng.uniform(0.0, 0.4, 12),
                           rng.uniform(0.0, 3.0, 20)])
    now = np.cumsum(rng.uniform(0.5, 7.0, len(lags)))
    cfg = dict(lag_budget=BUDGET, max_level=4)
    jc = jguard.GuardController(jguard.GuardConfig(**cfg))
    tc = tguard.GuardController(tguard.GuardConfig(**cfg))
    got, want = [], []
    for lag, t in zip(lags, now):
        got.append(tc.observe(float(lag), now=float(t)))
        want.append(jc.observe(float(lag), now=float(t)))
        assert (tc.sample_shift, tc.drop_optional) == (jc.sample_shift,
                                                       jc.drop_optional)
    assert got == want
    assert max(got) == 4 and got[-1] < 4 and 0 in got[20:]
    assert tc.meta() == jc.meta()
    off = tguard.GuardController()
    assert not off.armed and off.observe(50.0, now=100.0) == 0
    with pytest.raises(ValueError):
        tguard.GuardController(tguard.GuardConfig(max_level=0))


@pytest.mark.parametrize("level", [0, 1, 2, 5])
def test_admit_equal(level):
    """``admit`` at each level: the same surviving rows, offsets, stamp
    and scaled sampling rates (absent rates scale as 1)."""
    cols = _columns(40 + level, 3000)
    cols["sampling_rate"][::7] = 0
    jb = JBatch({k: v.copy() for k, v in cols.items()}, 1, 100, 3099,
                chunk_id=5, produced_at=12.5)
    tb = TBatch({k: v.copy() for k, v in cols.items()}, 1, 100, 3099,
                chunk_id=5, produced_at=12.5)
    cfg = dict(lag_budget=BUDGET)
    jc = jguard.GuardController(jguard.GuardConfig(**cfg))
    tc = tguard.GuardController(tguard.GuardConfig(**cfg))
    for i in range(level):
        jc.observe(5.0, now=10.0 * (i + 1))
        tc.observe(5.0, now=10.0 * (i + 1))
    (ja, jn), (ta, tn) = jc.admit(jb), tc.admit(tb)
    assert tn == jn and (tn > 0) == (level >= 2)
    assert (ta.partition, ta.first_offset, ta.last_offset, ta.chunk_id,
            ta.produced_at) == (1, 100, 3099, 5, 12.5)
    assert list(ta.columns) == list(ja.columns)
    for k, v in ja.columns.items():
        np.testing.assert_array_equal(ta.columns[k], v, err_msg=k)
    assert tc.meta() == jc.meta()


@pytest.fixture
def fixed_clocks(monkeypatch):
    """Both buses' ``time`` with one settable wall clock."""
    clock = types.SimpleNamespace(t=1_700_000_000.0)
    fake = types.SimpleNamespace(time=lambda: clock.t)
    monkeypatch.setattr(jbus, "time", fake)
    monkeypatch.setattr(tbus, "time", fake)
    return clock


def _produce(bus, clock, frames):
    """The same produce calls at the same clock readings: single
    messages, keyless bulk, and bulk into one partition."""
    bus.create_topic("flows", 2)
    for i, (kind, lo, hi) in enumerate([("bulk", 0, 700), ("one", 700, 703),
                                        ("part", 703, 1000),
                                        ("bulk", 1000, 2000)]):
        clock.t += 1.5 + i
        if kind == "one":
            for f in frames[lo:hi]:
                bus.produce("flows", f)
        elif kind == "part":
            bus.produce_many("flows", frames[lo:hi], partition=1)
        else:
            bus.produce_many("flows", frames[lo:hi])


def _stamps(consumer, poll_max=256):
    out = []
    while True:
        batch = consumer.poll(poll_max)
        if batch is None:
            return out
        out.append((batch.partition, batch.first_offset,
                    batch.last_offset, batch.produced_at))


def test_produced_at_equals_reference(fixed_clocks):
    gen = FlowGenerator(ZipfProfile(), seed=2)
    frames = list(wire.iter_raw_frames(gen.batch(2000).to_wire()))
    jb, tb = jbus.InProcessBus(), tbus.InProcessBus()
    for bus in (jb, tb):
        fixed_clocks.t = 1_700_000_000.0
        _produce(bus, fixed_clocks, frames)
    want = _stamps(JConsumer(jb, "flows", fixedlen=True))
    got = _stamps(TConsumer(tb, "flows"))
    assert got == want
    assert len({s for *_, s in got}) >= 3 and all(s > 0 for *_, s in got)
    feed = PrefetchConsumer(TConsumer(tb, "flows", group="feed"), depth=2,
                            poll_max=256)
    try:
        assert _stamps(feed) == want
    finally:
        feed.stop()
    for p in range(2):
        for off in (0, 350, 351, 999):
            assert tb.produced_at("flows", p, off) == \
                jb.produced_at("flows", p, off)
    # the batch helpers carry the stamp
    batch = TConsumer(tb, "flows", group="helpers").poll(512)
    for part in (batch.slice(3, 90), batch.pad_to(600)[0],
                 batch.take(np.arange(len(batch)) % 2 == 0),
                 TBatch.concat([batch, batch])):
        assert part.produced_at == batch.produced_at > 0


def test_paused_audit_extracts_nothing():
    """The audit's extractions with ``paused`` on return None in both
    packages; off, they are equal."""
    from flow_pipeline_tpu.models import heavy_hitter as jhh
    from flow_pipeline_tpu_torch.models import heavy_hitter as thh

    kw = dict(key_cols=("src_addr",), width=1024, capacity=64)
    fams = {"top_src_ips": (jhh.HeavyHitterConfig(**kw), 10)}
    tfams = {"top_src_ips": (thh.HeavyHitterConfig(**kw), 10)}
    rng = np.random.default_rng(9)
    lanes = rng.integers(0, 2**32, size=(6000, 4), dtype=np.uint32)
    vals = rng.integers(1, 900, size=(6000, 2)).astype(np.float32)
    sums = rng.integers(1, 900, size=(6000, 3)).astype(np.float32)
    pairs = rng.integers(0, 2**32, size=(6000, 8), dtype=np.uint32)
    jsa, tsa = jaudit.SketchAudit(fams, "full"), \
        taudit.SketchAudit(tfams, "full")
    from flow_pipeline_tpu.models.spread import SpreadConfig as JSpread
    from flow_pipeline_tpu_torch.models.spread import SpreadConfig as TSpread

    skw = dict(key_cols=("src_addr",), elem_col="dst_addr")
    jsp = jaudit.SpreadAudit({"superspreaders": JSpread(**skw)}, "sample")
    tsp = taudit.SpreadAudit({"superspreaders": TSpread(**skw)}, "sample")
    for paused in (True, False, True):
        for a in (jsa, tsa, jsp, tsp):
            a.paused = paused
        calls = [
            (lambda a: a.prepare_rows("top_src_ips", lanes, vals)),
            (lambda a: a.prepare_grouped("top_src_ips", lanes, sums, 5000)),
        ]
        for call in calls:
            got, want = call(tsa), call(jsa)
            if paused:
                assert got is None and want is None
            else:
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g, w)
        got = tsp.prepare_pairs("superspreaders", pairs)
        want = jsp.prepare_pairs("superspreaders", pairs)
        if paused:
            assert got is None and want is None
        else:
            np.testing.assert_array_equal(got, want)


def _rows(db, table):
    conn = sqlite3.connect(db)
    try:
        return sorted(conn.execute(f"SELECT * FROM {table}").fetchall(),
                      key=repr)
    finally:
        conn.close()


def _jax_run(frames, db, level, flags):
    args = ["-in", str(frames), "-sink", f"sqlite:{db}", *NARROW, *flags,
            "-processor.backend", "cpu"]
    vals = jcli._processor_flags(jcli._common_flags(
        jcli.FlagSet("processor"))).parse(args)
    bus = jcli._load_frames_bus(vals["in"], vals["kafka.topic"])
    worker = JWorker(JConsumer(bus, vals["kafka.topic"], fixedlen=True),
                     jcli._build_models(vals), jcli._make_sinks(vals["sink"]),
                     jcli._worker_config(vals))
    force_level(worker.guard, level)
    worker.run(stop_when_idle=True)
    return worker


@pytest.mark.parametrize("level,flags,pipeline", [
    (3, (), "HostGroupPipeline"),
    (1, ("-ingest.mode", "serial"), "HostGroupPipeline"),
    (3, ("-processor.hostassist", "off", "-model.ddos=false"),
     "FusedPipeline"),
    (3, ("-sketch.backend", "host"), "HostSketchPipeline"),
], ids=["hostgroup-L3", "serial-audit-L1", "fused-L3", "hostsketch-L3"])
def test_forced_level_tables_equal_reference(frames, tmp_path, monkeypatch,
                                             level, flags, pipeline):
    jseen, tseen = [], []
    for mod, seen in ((jaudit, jseen), (taudit, tseen)):
        evaluate = mod.SketchAudit.evaluate

        def recording(self, name, slot, part, state, _e=evaluate, _s=seen):
            report = _e(self, name, slot, part, state)
            _s.append((name, report))
            return report

        monkeypatch.setattr(mod.SketchAudit, "evaluate", recording)
    jw = _jax_run(frames, tmp_path / "j.db", level, flags)
    tw = tcli.run_processor(
        ["-device", "cpu", "-in", str(frames), "-sink",
         f"sqlite:{tmp_path / 't.db'}", *NARROW, *flags],
        on_start=lambda w, services: force_level(w.guard, level))
    assert type(tw.fused).__name__ == type(jw.fused).__name__ == pipeline
    assert (tw.executor is None) == (jw.executor is None) == bool(
        "serial" in flags or pipeline == "FusedPipeline")
    assert tw.guard.meta() == jw.guard.meta()
    meta = tw.guard.meta()
    assert meta["level"] == level
    assert (meta["shed_total"] > 0) == (level >= 2)
    assert tw.flows_seen == jw.flows_seen == 4000 - meta["shed_total"]
    tables = TABLES if "-model.ddos=false" not in flags else TABLES[:-1]
    for table in tables:
        got = _rows(tmp_path / "t.db", table)
        assert got == _rows(tmp_path / "j.db", table), table
        assert got or table == "ddos_alerts", table
    assert [n for n, _ in tseen] == [n for n, _ in jseen]
    for (_, got), (_, want) in zip(tseen, jseen):
        assert got == want
    if "serial" in flags:
        # paused from the first batch's prepare: the cohorts stay empty
        # (a group thread may prepare a batch before the first apply
        # pauses the audit, in both packages alike)
        assert tw.fused.audit.paused and tseen
        assert all(r["sampled_keys"] == 0 for _, r in tseen)


def test_guarded_run_cpu_twin(tmp_path):
    """test_torch_gpu.py's guarded card run, on the CPU only: the helper
    holds the level, sheds and writes every table but the alerts."""
    rows, worker, launches = guarded_rows("cpu", 2, tmp_path,
                                          ("-processor.hostassist", "on"))
    meta = worker.guard.meta()
    assert meta["level"] == 2 and meta["shed_total"] > 0
    assert worker.flows_seen == 8000 - meta["shed_total"]
    assert launches == 0 and worker.chunk_updates > 0
    assert all(rows[t] for t in rows if t != "ddos_alerts")
