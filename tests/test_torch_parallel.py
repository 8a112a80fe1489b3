"""Port parity: device sharding (parallel/), torch on the CPU against the
JAX package.

The JAX side runs the reference's sharded models over conftest's 8
virtual CPU devices (``make_mesh(8)``, and a 4-of-8 submesh); the port
runs the same N shard slots on the CPU (``make_mesh(N, devices="cpu")``).
Both read the same numpy-seeded streams. Each sharded model must equal
the reference's bit for bit: flows_5m rows, DDoS alerts and state, port
table totals and rows, and the merged CMS and candidate table (every
cell and table value stays below 2^24, so float sums are exact in any
order; tolerance: none). The reference's own assertions against the
exact oracle are held too, against the port's copy of the oracle.

Also: ``pipeline -processor.mesh 8`` (the reference's own run of it),
and the refusals, which exit 2 in both packages in the reference's
words. The processor end to end and the worker checkpoints of a
sharded run are in tests/test_torch_parallel_e2e.py.
"""

import sqlite3

import jax
import numpy as np
import pytest
import torch

from flow_pipeline_tpu import cli as jcli
from flow_pipeline_tpu import parallel as jpar
from flow_pipeline_tpu.gen import FlowGenerator, MockerProfile, ZipfProfile
from flow_pipeline_tpu.models import DDoSConfig as JDDoSConfig
from flow_pipeline_tpu.models import HeavyHitterConfig as JHHConfig
from flow_pipeline_tpu.models import WindowAggConfig as JWConfig
from flow_pipeline_tpu.models.dense_top import DenseTopConfig as JDenseConfig
from flow_pipeline_tpu_torch import cli as tcli
from flow_pipeline_tpu_torch import interop
from flow_pipeline_tpu_torch import parallel as tpar
from flow_pipeline_tpu_torch.models import DDoSConfig, DDoSDetector
from flow_pipeline_tpu_torch.models import HeavyHitterConfig, WindowAggConfig
from flow_pipeline_tpu_torch.models import oracle
from flow_pipeline_tpu_torch.models.dense_top import DenseTopConfig
from flow_pipeline_tpu_torch.parallel import sharded as tsharded
from flow_pipeline_tpu_torch.schema.batch import FlowBatch
import torch_cpu  # noqa: F401  (one torch thread; see the module)

TABLES = ("flows_5m", "top_talkers", "top_src_ips", "top_dst_ips",
          "top_src_ports", "top_dst_ports", "ddos_alerts")
SIZES = [8, 4]  # the whole 8-device mesh and a 4-of-8 submesh


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
    return {n: (jpar.make_mesh(n), tpar.make_mesh(n, devices="cpu"))
            for n in SIZES}


def _port(batch) -> FlowBatch:
    """The same rows as a port FlowBatch."""
    return FlowBatch({k: v.copy() for k, v in batch.columns.items()})


def _equal_rows(want: dict, got: dict) -> None:
    assert set(want) == set(got)
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_array_equal(got[k], w, err_msg=k)
        assert np.asarray(got[k]).dtype == w.dtype, k


def _zipf_batches(seed, n_batches, rows, n_keys=300, alpha=1.3, **kw):
    g = FlowGenerator(ZipfProfile(n_keys=n_keys, alpha=alpha), seed=seed,
                      **kw)
    return [g.batch(rows) for _ in range(n_batches)]


# ---- flows_5m ----------------------------------------------------------------


@pytest.mark.parametrize("n", SIZES)
def test_window_agg_matches_reference_and_oracle(meshes, n):
    jm, tm = meshes[n]
    g = FlowGenerator(MockerProfile(), seed=51, rate=40.0)
    batches = [g.batch(1000) for _ in range(6)]
    jagg = jpar.ShardedWindowAggregator(JWConfig(batch_size=128), jm)
    tagg = tpar.ShardedWindowAggregator(WindowAggConfig(batch_size=128), tm)
    emitted_j, emitted_t = [], []
    for b in batches:
        jagg.update(b)
        tagg.update(_port(b))
        emitted_j.append(jagg.flush())
        emitted_t.append(tagg.flush())
    emitted_j.append(jagg.flush(force=True))
    emitted_t.append(tagg.flush(force=True))
    for want, got in zip(emitted_j, emitted_t):
        _equal_rows(want, got)
    # the reference's own check: the exact oracle over the whole stream
    want = oracle.flows_5m(FlowBatch.concat([_port(b) for b in batches]))
    got = {}
    for out in emitted_t:
        for i in range(len(out["timeslot"])):
            key = (int(out["timeslot"][i]), int(out["src_as"][i]),
                   int(out["dst_as"][i]), int(out["etype"][i]))
            acc = got.setdefault(key, [0, 0, 0])
            for j, c in enumerate(("bytes", "packets", "count")):
                acc[j] += int(out[c][i])
    assert got == {
        (int(want["timeslot"][i]), int(want["src_as"][i]),
         int(want["dst_as"][i]), int(want["etype"][i])):
        [int(want["bytes"][i]), int(want["packets"][i]),
         int(want["count"][i])] for i in range(len(want["timeslot"]))}


@pytest.mark.parametrize("n", SIZES)
def test_window_agg_ragged_global_batch(meshes, n):
    """A batch not divisible by N x batch_size exercises the padding."""
    jm, tm = meshes[n]
    b = FlowGenerator(MockerProfile(), seed=52, rate=100.0).batch(1000)
    jagg = jpar.ShardedWindowAggregator(JWConfig(batch_size=96), jm)
    tagg = tpar.ShardedWindowAggregator(WindowAggConfig(batch_size=96), tm)
    jagg.update(b)
    tagg.update(_port(b))
    out = tagg.flush(force=True)
    _equal_rows(jagg.flush(force=True), out)
    assert int(out["count"].sum()) == 1000


def test_collision_in_one_shard_reruns_every_shard(meshes, monkeypatch):
    """A 64-bit grouping-hash collision cannot be searched for here, so
    shard 5's hash-grouped step reports one on the second chunk. The
    flag is OR-ed over the shards (the reference's pmax), so the exact
    step reruns all 8 shards of that chunk and no other chunk; the rows
    stay the reference's."""
    jm, tm = meshes[8]
    shard_step = {"n": 0}
    exact_steps = []
    update, update_exact = tsharded._update, tsharded._update_exact

    def flagged(config, cols, valid):
        keys, sums, counts, n, collided = update(config, cols, valid)
        i = shard_step["n"]
        shard_step["n"] += 1
        if i == 8 + 5:  # chunk 1, shard 5
            collided = torch.ones_like(collided)
        return keys, sums, counts, n, collided

    def exact(config, cols, valid):
        exact_steps.append(shard_step["n"])
        return update_exact(config, cols, valid)

    monkeypatch.setattr(tsharded, "_update", flagged)
    monkeypatch.setattr(tsharded, "_update_exact", exact)
    g = FlowGenerator(MockerProfile(), seed=53, rate=40.0)
    batches = [g.batch(1000) for _ in range(3)]
    jagg = jpar.ShardedWindowAggregator(JWConfig(batch_size=128), jm)
    tagg = tpar.ShardedWindowAggregator(WindowAggConfig(batch_size=128), tm)
    for b in batches:
        jagg.update(b)
        tagg.update(_port(b))
    _equal_rows(jagg.flush(force=True), tagg.flush(force=True))
    assert shard_step["n"] == 3 * 8
    assert len(exact_steps) == 8  # every shard of the one flagged chunk


# ---- heavy hitters -----------------------------------------------------------


@pytest.mark.parametrize("n", SIZES)
def test_heavy_hitter_merged_state_top_and_reset_match(meshes, n):
    jm, tm = meshes[n]
    cfg = dict(batch_size=256, width=1 << 10, capacity=64)
    jhh = jpar.ShardedHeavyHitter(JHHConfig(**cfg), jm)
    thh = tpar.ShardedHeavyHitter(HeavyHitterConfig(**cfg), tm)
    batches = _zipf_batches(53, 3, 3000)
    for b in batches:
        jhh.update(b)
        thh.update(_port(b))
    want, got = jhh.merged_state(), thh.merged_state()
    assert float(np.asarray(want.cms).max()) < 2 ** 24  # integer envelope
    np.testing.assert_array_equal(got.cms.numpy(), np.asarray(want.cms))
    np.testing.assert_array_equal(
        got.table_keys.numpy().astype(np.uint32), np.asarray(want.table_keys))
    np.testing.assert_array_equal(got.table_vals.numpy(),
                                  np.asarray(want.table_vals))
    # a shard's own state too (no merge hides a per-shard difference)
    np.testing.assert_array_equal(thh.state.cms.numpy(),
                                  np.asarray(jhh.state.cms))
    _equal_rows(jhh.top(10), thh.top(10))
    assert thh.chunk_updates == 3 * -(-3000 // (256 * n)) * n
    # the reference's own check: the exact top talker pair
    top = thh.top(1)
    want_top = oracle.topk_exact(FlowBatch.concat([_port(b)
                                                   for b in batches]),
                                 ["src_addr", "dst_addr"], 1)
    assert (top["src_addr"][0] == want_top["src_addr"][0]).all()
    assert (top["dst_addr"][0] == want_top["dst_addr"][0]).all()
    # reset: fresh shards, then the next window equal again
    jhh.reset()
    thh.reset()
    assert not thh.top(5)["valid"].any()
    assert all(s.cms.sum() == 0 for s in thh.states)
    jhh.update(batches[0])
    thh.update(_port(batches[0]))
    _equal_rows(jhh.top(10), thh.top(10))


def test_heavy_hitter_matches_oracle_and_single_model(meshes):
    """The reference's own checks: the top-10 of the sharded table are
    the exact top-10 within 1 %, and the linear sketch's shard sum is
    the single model's sketch."""
    _, tm = meshes[8]
    cfg = HeavyHitterConfig(batch_size=512, width=1 << 13, capacity=256)
    batches = [_port(b) for b in _zipf_batches(53, 4, 4096, n_keys=500)]
    m = tpar.ShardedHeavyHitter(cfg, tm)
    for b in batches:
        m.update(b)
    top = m.top(10)
    want = oracle.topk_exact(FlowBatch.concat(batches),
                             ["src_addr", "dst_addr"], 10)
    for i in range(10):
        assert (top["src_addr"][i] == want["src_addr"][i]).all()
        assert (top["dst_addr"][i] == want["dst_addr"][i]).all()
        assert abs(float(top["bytes"][i]) - float(want["bytes"][i])) \
            <= 0.01 * float(want["bytes"][i])
    linear = HeavyHitterConfig(batch_size=512, width=1 << 12, capacity=64,
                               conservative=False)
    batch = _port(_zipf_batches(54, 1, 4096, n_keys=100, alpha=1.2)[0])
    sharded = tpar.ShardedHeavyHitter(linear, tm)
    sharded.update(batch)
    from flow_pipeline_tpu_torch.models import HeavyHitterModel

    single = HeavyHitterModel(linear, device="cpu")
    single.update(batch)
    np.testing.assert_array_equal(sharded.merged_state().cms.numpy(),
                                  single.state.cms.numpy())


def test_heavy_hitter_refuses_the_invertible_family():
    with pytest.raises(ValueError, match="table family"):
        tpar.ShardedHeavyHitter(HeavyHitterConfig(hh_sketch="invertible"),
                                tpar.make_mesh(2, devices="cpu"))


# ---- DDoS --------------------------------------------------------------------


def _ddos_pair(meshes, n, **cfg):
    jm, tm = meshes[n]
    return (jpar.ShardedDDoSDetector(JDDoSConfig(**cfg), jm),
            tpar.ShardedDDoSDetector(DDoSConfig(**cfg), tm))


def _same_ddos(jdet, tdet) -> None:
    assert len(tdet.alerts) == len(jdet.alerts)
    for a, b in zip(jdet.alerts, tdet.alerts):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]),
                                          err_msg=k)
    for f, want, got in zip(jdet.state._fields, jdet.state, tdet.state):
        want = np.asarray(want)
        np.testing.assert_array_equal(got.numpy().astype(want.dtype), want,
                                      err_msg=f)


@pytest.mark.parametrize("n", SIZES)
def test_ddos_detects_the_flood_as_reference(meshes, n):
    jdet, tdet = _ddos_pair(meshes, n, batch_size=256, n_buckets=1 << 10,
                            sub_window_seconds=10)
    g = FlowGenerator(MockerProfile(), seed=77, t0=1_699_999_800,
                      rate=300.0)
    for i in range(9):
        b = g.batch(3000)
        if i >= 7:
            hot = (b.columns["dst_addr"][:, 3] & 0xFF) == 13
            b.columns["packets"][hot] *= 60
        jdet.update(b)
        tdet.update(_port(b))
    jdet.close_sub_window()
    tdet.close_sub_window()
    assert tdet.alerts, "the sharded detector must find the flood"
    assert any(int(a["dst_addr"][3]) & 0xFF == 13 for a in tdet.alerts)
    _same_ddos(jdet, tdet)
    # every shard holds the replicated state after the close
    for s in tdet.states[1:]:
        for f, a, b in zip(s._fields, tdet.states[0], s):
            assert torch.equal(a, b), f


def test_ddos_quiet_on_steady(meshes):
    jdet, tdet = _ddos_pair(meshes, 8, batch_size=256, n_buckets=1 << 10,
                            sub_window_seconds=10)
    g = FlowGenerator(MockerProfile(), seed=78, t0=1_699_999_800,
                      rate=300.0)
    for _ in range(8):
        b = g.batch(3000)
        jdet.update(b)
        tdet.update(_port(b))
    jdet.close_sub_window()
    tdet.close_sub_window()
    assert tdet.alerts == []
    _same_ddos(jdet, tdet)


def test_ddos_hist_mass_stays_linear(meshes):
    """The replicated histogram is not summed at a close (the reference's
    regression: summing multiplied its mass by N per window)."""
    cfg = dict(batch_size=256, n_buckets=256, sub_window_seconds=10)
    jdet, tdet = _ddos_pair(meshes, 8, **cfg)
    single = DDoSDetector(DDoSConfig(**cfg), device="cpu")
    g = FlowGenerator(MockerProfile(), seed=81, t0=1_699_999_800,
                      rate=300.0)
    for _ in range(6):
        b = g.batch(3000)
        jdet.update(b)
        tdet.update(_port(b))
        single.update(_port(b))
    for det in (jdet, tdet, single):
        det.close_sub_window()
    assert float(tdet.states[0].hist.sum()) == pytest.approx(
        float(single.state.hist.sum()), rel=1e-6)
    _same_ddos(jdet, tdet)


@pytest.mark.parametrize("n", SIZES)
def test_ddos_witness_is_the_heaviest_shards(meshes, n):
    """Two destinations of one bucket in different shards: a flood of
    1-packet flows to A (largest per-dst sum in its shard) and one
    50-packet flow to B in another; the witness is the shard with the
    largest wmax, as the reference picks it (and a tie the first)."""
    from flow_pipeline_tpu_torch.ops.ewma import bucket_of

    cand = np.zeros((512, 4), dtype=np.uint32)
    cand[:, 3] = np.arange(512)
    b = bucket_of(torch.from_numpy(cand.astype(np.int64)), 64).numpy()
    a_idx, b_idx = next((int(js[0]), int(js[1])) for js in
                        (np.flatnonzero(b == b[i]) for i in range(512))
                        if len(js) > 1)
    per = 64
    for flood in (400, 50):  # A heavier than B, then a tie (50 and 50)
        jdet, tdet = _ddos_pair(meshes, n, batch_size=per, n_buckets=64,
                                sub_window_seconds=10, warmup_windows=0)
        batch = FlowBatch.empty(per * n)
        batch.columns["time_received"][:] = 1_699_999_800
        # shard 1 holds the other flow to B, shard n-1 the flood to A
        batch.columns["dst_addr"][per:per + 1] = cand[b_idx]
        batch.columns["packets"][per] = 50
        rows = slice(per * (n - 1), per * (n - 1) + 50)
        batch.columns["dst_addr"][rows] = cand[a_idx]
        batch.columns["packets"][rows] = flood // 50
        from flow_pipeline_tpu.schema.batch import FlowBatch as JBatch

        jdet.update(JBatch({k: v.copy() for k, v in batch.columns.items()}))
        tdet.update(batch)
        jdet.close_sub_window()
        tdet.close_sub_window()
        want = cand[a_idx] if flood > 50 else cand[b_idx]
        assert tdet.states[0].addrs[b[a_idx]].tolist() == want.tolist()
        _same_ddos(jdet, tdet)


# ---- port tables -------------------------------------------------------------


@pytest.mark.parametrize("n", SIZES)
def test_dense_totals_and_top_match(meshes, n):
    jm, tm = meshes[n]
    for col in ("src_port", "dst_port"):
        jd = jpar.ShardedDenseTopK(JDenseConfig(key_col=col, batch_size=128),
                                   jm)
        td = tpar.ShardedDenseTopK(DenseTopConfig(key_col=col,
                                                  batch_size=128), tm)
        batches = _zipf_batches(56, 2, 1500)
        for b in batches:
            jd.update(b)
            td.update(_port(b))
        np.testing.assert_array_equal(td.totals.numpy(),
                                      np.asarray(jd.totals))
        _equal_rows(jd.top(20), td.top(20))
        want = oracle.exact_groupby(FlowBatch.concat([_port(b)
                                                      for b in batches]),
                                    [col], ["bytes"])
        top = td.top(1)
        assert top["bytes"][0] == want["bytes"].max()


# ---- interop: the reference's stacked states into the port's shards ---------


def test_stacked_states_cross_packages(meshes):
    """Each sharded state of the JAX package, as numpy, loads into the
    port's shards; one more batch later both packages merge to the same
    state."""
    jm, tm = meshes[4]
    batches = _zipf_batches(57, 2, 2048)
    cfg = dict(batch_size=256, width=1 << 10, capacity=64)
    jhh = jpar.ShardedHeavyHitter(JHHConfig(**cfg), jm)
    thh = tpar.ShardedHeavyHitter(HeavyHitterConfig(**cfg), tm)
    # a fresh state replicated onto the shard axis, as the reference
    # stacks it
    from flow_pipeline_tpu.models import heavy_hitter as jhh_mod
    from flow_pipeline_tpu_torch.models import heavy_hitter as thh_mod

    for want, got in zip(
            jpar.sharded.stack_state(jhh_mod.hh_init(JHHConfig(**cfg)), 4),
            tsharded.stack_state(thh_mod.hh_init(HeavyHitterConfig(**cfg),
                                                 "cpu"), 4)):
        np.testing.assert_array_equal(got.numpy().astype(want.dtype),
                                      np.asarray(want))
    jhh.update(batches[0])
    thh.states = interop.hh_shards_from_reference(
        *(np.asarray(a) for a in jhh.state), tm.devices)
    jhh.update(batches[1])
    thh.update(_port(batches[1]))
    _equal_rows(jhh.top(20), thh.top(20))
    back = interop.hh_shards_to_reference(thh.states)
    for want, got in zip(jhh.state, back):
        np.testing.assert_array_equal(got, np.asarray(want))

    jd = jpar.ShardedDenseTopK(JDenseConfig(batch_size=256), jm)
    td = tpar.ShardedDenseTopK(DenseTopConfig(batch_size=256), tm)
    jd.update(batches[0])
    td.shard_totals = interop.dense_shards_from_reference(
        np.asarray(jd.totals), tm.devices)
    jd.update(batches[1])
    td.update(_port(batches[1]))
    np.testing.assert_array_equal(
        interop.dense_shards_to_reference(td.shard_totals),
        np.asarray(jd.totals))

    dcfg = dict(batch_size=256, n_buckets=1 << 10, sub_window_seconds=10,
                warmup_windows=0)
    jdet = jpar.ShardedDDoSDetector(JDDoSConfig(**dcfg), jm)
    tdet = tpar.ShardedDDoSDetector(DDoSConfig(**dcfg), tm)
    g = FlowGenerator(MockerProfile(), seed=58, t0=1_699_999_800,
                      rate=300.0)
    first, second = g.batch(3000), g.batch(3000)
    jdet.update(first)
    tdet.states = interop.ddos_shards_from_reference(
        *(np.asarray(a) for a in jdet.state), devices=tm.devices)
    tdet.current_sub, tdet.folds = jdet.current_sub, jdet.folds
    jdet.update(second)
    tdet.update(_port(second))
    jdet.close_sub_window()
    tdet.close_sub_window()
    _same_ddos(jdet, tdet)
    with pytest.raises(ValueError, match="shards for"):
        interop.hh_shards_from_reference(
            *(np.asarray(a) for a in jhh.state), tm.devices[:2])


# ---- entries ------------------------------------------------------------------


def test_pipeline_with_mesh(tmp_path):
    """The reference's test_sink_cli.py pipeline run with -processor.mesh
    8: every flow in flows_5m, a top_talkers table written."""
    db = tmp_path / "mesh.db"
    assert tcli.main([
        "pipeline", "-device", "cpu", "-produce.count", "2000",
        "-produce.rate", "40", "-processor.batch", "128",
        "-processor.mesh", "8", "-sink", f"sqlite:{db}",
        "-metrics.addr", "", "-model.ddos=false",
        "-sketch.width", str(1 << 12), "-sketch.capacity", "64"]) == 0
    conn = sqlite3.connect(db)
    try:
        assert conn.execute(
            "SELECT SUM(count) FROM flows_5m").fetchone()[0] == 2000
        assert conn.execute(
            "SELECT COUNT(*) FROM top_talkers").fetchone()[0] > 0
    finally:
        conn.close()


@pytest.mark.parametrize("argv", [
    ["processor", "-hh.sketch", "invertible"],
    ["processor", "-spread.enabled"],
    ["pipeline", "-spread.enabled"],
    ["pipeline", "-mesh.workers", "2"],
], ids=["invertible", "spread", "pipeline-spread", "mesh-workers"])
def test_mesh_refusals_exit_2_in_both_packages(tmp_path, argv, capsys):
    cmd, *flags = argv
    frames = tmp_path / "f.bin"
    frames.write_bytes(b"")
    src = ["-in", str(frames)] if cmd == "processor" else [
        "-produce.count", "100"]
    args = [cmd, *src, "-processor.mesh", "2", "-metrics.addr", "", *flags]
    assert jcli.main([*args, "-processor.backend", "cpu"]) == 2
    want = capsys.readouterr().err.strip().splitlines()[-1]
    assert tcli.main([*args, "-device", "cpu"]) == 2
    got = capsys.readouterr().err.strip().splitlines()[-1]
    assert got == want and "-processor.mesh" in got
