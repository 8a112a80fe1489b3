"""The port's host sketch backend (hostsketch/: the engine, its numpy
twins, the native fpt_hs_* kernels, the state conversions and
HostSketchPipeline) against the JAX package's, on the CPU.

The reference side runs its numpy twins (hostsketch/engine.py np_*,
HostSketchEngine(use_native="numpy"), HostSketchPipeline with
sketch_native="numpy"), which need no native library, so no comparison
skips when the reference's libflowdecode.so is absent; where that
library is built the reference's own kernels are held against the port's
too. Every test is bit for bit (tolerance: none): sums stay inside the
2^24 integer envelope, where the f32 and u64 monoids coincide.

Invertible inputs draw the count plane >= 1, as the pipeline makes it
(one per flow, grouped). A row with count 0 adds its value planes
without touching the count, keysum or keycheck planes, so a bucket can
look pure while it carries another key's value; then the reference's
numpy decode (rounds, lowest depth row first) and its native kernel (a
LIFO work list) report different rows' values. The property test is
derandomized, so it draws the same examples on every run.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from flow_pipeline_tpu import native as jnative
from flow_pipeline_tpu.hostsketch import HostSketchPipeline as JHSP
from flow_pipeline_tpu.hostsketch import engine as jeng
from flow_pipeline_tpu.hostsketch import state as jstate
from flow_pipeline_tpu.models import heavy_hitter as jhh
from flow_pipeline_tpu_torch import native
from flow_pipeline_tpu_torch.engine import WindowedHeavyHitter as TWindowed
from flow_pipeline_tpu_torch.hostsketch import HostSketchPipeline as THSP
from flow_pipeline_tpu_torch.hostsketch import engine as teng
from flow_pipeline_tpu_torch.hostsketch import state as tstate
from flow_pipeline_tpu_torch.models import heavy_hitter as thh
from flow_pipeline_tpu_torch.obs.metrics import REGISTRY

from test_torch_fused import (BS, TALKERS, _flush_all, _models, _port_batch,
                              _stream)
from test_torch_hostfused import _assert_rows_equal
import torch_cpu  # noqa: F401  (one torch thread; see the module)

P, D, W = 3, 4, 1 << 10  # planes (bytes, packets, count), depth, width


def _keys(rng, n, kw, pool=None):
    """n unique uint32 key rows (from ``pool`` when given)."""
    if pool is not None:
        return pool[rng.choice(len(pool), n, replace=False)]
    keys = np.unique(rng.integers(0, 2**32, (n + 16, kw), dtype=np.uint32),
                     axis=0)[:n]
    return keys[rng.permutation(len(keys))]


def _sums(rng, n, lo=1):
    """[n, P] float32 integer-valued sums, the count plane >= ``lo``."""
    s = rng.integers(0, 900, (n, P)).astype(np.float32)
    s[:, -1] = rng.integers(lo, 20, n)
    return s


def test_addend_u64_matches_reference():
    rng = np.random.default_rng(0)
    v = np.concatenate([
        rng.integers(0, 2**24, 200).astype(np.float32),
        np.array([np.nan, -1.0, -0.0, 0.0, 0.5, 1.5, np.inf, -np.inf,
                  2.0**63, 2.0**64, 3e19, 1.8446742e19], np.float32)])
    assert np.array_equal(teng._addend_u64(v), jeng._addend_u64(v))


@pytest.mark.parametrize("route", ["native", "numpy", "numpy-grouped"])
@pytest.mark.parametrize("conservative", [True, False])
def test_cms_update_and_query_match_reference(route, conservative,
                                              monkeypatch):
    """Rounds of updates on one sketch, then the point query: the port's
    native kernels and numpy twins (both scatter forms) against the
    reference's numpy twin."""
    monkeypatch.setattr(teng, "_GROUPED_SCATTER", route == "numpy-grouped")
    rng = np.random.default_rng(3 + conservative)
    got = np.zeros((P, D, W), np.uint64)
    want = got.copy()
    pool = _keys(rng, 3000, 11)
    for r in range(4):
        keys = _keys(rng, 2500, 11, pool)
        vals = _sums(rng, len(keys))
        if route == "native":
            native.hs_cms_update(got, keys, vals, None, conservative,
                                 threads=1 + 3 * (r % 2))
        else:
            teng.np_cms_update(got, keys, vals, conservative)
        jeng.np_cms_update(want, keys, vals, conservative)
        assert np.array_equal(got, want)
    q = _keys(rng, 500, 11, pool)
    est = (native.hs_cms_query(got, q, threads=4) if route == "native"
           else teng.np_cms_query(got, q))
    assert est.dtype == np.float32
    assert np.array_equal(est, jeng.np_cms_query(want, q))
    if jnative.sketch_available():  # the reference's own kernels
        ref = np.zeros_like(want)
        rng = np.random.default_rng(3 + conservative)
        pool = _keys(rng, 3000, 11)
        for r in range(4):
            keys = _keys(rng, 2500, 11, pool)
            jnative.hs_cms_update(ref, keys, _sums(rng, len(keys)), None,
                                  conservative)
        assert np.array_equal(ref, want)


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_prefilter_matches_reference(route):
    """The top 2C candidates with the table's residents boosted, lowest
    index first on ties (plane-0 sums drawn from a few values, so ties
    are many)."""
    rng = np.random.default_rng(5)
    cap, kw = 64, 4
    cand = _keys(rng, 600, kw)
    table = np.full((cap, kw), 0xFFFFFFFF, np.uint32)
    table[:40] = cand[rng.choice(600, 40, replace=False)]
    sums = _sums(rng, 600)
    sums[:, 0] = rng.integers(0, 5, 600)
    want = jeng.HostSketchEngine([jhh.HeavyHitterConfig(capacity=cap)],
                                 use_native="numpy")._prefilter(
        jstate.HostHHState(None, table, None), cand, sums, cap, 1)
    eng = teng.HostSketchEngine([thh.HeavyHitterConfig(capacity=cap)],
                                use_native=route)
    got = eng._prefilter(tstate.HostHHState(None, table, None), cand, sums,
                         cap, 4)
    assert len(want) == 2 * cap
    assert np.array_equal(np.asarray(got, np.int64),
                          np.asarray(want, np.int64))


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_topk_merge_matches_reference(route):
    """Rounds of admission merges: residents take their sums, new keys
    their estimates, ranked by plane 0 with lexicographic ties; sentinel
    candidates are dropped."""
    rng = np.random.default_rng(7)
    cap, kw = 32, 2
    pool = rng.integers(0, 50, (200, kw)).astype(np.uint32)
    pool = np.unique(pool, axis=0)
    tk = np.full((cap, kw), 0xFFFFFFFF, np.uint32)
    tv = np.zeros((cap, P), np.float32)
    wk, wv = tk.copy(), tv.copy()
    for _ in range(5):
        cand = _keys(rng, 60, kw, pool)
        cand[0] = 0xFFFFFFFF
        sums = _sums(rng, 60)
        sums[:, 0] = rng.integers(0, 4, 60) * 100  # ties
        est = sums + rng.integers(0, 50, (60, P)).astype(np.float32)
        if route == "native":
            native.hs_topk_merge(tk, tv, cand, sums, est, None)
        else:
            tk, tv = teng.np_topk_merge(tk, tv, cand, sums, est)
        wk, wv = jeng.np_topk_merge(wk, wv, cand, sums, est)
        assert np.array_equal(tk, wk) and np.array_equal(tv, wv)


def _family(kind):
    kw = dict(key_cols=TALKERS, width=W, capacity=64, batch_size=BS)
    if kind == "conservative":
        return kw
    if kind == "linear-plain":
        return dict(kw, conservative=False, table_admission="plain")
    return dict(kw, key_cols=("src_addr",), hh_sketch="invertible")


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("kind", ["conservative", "linear-plain",
                                  "invertible"])
def test_engine_update_matches_reference(route, kind):
    """HostSketchEngine.update over padded group tables (B > 2C, so the
    prefilter runs; the last round under 2048 groups, the others above,
    which changes the native thread count): the same state as the
    reference's numpy engine, round after round."""
    cfg = _family(kind)
    eng = teng.HostSketchEngine([thh.HeavyHitterConfig(**cfg)],
                                use_native=route, threads=4)
    ref = jeng.HostSketchEngine([jhh.HeavyHitterConfig(**cfg)],
                                use_native="numpy")
    kw = 11 if kind != "invertible" else 4
    rng = np.random.default_rng(len(kind))
    pool = _keys(rng, 6000, kw)
    for g, b in ((3000, 4096), (2500, 4096), (700, 1024)):
        u = np.zeros((b, kw), np.uint32)
        s = np.zeros((b, P), np.float32)
        u[:g] = _keys(rng, g, kw, pool)
        s[:g] = _sums(rng, g)
        eng.update(0, u, s, g)
        ref.update(0, u, s, g)
        got, want = eng.states[0], ref.states[0]
        fields = ("cms", "keysum", "keycheck") if kind == "invertible" \
            else ("cms", "table_keys", "table_vals")
        for f in fields:
            assert np.array_equal(getattr(got, f), getattr(want, f)), f
    eng.update(0, u, s, 0)  # an all-invalid chunk is a no-op
    assert np.array_equal(eng.states[0].cms, ref.states[0].cms)


@pytest.mark.parametrize("threads", [1, 4])
def test_inv_update_and_decode_match_reference(threads):
    """The native fpt_hs_inv_update and fpt_hs_inv_decode against the
    reference's np_inv_update and np_inv_decode (heavy keys decoded with
    their exact sums, in lexicographic order), and the port's numpy
    twins against both."""
    rng = np.random.default_rng(11)
    kw, width = 4, 256
    cms = np.zeros((P, D, width), np.uint64)
    st_t = tstate.HostInvState(cms, np.zeros((D, width, kw), np.uint64),
                               np.zeros((D, width), np.uint64))
    st_n = tstate.HostInvState(cms.copy(), st_t.keysum.copy(),
                               st_t.keycheck.copy())
    st_j = jstate.HostInvState(cms.copy(), st_t.keysum.copy(),
                               st_t.keycheck.copy())
    pool = _keys(rng, 300, kw)
    for _ in range(3):
        keys = _keys(rng, 120, kw, pool)
        vals = _sums(rng, 120)
        native.hs_inv_update(st_t.cms, st_t.keysum, st_t.keycheck, keys,
                             vals, None, threads)
        teng.np_inv_update(st_n, keys, vals)
        jeng.np_inv_update(st_j, keys, vals)
    for f in ("cms", "keysum", "keycheck"):
        assert np.array_equal(getattr(st_t, f), getattr(st_j, f)), f
        assert np.array_equal(getattr(st_n, f), getattr(st_j, f)), f
    want_k, want_v = jeng.np_inv_decode(st_j.cms, st_j.keysum,
                                        st_j.keycheck)
    assert len(want_k) > 100  # most of the pool decodes at this width
    for use_native in (True, False):
        got_k, got_v = teng.inv_decode_state(st_t, use_native=use_native)
        assert np.array_equal(got_k, want_k)
        assert np.array_equal(got_v, want_v)
    if jnative.inv_available():
        ref_k, ref_v = jeng.inv_decode_state(st_j)
        assert np.array_equal(ref_k, want_k) and np.array_equal(ref_v,
                                                                want_v)


@settings(derandomize=True, max_examples=40, deadline=None)
@given(seed=st.integers(0, 2**16), n=st.integers(1, 60),
       vmax=st.integers(2, 50))
def test_inv_property_random_streams_bit_exact(seed, n, vmax):
    """Random streams (keys from a small pool, so they repeat across
    updates; value planes in [0, vmax), the count plane in [1, vmax]):
    the port's native update and decode equal the reference's numpy
    twins."""
    rng = np.random.default_rng(seed)
    kw, width = 2, 64
    pool = rng.integers(0, 40, (80, kw)).astype(np.uint32)
    st_t = tstate.HostInvState(np.zeros((P, 2, width), np.uint64),
                               np.zeros((2, width, kw), np.uint64),
                               np.zeros((2, width), np.uint64))
    st_j = jstate.HostInvState(st_t.cms.copy(), st_t.keysum.copy(),
                               st_t.keycheck.copy())
    for _ in range(3):
        keys = np.unique(pool[rng.integers(0, len(pool), n)], axis=0)
        vals = rng.integers(0, vmax, (len(keys), P)).astype(np.float32)
        vals[:, -1] = rng.integers(1, vmax + 1, len(keys))
        native.hs_inv_update(st_t.cms, st_t.keysum, st_t.keycheck, keys,
                             vals, None, 2)
        jeng.np_inv_update(st_j, keys, vals)
    for f in ("cms", "keysum", "keycheck"):
        assert np.array_equal(getattr(st_t, f), getattr(st_j, f))
    got = teng.inv_decode_state(st_t)
    want = jeng.np_inv_decode(st_j.cms, st_j.keysum, st_j.keycheck)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


def test_inv_extract_matches_reference():
    rng = np.random.default_rng(13)
    st_j = jstate.host_inv_init(jhh.HeavyHitterConfig(
        key_cols=("src_addr",), width=512, hh_sketch="invertible"))
    keys = _keys(rng, 200, 4)
    keys[0] = 0xFFFFFFFF  # the sentinel key decodes, then is dropped
    vals = _sums(rng, 200)
    vals[:20, 0] = 500  # ties in the primary
    jeng.np_inv_update(st_j, keys, vals)
    for cap in (16, 256):
        got = teng.inv_extract(st_j, cap)
        want = jeng.inv_extract(st_j, cap)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])


def test_state_conversions_match_reference():
    """f32 -> u64 import exact for integer cells and clamped outside the
    envelope as the reference clamps; the torch export is the reference's
    f32 export, and a round trip returns the same buffers."""
    rng = np.random.default_rng(17)
    cms = rng.integers(0, 2**24, (P, D, W)).astype(np.float32)
    keys = rng.integers(0, 2**32, (64, 11), dtype=np.uint32)
    vals = rng.integers(0, 5000, (64, P)).astype(np.float32)
    jst = jhh.HHState(cms, keys, vals)
    tst = thh.HHState(torch.from_numpy(cms), torch.from_numpy(
        keys.astype(np.int64)), torch.from_numpy(vals))
    host = tstate.from_device_state(tst)
    want = jstate.from_device_state(jst)
    for f in ("cms", "table_keys", "table_vals"):
        assert np.array_equal(getattr(host, f), getattr(want, f)), f
        assert getattr(host, f).flags["C_CONTIGUOUS"]
    back = tstate.to_device_state(host, torch.device("cpu"))
    assert np.array_equal(back.cms.numpy(), cms)
    assert back.table_keys.dtype == torch.int64
    assert np.array_equal(back.table_keys.numpy().astype(np.uint32), keys)
    assert np.array_equal(tstate.frozen_cms(tst), jstate.frozen_cms(jst))
    bad = cms.copy()
    bad[0, 0, :6] = [np.nan, -5.0, np.inf, -np.inf, 3e19, 2.0**64]
    assert np.array_equal(tstate._cms_to_u64(torch.from_numpy(bad)),
                          jstate._cms_to_u64(bad))
    inv = tstate.host_inv_init(thh.HeavyHitterConfig(
        key_cols=("src_addr",), width=W, hh_sketch="invertible"))
    inv.keycheck[0, 0] = 2**64 - 1  # past 2^24: never through float
    out = tstate.to_device_state(inv, torch.device("cpu"))
    assert isinstance(out, thh.InvState)
    again = tstate.from_device_state(out._asdict())
    assert again.keycheck[0, 0] == 2**64 - 1
    assert tstate.is_inv_state(out) and not tstate.is_inv_state(tst)


def _hs_models(port: bool, invertible: bool, sub_seconds=10):
    """The default model set of test_torch_fused, the two cascade families
    (src, dst) invertible when asked (what -hh.sketch auto picks)."""
    models = _models("default", port=port, sub_seconds=sub_seconds)
    if invertible:
        for name in ("top_src_ips", "top_dst_ips"):
            m = models[name]
            cfg = m.config.__class__(**{**m.config.__dict__,
                                        "hh_sketch": "invertible"})
            models[name] = (TWindowed(cfg, k=30, device="cpu") if port
                            else type(m)(cfg, k=30))
    return models


@pytest.mark.parametrize("invertible", [False, True],
                         ids=["table", "invertible"])
@pytest.mark.parametrize("sub_seconds", [10, 300])
def test_pipeline_matches_reference(invertible, sub_seconds):
    """HostSketchPipeline.prepare/apply across slot rolls, sub-window
    closes and late rows: the port's fused pass, its staged engine and
    its numpy engine flush the rows of the reference's (numpy engine,
    staged), every table; the cascade families on the invertible sketch
    too. No CMS kernel runs (chunk_updates stay 0), and the native
    features publish native_path_degraded 0."""
    batches = _stream(seed=7, n_keys=100)
    ref = _hs_models(False, invertible, sub_seconds)
    jpipe = JHSP(ref, sketch_native="numpy", fused="off")
    runs = {}
    for mode in ("fused", "staged", "numpy"):
        models = _hs_models(True, invertible, sub_seconds)
        pipe = THSP(models, native_group=mode != "numpy",
                    sketch_native="numpy" if mode == "numpy" else "native",
                    fused="auto" if mode == "fused" else "off", threads=3)
        assert pipe._fused == (mode == "fused")
        assert pipe._fam_plan == jpipe._fam_plan
        runs[mode] = (pipe, models)
    for b in batches:
        jpipe.update(b)
        for pipe, _ in runs.values():
            pipe.apply(pipe.prepare(_port_batch(b)))
    jpipe.sync_states()  # the forced close reads model state
    want = _flush_all(ref)
    for mode, (pipe, models) in runs.items():
        for name in ref:
            assert getattr(models[name], "late_flows_dropped", 0) == \
                getattr(ref[name], "late_flows_dropped", 0), (mode, name)
        assert all(m.model.chunk_updates == 0 for m in models.values()
                   if hasattr(getattr(m, "model", None), "chunk_updates"))
        pipe.sync_states()
        _assert_rows_equal(_flush_all(models), want)
    lines = REGISTRY.render().splitlines()
    for feature in ("sketch", "lanes", "fused"):
        assert f'native_path_degraded{{feature="{feature}"}} 0' in lines
    if invertible:
        assert 'native_path_degraded{feature="invsketch"} 0' in lines
    assert any(line.startswith("host_fused_phase_ns_total{") and
               not line.endswith(" 0") for line in lines)


def test_pipeline_adopts_replaced_state():
    """The engine's buffers mirror model.state by identity: a state the
    model had replaced (reset, restore) is imported before the next fold,
    and sync_states exports fresh state objects on the models' device."""
    batches = _stream(seed=5, n_keys=100, late=False)
    models = _hs_models(True, True)
    pipe = THSP(models, fused="off")
    pipe.update(_port_batch(batches[0]))
    talkers = models["top_talkers"].model
    before = talkers.state
    pipe.sync_states()
    assert talkers.state is not before
    assert isinstance(talkers.state, thh.HHState)
    assert isinstance(models["top_src_ips"].model.state, thh.InvState)
    assert np.array_equal(talkers.state.cms.numpy(),
                          pipe._engine.states[0].cms.astype(np.float32))
    pipe.sync_states()  # nothing folded since: the same objects
    assert pipe._shadow[0] is talkers.state
    talkers.reset()
    pipe.update(_port_batch(batches[1]))
    assert pipe._shadow[0] is not None and \
        pipe._engine.states[0].cms[-1, 0].sum() <= len(batches[1])


def test_per_model_invertible_matches_reference():
    """The invertible family updated on its own (the per-model path):
    every window's rows equal the reference's, values the exact sums."""
    batches = _stream(seed=9, n_keys=100)
    cfg = dict(key_cols=("dst_addr",), batch_size=BS, width=W, capacity=64,
               hh_sketch="invertible")
    tm = TWindowed(thh.HeavyHitterConfig(**cfg), k=30, device="cpu")
    jm = type(_hs_models(False, False)["top_talkers"])(
        jhh.HeavyHitterConfig(**cfg), k=30)
    for b in batches:
        jm.update(b)
        tm.update(_port_batch(b))
    _assert_rows_equal({"t": tm.flush(True)}, {"t": jm.flush(True)})


@pytest.mark.parametrize("threads", [1, 4])
def test_spread_fold_native_matches_numpy(threads):
    """fpt_hs_spread_update equals the reference's numpy register fold."""
    rng = np.random.default_rng(19)
    regs = np.zeros((2, 512, 64), np.uint8)
    want = regs.copy()
    for _ in range(3):
        keys = rng.integers(0, 300, (5000, 4)).astype(np.uint32)
        elems = rng.integers(0, 2**32, (5000, 1), dtype=np.uint32)
        teng.spread_apply_update(regs, keys, elems, threads=threads)
        jeng.np_spread_update(want, keys, elems)
    assert np.array_equal(regs, want)


def test_missing_native_feature_raises(monkeypatch):
    """Where the reference degrades to numpy, the port raises: a native
    feature that cannot serve publishes native_path_degraded 1 and the
    pipeline refuses to start; -ingest.fused on needs the native
    engine."""
    models = _hs_models(True, False)
    monkeypatch.setattr(native, "fused_available", lambda: False)
    with pytest.raises(RuntimeError, match="fused"):
        THSP(models, fused="auto")
    assert 'native_path_degraded{feature="fused"} 1' in \
        REGISTRY.render().splitlines()
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match="not native"):
        THSP(_hs_models(True, False), sketch_native="numpy", fused="on")
    THSP(_hs_models(True, False), fused="auto")  # serving again
    assert 'native_path_degraded{feature="fused"} 0' in \
        REGISTRY.render().splitlines()


def test_restore_skips_a_family_mismatch(caplog):
    """A table-family checkpoint entry restored into an invertible model
    (or the other way round) is skipped loudly, its state untouched; a
    matching invertible entry restores its exact uint64 planes."""
    from flow_pipeline_tpu_torch.engine import worker as tworker

    cfg = dict(key_cols=("src_addr",), width=W, capacity=8, batch_size=BS)
    table = TWindowed(thh.HeavyHitterConfig(**cfg), k=4, device="cpu")
    inv = TWindowed(thh.HeavyHitterConfig(**cfg, hh_sketch="invertible"),
                    k=4, device="cpu")
    inv.model.state.keycheck[0, 0] = 2**64 - 1

    def entry(model):  # as the checkpoint loader decodes it
        ms = tworker.save_hh_state(model)
        return {**ms, "hh": ms["hh"]._asdict(), "current_slot": 600}

    for model, other in ((inv, table), (table, inv)):
        before = model.model.state
        caplog.clear()
        with caplog.at_level("WARNING"):
            tworker.restore_hh_state(model, entry(other), "fam")
        assert model.model.state is before and "skipping" in caplog.text
    fresh = TWindowed(thh.HeavyHitterConfig(**cfg, hh_sketch="invertible"),
                      k=4, device="cpu")
    tworker.restore_hh_state(fresh, entry(inv), "fam")
    assert fresh.current_slot == 600
    assert fresh.model.state.keycheck.dtype == np.uint64
    assert fresh.model.state.keycheck[0, 0] == 2**64 - 1
