"""Port parity: top-K merge and the heavy-hitter model (conservative and
linear CMS updates), torch (CPU) against the JAX package, over several
batches. Integer-valued inputs below 2^24 make every table value and
estimate bit-equal (tolerance: none).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_pipeline_tpu.gen import FlowGenerator as JGen
from flow_pipeline_tpu.gen import ZipfProfile as JZipf
from flow_pipeline_tpu.models import heavy_hitter as jhh
from flow_pipeline_tpu.ops import topk as jtopk
from flow_pipeline_tpu_torch import interop
from flow_pipeline_tpu_torch.gen import FlowGenerator as TGen
from flow_pipeline_tpu_torch.gen import ZipfProfile as TZipf
from flow_pipeline_tpu_torch.models import heavy_hitter as thh
from flow_pipeline_tpu_torch.ops import topk as ttopk
from flow_pipeline_tpu_torch.schema.batch import FlowBatch as TBatch
import torch_cpu  # noqa: F401  (one torch thread; see the module)

TALKERS = ("src_addr", "dst_addr", "src_port", "dst_port", "proto")


def _batches(n_batches, size, n_keys=400, seed=0):
    gen = JGen(JZipf(n_keys=n_keys, alpha=1.1), seed=seed, rate=1000.0)
    return [gen.batch(size) for _ in range(n_batches)]


def _port_batch(jbatch):
    return TBatch({k: v.copy() for k, v in jbatch.columns.items()})


def _models(**cfg):
    jm = jhh.HeavyHitterModel(jhh.HeavyHitterConfig(**cfg))
    tm = thh.HeavyHitterModel(thh.HeavyHitterConfig(**cfg), device="cpu")
    return jm, tm


def _assert_tops_equal(tm, jm, k=None):
    got, want = tm.top(k), jm.top(k)
    assert got.keys() == want.keys()
    for name in want:
        g, w = got[name], np.asarray(want[name])
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_generators_agree():
    """Same seed, same frames: the port's mocker is a copy."""
    for prof in ((JZipf(n_keys=50), TZipf(n_keys=50)), (None, None)):
        jg = JGen(prof[0], seed=5, rate=40.0)
        tg = TGen(prof[1], seed=5, rate=40.0)
        for n in (100, 37):
            jb, tb = jg.batch(n), tg.batch(n)
            for name, col in jb.columns.items():
                np.testing.assert_array_equal(tb.columns[name], col)


@pytest.mark.parametrize("cfg", [
    dict(key_cols=TALKERS, batch_size=256, width=1024, capacity=32),
    dict(key_cols=("src_addr",), batch_size=256, width=512, capacity=16),
    dict(key_cols=("dst_addr",), batch_size=128, width=512, capacity=256),
    dict(key_cols=TALKERS, batch_size=256, width=1024, capacity=32,
         table_prefilter=False),
    dict(key_cols=("src_addr",), batch_size=256, width=512, capacity=16,
         table_admission="plain"),
], ids=["talkers", "src_ips", "dst_ips_no_prefilter_needed",
        "talkers_no_prefilter", "src_plain_admission"])
def test_model_update_and_top_bit_equal(cfg):
    jm, tm = _models(**cfg)
    for jb in _batches(4, 300):  # 300 rows: full chunks and a padded one
        jm.update(jb)
        tm.update(_port_batch(jb))
        _assert_tops_equal(tm, jm)
    assert tm.chunk_updates == 4 * -(-300 // cfg["batch_size"])
    _assert_tops_equal(tm, jm, k=10)


@pytest.mark.parametrize("cfg", [
    dict(key_cols=TALKERS, batch_size=256, width=1024, capacity=32),
    dict(key_cols=("dst_addr",), batch_size=256, width=512, capacity=16),
    dict(key_cols=("src_addr",), batch_size=128, width=512, capacity=256),
], ids=["talkers", "dst_ips", "src_ips_no_prefilter_needed"])
def test_linear_model_update_and_top_bit_equal(cfg):
    """conservative=False: the linear update under the same table."""
    jm, tm = _models(conservative=False, **cfg)
    for jb in _batches(4, 300, seed=21):
        jm.update(jb)
        tm.update(_port_batch(jb))
        _assert_tops_equal(tm, jm)
    np.testing.assert_array_equal(tm.state.cms.numpy(),
                                  np.asarray(jm.state.cms))
    assert tm.chunk_updates == 4 * -(-300 // cfg["batch_size"])


def test_model_dispatches_cms_update_by_config(monkeypatch):
    """Each chunk update goes through the wrapper of the config's kind."""
    from flow_pipeline_tpu_torch.ops import cms_cuda

    calls = []
    for name in ("cms_add", "cms_add_conservative"):
        real = getattr(cms_cuda, name)
        monkeypatch.setattr(cms_cuda, name, lambda *a, _r=real, _n=name,
                            **kw: calls.append(_n) or _r(*a, **kw))
    for conservative, want in ((True, "cms_add_conservative"),
                               (False, "cms_add")):
        calls.clear()
        tm = thh.HeavyHitterModel(thh.HeavyHitterConfig(
            batch_size=128, width=256, capacity=8,
            conservative=conservative), device="cpu")
        tm.update(_port_batch(_batches(1, 300)[0]))
        assert calls == [want] * 3


def test_prefilter_ties_at_2c_boundary():
    """Every group has the same plane-0 sum, so the 2c-th candidate ties
    with the rest: the port must keep the same groups as jax.lax.top_k
    (lower index first) — the first 2c in hash-group order."""
    cfg = dict(key_cols=("src_addr",), batch_size=128, width=512,
               capacity=8)
    jm, tm = _models(**cfg)
    for seed in range(3):
        jb = _batches(1, 100, n_keys=5000, seed=seed)[0]
        jb.columns["bytes"][:] = 7
        jb.columns["packets"][:] = 1
        jm.update(jb)
        tm.update(_port_batch(jb))
        _assert_tops_equal(tm, jm)


def test_topk_merge_est_bit_equal():
    rng = np.random.default_rng(8)
    c, n, w, p = 16, 64, 4, 3
    pool = rng.integers(0, 2**32, size=(40, w), dtype=np.uint32)
    pool[0] = [0x80000000, 0, 0, 1]  # a lane >= 2^31
    tk, tv = jtopk.topk_init(c, w, p)
    ttk, ttv = ttopk.topk_init(c, w, p, device="cpu")
    for _ in range(3):
        cand = pool[rng.choice(len(pool), n // 2, replace=False)]
        cand = np.concatenate([cand, np.full((n // 2, w), 0xFFFFFFFF,
                                             np.uint32)])
        sums = rng.integers(0, 50, size=(n, p)).astype(np.float32)
        sums[::5, 0] = 10.0  # rank ties
        est = sums + rng.integers(0, 20, size=(n, p)).astype(np.float32)
        valid = np.arange(n) < n // 2
        tk, tv = jtopk.topk_merge_est(tk, tv, jnp.asarray(cand),
                                      jnp.asarray(sums), jnp.asarray(est),
                                      jnp.asarray(valid))
        ttk, ttv = ttopk.topk_merge_est(
            ttk, ttv, torch.from_numpy(cand.astype(np.int64)),
            torch.from_numpy(sums), torch.from_numpy(est),
            torch.from_numpy(valid))
        np.testing.assert_array_equal(ttk.numpy(),
                                      np.asarray(tk).astype(np.int64))
        np.testing.assert_array_equal(ttv.numpy(), np.asarray(tv))


def test_state_carried_in_mid_window():
    """Run the JAX model on two batches, carry its state into the port
    through hh_state_from_reference, then run both on two more."""
    cfg = dict(key_cols=TALKERS, batch_size=256, width=1024, capacity=32)
    jm, tm = _models(**cfg)
    batches = _batches(4, 256, seed=11)
    for jb in batches[:2]:
        jm.update(jb)
    js = jm.state
    tm.state = interop.hh_state_from_reference(
        np.asarray(js.cms), np.asarray(js.table_keys),
        np.asarray(js.table_vals), device="cpu")
    back = interop.hh_state_to_reference(tm.state)
    for got, want in zip(back, js):
        np.testing.assert_array_equal(got, np.asarray(want))
    for jb in batches[2:]:
        jm.update(jb)
        tm.update(_port_batch(jb))
    _assert_tops_equal(tm, jm)


def test_config_refuses_unported_family():
    """The table and invertible families are ported; any other sketch
    family is refused when the config is built."""
    assert thh.HeavyHitterConfig(hh_sketch="invertible").hh_sketch == \
        "invertible"
    with pytest.raises(ValueError, match="table\\|invertible"):
        thh.HeavyHitterConfig(hh_sketch="bloom")


def test_model_requires_cuda_by_default_when_absent():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        thh.HeavyHitterModel(thh.HeavyHitterConfig(width=256, capacity=8))


@pytest.mark.parametrize("conservative", [True, False])
@pytest.mark.parametrize("n,prefilter", [(200, True), (40, True),
                                         (200, False)],
                         ids=["prefiltered", "under_2c", "no_prefilter"])
def test_apply_grouped_est_admission_bit_equal(conservative, n, prefilter):
    """_apply_grouped with est admission (the estimates come back from the
    update itself) gives the JAX package's sketch and table, round after
    round, with the groupby's padding rows (sentinel keys, zero sums)."""
    cfg = dict(key_cols=TALKERS, width=512, capacity=16,
               conservative=conservative, table_prefilter=prefilter)
    jcfg, tcfg = jhh.HeavyHitterConfig(**cfg), thh.HeavyHitterConfig(**cfg)
    js, ts = jhh.hh_init(jcfg), thh.hh_init(tcfg, device="cpu")
    rng = np.random.default_rng(n + 3 * conservative + prefilter)
    pool = rng.integers(0, 2**32, size=(300, 11), dtype=np.uint32)
    for _ in range(3):
        uniq = pool[rng.choice(len(pool), n, replace=False)]
        sums = rng.integers(0, 900, size=(n, 3)).astype(np.float32)
        valid = np.arange(n) < n - n // 5  # real groups first, then padding
        uniq[~valid] = 0xFFFFFFFF
        sums[~valid] = 0
        js = jhh._apply_grouped(js, jnp.asarray(uniq), jnp.asarray(sums),
                                jnp.asarray(valid), jcfg)
        ts = thh._apply_grouped(ts, torch.from_numpy(uniq.astype(np.int64)),
                                torch.from_numpy(sums),
                                torch.from_numpy(valid), tcfg)
        np.testing.assert_array_equal(ts.cms.numpy(), np.asarray(js.cms))
        np.testing.assert_array_equal(ts.table_keys.numpy(),
                                      np.asarray(js.table_keys).astype(
                                          np.int64))
        np.testing.assert_array_equal(ts.table_vals.numpy(),
                                      np.asarray(js.table_vals))
