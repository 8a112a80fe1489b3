"""The port's fused engine (engine/fused.py) against the JAX package's.

- The step: the reference's ``_cached_step`` (JAX on the CPU) and the
  port's, from the same states (carried with ``interop``) and the same
  chunk, for the plan cases the reference builds: the default set (the
  src-under-5-tuple chain, the shared dst sort for top_dst_ips and DDoS,
  the port tables, flows_5m), heavy hitters only (the dst sort without
  DDoS), DDoS only, and a second dst-keyed family with another scale
  column (demoted to its own groupby). Compared: CMS counters, tables,
  dense totals, DDoS state and the flows_5m partials, bit for bit.
- The pipeline: ``FusedPipeline.update`` on both packages over batches
  that cross window slots and DDoS sub-windows, with late rows; every
  flushed row, state, late-row count and alert compared.

Every value sum stays inside the 2^24 integer envelope, so nothing is
excused (tolerance: none).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_pipeline_tpu.engine import FusedPipeline as JFused
from flow_pipeline_tpu.engine import WindowedHeavyHitter as JWindowed
from flow_pipeline_tpu.gen import FlowGenerator, ZipfProfile
from flow_pipeline_tpu.models import ddos as jdd
from flow_pipeline_tpu.models import dense_top as jdt
from flow_pipeline_tpu.models import heavy_hitter as jhh
from flow_pipeline_tpu.models import window_agg as jwa
from flow_pipeline_tpu_torch import interop
from flow_pipeline_tpu_torch.engine import FusedPipeline as TFused
from flow_pipeline_tpu_torch.engine import WindowedHeavyHitter as TWindowed
from flow_pipeline_tpu_torch.engine import fused as tfused
from flow_pipeline_tpu_torch.models import ddos as tdd
from flow_pipeline_tpu_torch.models import dense_top as tdt
from flow_pipeline_tpu_torch.models import heavy_hitter as thh
from flow_pipeline_tpu_torch.models import window_agg as twa
from flow_pipeline_tpu_torch.schema.batch import FlowBatch as TBatch
import torch_cpu  # noqa: F401  (one torch thread; see the module)

BS = 512
TALKERS = ("src_addr", "dst_addr", "src_port", "dst_port", "proto")


def _hh(key_cols, **kw):
    return dict(key_cols=key_cols, batch_size=BS, width=1 << 10,
                capacity=64, **kw)


# (name, kind, config kwargs): the same configs for both packages
PLANS = {
    "default": [
        ("flows_5m", "wagg", dict(batch_size=BS)),
        ("top_talkers", "hh", _hh(TALKERS)),
        ("top_src_ips", "hh", _hh(("src_addr",))),
        ("top_dst_ips", "hh", _hh(("dst_addr",))),
        ("top_src_ports", "dense", dict(key_col="src_port",
                                        batch_size=BS)),
        ("top_dst_ports", "dense", dict(key_col="dst_port",
                                        batch_size=BS)),
        ("ddos_alerts", "ddos", dict(n_buckets=1 << 10, batch_size=BS,
                                     warmup_windows=0)),
    ],
    "hh_only": [
        ("top_talkers", "hh", _hh(TALKERS)),
        ("top_src_ips", "hh", _hh(("src_addr",))),
        ("top_dst_ips", "hh", _hh(("dst_addr",), conservative=False)),
    ],
    "ddos_only": [
        ("ddos_alerts", "ddos", dict(n_buckets=1 << 10, batch_size=BS,
                                     warmup_windows=0)),
    ],
    "demoted_dst": [
        ("top_dst_ips", "hh", _hh(("dst_addr",))),
        ("top_dst_ips_raw", "hh", _hh(("dst_addr",), scale_col=None)),
        ("ddos_alerts", "ddos", dict(n_buckets=1 << 10, batch_size=BS,
                                     warmup_windows=0)),
    ],
}


def _models(plan, port: bool, sub_seconds=10):
    out = {}
    for name, kind, kw in PLANS[plan]:
        if kind == "wagg":
            out[name] = (twa.WindowAggregator(twa.WindowAggConfig(**kw),
                                              device="cpu") if port
                         else jwa.WindowAggregator(jwa.WindowAggConfig(**kw)))
        elif kind == "hh":
            out[name] = (TWindowed(thh.HeavyHitterConfig(**kw), k=30,
                                   device="cpu") if port
                         else JWindowed(jhh.HeavyHitterConfig(**kw), k=30))
        elif kind == "dense":
            out[name] = (TWindowed(tdt.DenseTopConfig(**kw), k=30,
                                   model_cls=tdt.DenseTopKModel,
                                   device="cpu") if port
                         else JWindowed(jdt.DenseTopConfig(**kw), k=30,
                                        model_cls=jdt.DenseTopKModel))
        else:
            kw = dict(kw, sub_window_seconds=sub_seconds)
            out[name] = (tdd.DDoSDetector(tdd.DDoSConfig(**kw), device="cpu")
                         if port else jdd.DDoSDetector(jdd.DDoSConfig(**kw)))
    return out


def _stream(seed, n_batches=8, n_keys=300, late=True):
    """Batches of BS flows crossing three window slots and many 10-s
    sub-windows; batch 5 carries rows two slots behind (late). Sources
    come from 13 addresses, so each src_addr group of the chain holds
    several 5-tuples (the Zipf key table alone makes them one to one)."""
    gen = FlowGenerator(ZipfProfile(n_keys=n_keys, alpha=1.2), seed=seed)
    t0 = 6000  # slot-aligned
    batches = []
    for i in range(n_batches):
        b = gen.batch(BS)
        times = t0 + i * 90 + (np.arange(BS) % 30)
        if late and i == 5:
            times[:25] = t0
        b.columns["time_received"] = times.astype(np.uint64)
        b.columns["sampling_rate"] = np.full(BS, 1 + i % 3, np.uint64)
        b.columns["src_addr"][:, 3] = b.columns["src_addr"][:, 3] % 13
        batches.append(b)
    return batches


def _port_batch(jb):
    return TBatch({k: v.copy() for k, v in jb.columns.items()},
                  jb.partition)


# ---- the step ----------------------------------------------------------------

def _states_np(jpipe):
    """The reference pipeline's states as numpy arrays."""
    return (
        [tuple(np.asarray(a) for a in w.model.state) for _, w in jpipe._hh],
        [np.asarray(w.model.totals) for _, w in jpipe._dense],
        [tuple(np.asarray(a) for a in d.state) for _, d in jpipe._ddos],
    )


def _assert_step_equal(jout, tout):
    (jhh_s, jdense, jddos), jwagg = jout
    (thh_s, tdense, tddos), twagg = tout
    assert len(jhh_s) == len(thh_s)
    for js, ts in zip(jhh_s, thh_s):
        cms, keys, vals = interop.hh_state_to_reference(ts)
        np.testing.assert_array_equal(cms, np.asarray(js.cms))
        np.testing.assert_array_equal(keys, np.asarray(js.table_keys))
        np.testing.assert_array_equal(vals, np.asarray(js.table_vals))
    for jt, tt in zip(jdense, tdense, strict=True):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    for js, ts in zip(jddos, tddos, strict=True):
        for name, want, got in zip(js._fields, js,
                                   interop.ddos_state_to_reference(ts)):
            np.testing.assert_array_equal(got, np.asarray(want),
                                          err_msg=name)
    for jp, tp in zip(jwagg, twagg, strict=True):
        jkeys, jsums, jcounts, jn, jcoll = (np.asarray(a) for a in jp)
        tkeys, tsums, tcounts, tn, tcoll = (t.numpy() for t in tp)
        np.testing.assert_array_equal(tkeys.astype(np.uint32), jkeys)
        np.testing.assert_array_equal(tsums, jsums)
        np.testing.assert_array_equal(tcounts, jcounts)
        assert int(tn) == int(jn) and bool(tcoll) == bool(jcoll)


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("masks", ["both", "hh_late", "ddos_late"])
def test_step_matches_reference(plan, masks):
    """One step of each package's fused step from the same states (the
    reference's after three batches, carried into the port) and the same
    chunk, under each pair of row masks the pipeline hands it."""
    batches = _stream(seed=11)
    jmodels = _models(plan, port=False)
    jpipe = JFused(jmodels)
    for b in batches[:3]:
        jpipe.update(b)
    tpipe = TFused(_models(plan, port=True))
    hh_np, dense_np, ddos_np = _states_np(jpipe)

    chunk = batches[3].slice(0, BS - 37)  # a padded chunk
    padded, mask = chunk.pad_to(BS)
    host_cols = padded.device_columns(jpipe._cols)
    assert tpipe._cols == jpipe._cols
    valid = mask
    zeros = np.zeros_like(mask)
    vhh = zeros if masks == "hh_late" else valid
    vdd = zeros if masks == "ddos_late" else valid

    jstates = (tuple(jhh.HHState(*map(jnp.asarray, s)) for s in hh_np),
               tuple(jnp.asarray(t) for t in dense_np),
               tuple(jdd.DDoSState(*map(jnp.asarray, s)) for s in ddos_np))
    jout = jpipe._step(jstates, {k: jnp.asarray(v)
                                 for k, v in host_cols.items()},
                       jnp.asarray(valid), jnp.asarray(vhh),
                       jnp.asarray(vdd))
    tstates = (tuple(interop.hh_state_from_reference(*s, device="cpu")
                     for s in hh_np),
               tuple(interop.dense_totals_from_reference(t, device="cpu")
                     for t in dense_np),
               tuple(interop.ddos_state_from_reference(*s, device="cpu")
                     for s in ddos_np))
    tout = tpipe._step(tstates, {k: torch.from_numpy(
        np.ascontiguousarray(v)) for k, v in host_cols.items()},
        torch.from_numpy(valid), torch.from_numpy(vhh),
        torch.from_numpy(vdd))
    _assert_step_equal(jout, tout)


def test_plans_match_reference():
    """The plan each family gets (shared dst sort or its own groupby) and
    the nested-family chains equal the reference's, demotion included."""
    for plan in PLANS:
        jpipe = JFused(_models(plan, port=False))
        tpipe = TFused(_models(plan, port=True))
        assert [p for p, _ in tpipe._hh_specs] == \
            [p for p, _ in jpipe._hh_specs]
    specs = TFused(_models("default", port=True))._hh_specs
    assert tfused._chains(specs) == [(1, 0)]  # src_addr under the 5-tuple
    assert [p for p, _ in specs] == [("own",), ("own",), ("B",)]
    # the reference's step demotes the second dst family at build time;
    # both builds agree on which is which through the outputs above
    demoted = TFused(_models("demoted_dst", port=True))._hh_specs
    assert [p for p, _ in demoted] == [("B",), ("B",)]


def test_lex_hash_perm_is_lexicographic_and_stable():
    """The 4-lane sort: unsigned lexicographic order of the (h1, h2)
    pairs, prefix pair first, equal rows in input order (numpy's lexsort
    is the oracle)."""
    rng = np.random.default_rng(5)
    n = 4096
    # few distinct values per lane, both halves of the u32 range, so ties
    # and the sign bit both show
    pool = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1],
                    dtype=np.int64)
    lanes = [pool[rng.integers(0, len(pool), n)] for _ in range(4)]
    got = tfused._lex_hash_perm([torch.from_numpy(a) for a in lanes])
    want = np.lexsort([np.arange(n)] + lanes[::-1])
    np.testing.assert_array_equal(got.numpy(), want)


# ---- the pipeline -------------------------------------------------------------

def _flush_all(models):
    out = {}
    for name, m in models.items():
        if hasattr(m, "alerts"):
            m.close_sub_window()
            out[name] = list(m.alerts)
        else:
            out[name] = m.flush(True)
    return out


@pytest.mark.parametrize("sub_seconds", [10, 300])
def test_pipeline_matches_reference(sub_seconds):
    """FusedPipeline.update across slot rolls, sub-window closes and late
    rows: every flushed row, late-row count and alert equals the
    reference's."""
    batches = _stream(seed=7, n_keys=100)
    jmodels = _models("default", port=False, sub_seconds=sub_seconds)
    tmodels = _models("default", port=True, sub_seconds=sub_seconds)
    jpipe, tpipe = JFused(jmodels), TFused(tmodels)
    for b in batches:
        jpipe.update(b)
        tpipe.update(_port_batch(b))
    for name in jmodels:
        jm, tm = jmodels[name], tmodels[name]
        assert getattr(tm, "late_flows_dropped", 0) == \
            getattr(jm, "late_flows_dropped", 0), name
    assert tmodels["top_talkers"].late_flows_dropped == 25
    assert tmodels["flows_5m"].watermark == jmodels["flows_5m"].watermark
    # 3 hh families x the padded chunks the pipeline ran
    assert tmodels["top_talkers"].model.chunk_updates > len(batches)
    want, got = _flush_all(jmodels), _flush_all(tmodels)
    assert len(got["ddos_alerts"]) == len(want["ddos_alerts"])
    for x, y in zip(got["ddos_alerts"], want["ddos_alerts"]):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(np.asarray(x[k]),
                                          np.asarray(y[k]), err_msg=k)
    for k, col in want["flows_5m"].items():
        np.testing.assert_array_equal(got["flows_5m"][k], col, err_msg=k)
    for name in ("top_talkers", "top_src_ips", "top_dst_ips",
                 "top_src_ports", "top_dst_ports"):
        assert len(got[name]) == len(want[name]) == 3, name
        for gw, ww in zip(got[name], want[name]):
            assert gw.keys() == ww.keys()
            for k in ww:
                np.testing.assert_array_equal(gw[k], ww[k],
                                              err_msg=f"{name} {k}")


def test_unsupported_model_set_is_not_fused():
    """A set the step cannot serve (two DDoS detectors, or models on two
    devices' worth of configs with different batch sizes) keeps the
    per-model path, as the reference's supported() decides."""
    two = _models("ddos_only", port=True)
    two["ddos_2"] = tdd.DDoSDetector(tdd.DDoSConfig(batch_size=BS),
                                     device="cpu")
    assert not TFused.supported(two)
    mixed = _models("hh_only", port=True)
    mixed["flows_5m"] = twa.WindowAggregator(
        twa.WindowAggConfig(batch_size=2 * BS), device="cpu")
    assert not TFused.supported(mixed)
    with pytest.raises(ValueError, match="not fusable"):
        TFused(mixed)
