"""Port parity: the DDoS detector and its ops, torch (CPU) against the JAX
package. Tolerance: none anywhere. Rates are integer-valued float32 sums
below 2^24 (exact in any order); the EWMA fold's multiply-adds, the
square root and the quantile bucket's log are evaluated as the reference
evaluates them (ops/f32math.py), so the baselines, z-scores, bucket ids
and alert lists are bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_pipeline_tpu.models import ddos as jdd
from flow_pipeline_tpu.ops import ewma as jew
from flow_pipeline_tpu.ops.quantile import QuantileSketchSpec as JSpec
from flow_pipeline_tpu.schema.batch import FlowBatch as JBatch
from flow_pipeline_tpu_torch.models import ddos as tdd
from flow_pipeline_tpu_torch.ops import ewma as tew
from flow_pipeline_tpu_torch.ops import f32math
from flow_pipeline_tpu_torch.ops.quantile import QuantileSketchSpec as TSpec
from flow_pipeline_tpu_torch.schema.batch import FlowBatch as TBatch
import torch_cpu  # noqa: F401  (one torch thread; see the module)

M = 1 << 10  # buckets in the small-state tests


def _addrs(rng, n):
    a = rng.integers(0, 2**32, size=(n, 4), dtype=np.uint32)
    a[: n // 2, :3] = 0  # IPv4-in-trailing-word rows too
    return a


def test_bucket_of_bit_equal():
    keys = _addrs(np.random.default_rng(1), 2000)
    want = np.asarray(jew.bucket_of(jnp.asarray(keys), 1 << 14))
    got = tew.bucket_of(torch.from_numpy(keys.astype(np.int64)), 1 << 14)
    np.testing.assert_array_equal(got.numpy(), want)


def test_rate_accumulate_bit_equal():
    rng = np.random.default_rng(2)
    rates = rng.integers(0, 1000, M).astype(np.float32)
    buckets = rng.integers(0, M, 5000).astype(np.int32)
    vals = rng.integers(0, 3000, 5000).astype(np.float32)
    valid = rng.random(5000) < 0.8
    want = jew.rate_accumulate(jnp.asarray(rates), jnp.asarray(buckets),
                               jnp.asarray(vals), jnp.asarray(valid))
    got = tew.rate_accumulate(torch.from_numpy(rates),
                              torch.from_numpy(buckets.astype(np.int64)),
                              torch.from_numpy(vals),
                              torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _ew_state(rng, m):
    return ((rng.random(m) * 1000).astype(np.float32),
            (rng.random(m) * 5000).astype(np.float32), rng.random(m) < 0.7)


def test_ewma_fold_and_zscores_bit_equal():
    """As the reference runs them: inside its jitted window close."""
    rng = np.random.default_rng(3)
    cfg = jdd.DDoSConfig(n_buckets=1 << 14)
    spec = JSpec(rel_err=cfg.rel_err)
    mean, var, seen = _ew_state(rng, cfg.n_buckets)
    rates = rng.integers(0, 3000, cfg.n_buckets).astype(np.float32)
    js = jdd.ddos_init(cfg, spec)._replace(
        mean=jnp.asarray(mean), var=jnp.asarray(var),
        seen=jnp.asarray(seen), rates=jnp.asarray(rates))
    jnew, jz, _ = jdd.ddos_close_window(js, config=cfg, spec=spec)
    ew = tuple(map(torch.from_numpy, (mean, var, seen)))
    tz = tew.zscores(ew, torch.from_numpy(rates), cfg.min_sigma,
                     cfg.rel_sigma)
    tm, tv, ts = tew.ewma_fold(ew, torch.from_numpy(rates), cfg.alpha)
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jnew.mean))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jnew.var))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(jnew.seen))


def test_quantile_bucket_of_every_integer_below_2_24():
    """Every integer in [0, 2^24): the bucket ids equal the reference's
    (one id off near gamma^k would move the alert gate)."""
    jspec, tspec = JSpec(rel_err=0.01), TSpec(rel_err=0.01)
    jfn = jax.jit(jspec.bucket_of)
    step = 1 << 22
    for lo in range(0, 1 << 24, step):
        v = np.arange(lo, lo + step, dtype=np.float32)
        want = np.asarray(jfn(jnp.asarray(v)))
        got = tspec.bucket_of(torch.from_numpy(v)).numpy()
        np.testing.assert_array_equal(got, want)


def test_log_f32_matches_reference_across_the_range():
    """Random float32 values over 60 decades, and the exact powers of
    two, against the reference's jitted log."""
    rng = np.random.default_rng(4)
    v = (10.0 ** rng.uniform(-30, 30, 1 << 20)).astype(np.float32)
    v = np.concatenate([v, np.ldexp(np.float32(1), np.arange(-126, 127))
                        .astype(np.float32)])
    want = np.asarray(jax.jit(jnp.log)(jnp.asarray(v)))
    got = f32math.log_f32(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, want)


def test_fma32_rounds_once():
    """(1 + 2^-12)^2 = 1 + 2^-11 + 2^-24: a product rounded on its own
    loses the 2^-24 that one fused rounding keeps. With + 2^-80 instead of
    - 1 the exact sum sits just above a float32 tie that a float64 sum
    would round onto: round-to-odd still rounds it up."""
    a = torch.tensor([1.0 + 2**-12], dtype=torch.float32)
    assert f32math.fma32(a, a, -1.0).item() == 2**-11 + 2**-24
    assert (a * a - 1.0).item() == 2**-11
    assert f32math.fma32(a, a, 2**-80).item() == 1 + 2**-11 + 2**-23


def test_quantile_hist_and_query_bit_equal():
    rng = np.random.default_rng(5)
    jspec, tspec = JSpec(rel_err=0.01), TSpec(rel_err=0.01)
    vals = rng.integers(0, 1 << 20, 5000).astype(np.float32)
    valid = vals > 100
    jh = jspec.add(jspec.init(), jnp.asarray(vals), valid=jnp.asarray(valid))
    th = tspec.add(tspec.init(), torch.from_numpy(vals),
                   valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    for q in (0.5, 0.99):
        assert tspec.quantile(th.numpy(), q) == jspec.quantile(jh, q)


def _state_pair(cfg, rng):
    jspec = JSpec(rel_err=cfg.rel_err)
    js = jdd.ddos_init(cfg, jspec)
    ts = tdd.ddos_init(cfg, TSpec(rel_err=cfg.rel_err), "cpu")
    return js, ts


def _assert_states_equal(ts, js):
    for name, g, w in zip(tdd.DDoSState._fields, ts, js):
        w = np.asarray(w)
        np.testing.assert_array_equal(g.numpy().astype(w.dtype), w,
                                      err_msg=name)


def test_witness_tie_last_row_wins():
    """Two dsts in one bucket tie on the largest sum: both packages keep
    the later row's dst (the reference's in-order scatter-set)."""
    rng = np.random.default_rng(6)
    pool = _addrs(rng, 4000)
    b = tew.bucket_of(torch.from_numpy(pool.astype(np.int64)), M).numpy()
    shared = [k for k in np.unique(b) if (b == k).sum() >= 2][:3]
    pairs = [tuple(np.flatnonzero(b == k)[:2]) for k in shared]
    rows = [pool[i] for pair in pairs for i in pair]
    uniq = np.stack(rows + [pool[-1]])
    sums = np.array([50, 50, 7, 7, 0, 0, 3], np.float32)  # ties per bucket
    valid = np.array([1, 1, 1, 1, 1, 1, 0], bool)
    cfg = jdd.DDoSConfig(n_buckets=M)
    js, ts = _state_pair(cfg, rng)
    jout = jdd._accumulate_grouped(js, jnp.asarray(uniq), jnp.asarray(sums),
                                   jnp.asarray(valid), cfg)
    tout = tdd._accumulate_grouped(
        ts, torch.from_numpy(uniq.astype(np.int64)), torch.from_numpy(sums),
        torch.from_numpy(valid), tdd.DDoSConfig(n_buckets=M))
    _assert_states_equal(tout, jout)
    for (i, j), k in zip(pairs, range(0, 6, 2)):
        np.testing.assert_array_equal(
            tout.addrs[b[i]].numpy().astype(np.uint32), uniq[k + 1])


def _flood_stream(seed, subs=24, per_sub=3000, n_dst=200, victim=5,
                  flood_from=8):
    rng = np.random.default_rng(seed)
    t0 = 1_700_000_000
    cols = {"time_received": [], "dst": [], "packets": []}
    for s in range(subs):
        n = per_sub + (600 if s >= flood_from else 0)
        cols["time_received"].append(t0 + s * 10 + rng.integers(0, 10, n))
        d = rng.integers(0, n_dst, n)
        p = rng.integers(1, 20, n)
        if s >= flood_from:
            d[per_sub:] = victim
            p[per_sub:] = 50
        cols["dst"].append(d)
        cols["packets"].append(p)
    t, d, p = (np.concatenate(cols[k]) for k in ("time_received", "dst",
                                                 "packets"))
    batch = JBatch.empty(len(t))
    batch.columns["time_received"][:] = t
    batch.columns["packets"][:] = p
    batch.columns["sampling_rate"][:] = rng.choice([0, 1, 2], len(t))
    batch.columns["dst_addr"][:, 3] = 0x0A000000 + d
    # arrival order slightly shuffled: some rows land late and are dropped
    order = np.argsort(t + rng.integers(-3, 4, len(t)), kind="stable")
    batch = JBatch({k: v[order] for k, v in batch.columns.items()})
    return [batch.slice(s, s + 2500) for s in range(0, len(t), 2500)]


def test_detector_alerts_identical_on_a_flood():
    cfg = dict(batch_size=1024)
    jd = jdd.DDoSDetector(jdd.DDoSConfig(**cfg))
    td = tdd.DDoSDetector(tdd.DDoSConfig(**cfg), device="cpu")
    for b in _flood_stream(7):
        jd.update(b)
        td.update(TBatch({k: v.copy() for k, v in b.columns.items()}))
    jd.close_sub_window()
    td.close_sub_window()
    assert td.late_flows_dropped == jd.late_flows_dropped > 0
    assert len(td.alerts) == len(jd.alerts) >= 1
    assert any(int(a["dst_addr"][3]) == 0x0A000005 for a in td.alerts)
    for got, want in zip(td.alerts, jd.alerts):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert td.entropy == jd.entropy
    assert td.entropy_baseline == jd.entropy_baseline
    assert td.folds == jd.folds
    _assert_states_equal(td.state, jd.state)


def test_rate_entropy_matches_reference():
    rng = np.random.default_rng(8)
    for rates in (rng.random(100), np.zeros(10), np.eye(1, 50)[0],
                  rng.integers(0, 3, 64).astype(float)):
        assert tdd.rate_entropy(rates) == jdd.rate_entropy(rates)


@pytest.mark.parametrize("scale", [None, "sampling_rate"])
def test_accumulate_and_close_bit_equal(scale):
    rng = np.random.default_rng(9)
    cfg = dict(n_buckets=M, batch_size=512, scale_col=scale)
    jcfg, tcfg = jdd.DDoSConfig(**cfg), tdd.DDoSConfig(**cfg)
    js, ts = _state_pair(jcfg, rng)
    spec_j, spec_t = JSpec(rel_err=0.01), TSpec(rel_err=0.01)
    pool = _addrs(rng, 300)
    for rnd in range(4):
        n = 512
        cols = {"dst_addr": pool[rng.integers(0, 300, n)].view(np.int32),
                "packets": rng.integers(0, 2**32, n, dtype=np.uint64)
                .astype(np.uint32).view(np.int32) if rnd == 3 else
                rng.integers(0, 100, n).astype(np.int32),
                "sampling_rate": rng.choice([0, 1, 10], n).astype(np.int32)}
        valid = rng.random(n) < 0.9
        js = jdd.ddos_accumulate(js, {k: jnp.asarray(v) for k, v in
                                      cols.items()}, jnp.asarray(valid),
                                 config=jcfg)
        ts = tdd.ddos_accumulate(ts, {k: torch.from_numpy(v) for k, v in
                                      cols.items()}, torch.from_numpy(valid),
                                 config=tcfg)
        _assert_states_equal(ts, js)
        if rnd < 3:  # the saturated round leaves the integer envelope
            js, jz, jr = jdd.ddos_close_window(js, config=jcfg, spec=spec_j)
            ts, tz, tr = tdd.ddos_close_window(ts, config=tcfg, spec=spec_t)
            np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
            _assert_states_equal(ts, js)
