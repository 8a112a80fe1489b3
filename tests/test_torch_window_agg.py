"""Port parity: the flows_5m aggregator, torch (CPU) against the JAX
package over seeded batches. The flushed rows are uint64 and must be
bit-equal (tolerance: none): the device planes are int32 and the host fold
is uint64 numpy on both sides.
"""

import numpy as np
import pytest
import torch

from flow_pipeline_tpu.gen import FlowGenerator as JGen
from flow_pipeline_tpu.gen import ZipfProfile as JZipf
from flow_pipeline_tpu.models import oracle as joracle
from flow_pipeline_tpu.models import window_agg as jwa
from flow_pipeline_tpu.schema.batch import FlowBatch as JBatch
from flow_pipeline_tpu_torch.models import oracle as toracle
from flow_pipeline_tpu_torch.models import window_agg as twa
from flow_pipeline_tpu_torch.ops import segment as tseg
from flow_pipeline_tpu_torch.schema.batch import FlowBatch as TBatch
import torch_cpu  # noqa: F401  (one torch thread; see the module)


def _batches(n_batches, size, seed=0, rate=5.0, rates=(0, 1, 100)):
    """Seeded Zipf batches whose sampling rate is drawn from ``rates``
    (0 scales by 1, as the reference's unannounced rate)."""
    gen = JGen(JZipf(n_keys=300, alpha=1.1), seed=seed, rate=rate)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        b = gen.batch(size)
        b.columns["sampling_rate"][:] = rng.choice(rates, size)
        b.columns["src_as"][:] = rng.integers(0, 4, size)  # few groups
        out.append(b)
    return out


def _port(jbatch):
    return TBatch({k: v.copy() for k, v in jbatch.columns.items()})


def _aggs(**cfg):
    return (jwa.WindowAggregator(jwa.WindowAggConfig(**cfg)),
            twa.WindowAggregator(twa.WindowAggConfig(**cfg), device="cpu"))


def _assert_rows_equal(got, want):
    assert got.keys() == want.keys()
    for name in want:
        g, w = got[name], np.asarray(want[name])
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def _drive(jagg, tagg, batches):
    """Feed both, flushing after every batch as the worker does; returns
    the non-empty flushes of each."""
    jrows, trows = [], []
    for jb in batches:
        jagg.update(jb)
        tagg.update(_port(jb))
        for agg, out in ((jagg, jrows), (tagg, trows)):
            rows = agg.flush()
            if len(rows["timeslot"]):
                out.append(rows)
    jrows.append(jagg.flush(force=True))
    trows.append(tagg.flush(force=True))
    return jrows, trows


@pytest.mark.parametrize("cfg", [
    dict(batch_size=256),
    dict(batch_size=128, scale_col=None),
    dict(batch_size=512, allowed_lateness=120),
    dict(batch_size=256, key_cols=("src_addr", "dst_port")),
], ids=["default", "unscaled", "lateness", "address_key"])
def test_flushed_rows_bit_equal(cfg):
    jagg, tagg = _aggs(**cfg)
    jrows, trows = _drive(jagg, tagg, _batches(6, 700, seed=1))
    assert len(jrows) == len(trows) >= 3  # windows closed mid-stream
    for got, want in zip(trows, jrows):
        _assert_rows_equal(got, want)


def test_sampling_rate_zero_scales_by_one():
    jagg, tagg = _aggs(batch_size=256)
    batches = _batches(2, 300, seed=2, rates=(0,))
    jrows, trows = _drive(jagg, tagg, batches)
    got = trows[-1]
    _assert_rows_equal(got, jrows[-1])
    np.testing.assert_array_equal(got["bytes_scaled"], got["bytes"])
    np.testing.assert_array_equal(got["packets_scaled"], got["packets"])


def test_late_rows_reopen_a_flushed_window():
    """allowed_lateness 30: a window flushes once the watermark is 30 s
    past its end; rows for it that arrive later reopen it and are emitted
    as additional partial rows, identically in both packages."""
    jagg, tagg = _aggs(batch_size=128, allowed_lateness=30)
    base = _batches(1, 400, seed=3, rate=1.0)[0]
    t = base.columns["time_received"]
    t0 = int(t.min()) // 300 * 300
    first = base.slice(0, 200)
    first.columns["time_received"][:] = t0 + 10  # window t0
    ahead = base.slice(200, 300)
    ahead.columns["time_received"][:] = t0 + 340  # watermark past t0+330
    late = base.slice(300, 400)
    late.columns["time_received"][:] = t0 + 20  # window t0 again
    batches = [JBatch({k: v.copy() for k, v in b.columns.items()})
               for b in (first, ahead, late)]
    jrows, trows = _drive(jagg, tagg, batches)
    assert len(jrows) == len(trows)
    for got, want in zip(trows, jrows):
        _assert_rows_equal(got, want)
    slots = [int(s) for rows in trows for s in set(rows["timeslot"])]
    assert slots.count(t0) == 2  # flushed, reopened, flushed again


def _merged(rows_list):
    out = {}
    for rows in rows_list:
        for i in range(len(rows["timeslot"])):
            key = (int(rows["timeslot"][i]), int(rows["src_as"][i]),
                   int(rows["dst_as"][i]), int(rows["etype"][i]))
            acc = out.setdefault(key, [0, 0, 0])
            for j, c in enumerate(("bytes", "packets", "count")):
                acc[j] += int(rows[c][i])
    return out


def test_collision_fallback_is_exact(monkeypatch):
    """A port hash that sends every key to one pair forces the collision
    flag on every chunk; the drain re-runs each chunk through sort_groupby
    and the rows still equal the exact oracle and the JAX package's."""
    batches = _batches(4, 500, seed=4)
    jagg, _ = _aggs(batch_size=256)
    tagg = twa.WindowAggregator(twa.WindowAggConfig(batch_size=256),
                                device="cpu")
    def one_pair(keys):
        h = torch.full((keys.shape[0],), 0x1234, dtype=torch.int64)
        return h, h

    monkeypatch.setattr(tseg, "hash_lanes", one_pair)
    exact_runs = []
    real_exact = twa._update_exact
    monkeypatch.setattr(twa, "_update_exact", lambda *a: exact_runs.append(
        1) or real_exact(*a))
    jrows, trows = _drive(jagg, tagg, batches)
    assert len(exact_runs) == 4 * 2  # every 500-row batch is two chunks
    for got, want in zip(trows, jrows):
        _assert_rows_equal(got, want)
    whole = JBatch.concat(batches)
    want = toracle.flows_5m(_port(whole))
    exact = {(int(want["timeslot"][i]), int(want["src_as"][i]),
              int(want["dst_as"][i]), int(want["etype"][i])):
             [int(want[c][i]) for c in ("bytes", "packets", "count")]
             for i in range(len(want["timeslot"]))}
    assert _merged(trows) == exact


def test_oracle_flows_5m_matches_reference():
    whole = JBatch.concat(_batches(2, 400, seed=5))
    want = joracle.flows_5m(whole)
    got = toracle.flows_5m(_port(whole))
    _assert_rows_equal(got, want)


def test_partials_stay_pending_until_a_flush():
    """No host read per chunk: partials queue (the collision flags stay
    lazy) until the flush drains them, as in the reference."""
    jagg, tagg = _aggs(batch_size=128)
    for jb in _batches(2, 300, seed=6):
        jagg.update(jb)
        tagg.update(_port(jb))
    assert len(tagg._pending_partials) == len(jagg._pending_partials) == 6
    assert not tagg.windows
    _assert_rows_equal(tagg.flush(force=True), jagg.flush(force=True))
    assert not tagg._pending_partials


def test_rows_helpers_match_reference():
    cfg = dict(batch_size=256)
    jagg, tagg = _aggs(**cfg)
    for jb in _batches(2, 300, seed=7):
        jagg.update(jb)
        tagg.update(_port(jb))
    jstores, tstores = jagg.pop_closed(True), tagg.pop_closed(True)
    slot, store = tstores[0]
    _assert_rows_equal(twa.wagg_rows(store, tagg.config, 5, slot),
                       jwa.wagg_rows(jstores[0][1], jagg.config, 5, slot))
    _assert_rows_equal(twa.rows_from_stores(tagg.config, []),
                       jwa.rows_from_stores(jagg.config, []))


def test_batch_size_above_int32_envelope_refused():
    with pytest.raises(ValueError, match="32768"):
        twa.WindowAggregator(twa.WindowAggConfig(batch_size=65536),
                             device="cpu")
