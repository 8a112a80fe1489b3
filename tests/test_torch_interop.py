"""Port interop: model state carried from the JAX package into the port
mid-window (as numpy arrays), and back. After the carry, the next update
must match the JAX package's (tolerance: none; integer planes, integer-
valued rates below 2^24).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from flow_pipeline_tpu.gen import FlowGenerator as JGen
from flow_pipeline_tpu.gen import ZipfProfile as JZipf
from flow_pipeline_tpu.models import ddos as jdd
from flow_pipeline_tpu.models import dense_top as jdt
from flow_pipeline_tpu.models import window_agg as jwa
from flow_pipeline_tpu_torch import interop
from flow_pipeline_tpu_torch.models import ddos as tdd
from flow_pipeline_tpu_torch.models import dense_top as tdt
from flow_pipeline_tpu_torch.models import window_agg as twa
from flow_pipeline_tpu_torch.schema.batch import FlowBatch as TBatch
import torch_cpu  # noqa: F401  (one torch thread; see the module)


def _batches(n, size, seed, rate=5.0):
    gen = JGen(JZipf(n_keys=300, alpha=1.1), seed=seed, rate=rate)
    return [gen.batch(size) for _ in range(n)]


def _port(jbatch):
    return TBatch({k: v.copy() for k, v in jbatch.columns.items()})


def test_dense_totals_carried_mid_window():
    cfg = dict(key_col="src_port", batch_size=256)
    jm = jdt.DenseTopKModel(jdt.DenseTopConfig(**cfg))
    tm = tdt.DenseTopKModel(tdt.DenseTopConfig(**cfg), device="cpu")
    batches = _batches(4, 300, seed=1)
    for jb in batches[:2]:
        jm.update(jb)
    tm.totals = interop.dense_totals_from_reference(np.asarray(jm.totals),
                                                    device="cpu")
    np.testing.assert_array_equal(
        interop.dense_totals_to_reference(tm.totals), np.asarray(jm.totals))
    for jb in batches[2:]:
        jm.update(jb)
        tm.update(_port(jb))
    np.testing.assert_array_equal(tm.totals.numpy(), np.asarray(jm.totals))
    got, want = tm.top(20), jm.top(20)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_ddos_state_carried_mid_window():
    cfg = dict(batch_size=256, n_buckets=1 << 12, warmup_windows=1)
    jd = jdd.DDoSDetector(jdd.DDoSConfig(**cfg))
    td = tdd.DDoSDetector(tdd.DDoSConfig(**cfg), device="cpu")
    batches = _batches(6, 400, seed=2, rate=40.0)
    for jb in batches[:3]:
        jd.update(jb)
    arrays = [np.asarray(a) for a in jd.state]
    td.state = interop.ddos_state_from_reference(*arrays, device="cpu")
    td.current_sub, td.folds = jd.current_sub, jd.folds
    td.entropy, td.entropy_baseline = jd.entropy, jd.entropy_baseline
    for got, want in zip(interop.ddos_state_to_reference(td.state), arrays):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for jb in batches[3:]:
        jd.update(jb)
        td.update(_port(jb))
    jd.close_sub_window()
    td.close_sub_window()
    for got, want in zip(interop.ddos_state_to_reference(td.state), jd.state):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert len(td.alerts) == len(jd.alerts)
    for got, want in zip(td.alerts, jd.alerts):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_window_store_carried_mid_window():
    cfg = dict(batch_size=256)
    jagg = jwa.WindowAggregator(jwa.WindowAggConfig(**cfg))
    batches = _batches(4, 500, seed=3)
    for jb in batches[:2]:
        jagg.update(jb)
    jagg._drain()  # the store holds every partial so far
    tagg = interop.window_agg_from_reference(
        jagg.windows, jagg.watermark, twa.WindowAggConfig(**cfg),
        device="cpu")
    windows, watermark = interop.window_agg_to_reference(tagg)
    assert watermark == jagg.watermark
    assert windows.keys() == jagg.windows.keys()
    for slot, store in jagg.windows.items():
        assert windows[slot].keys() == store.keys()
        for key, acc in store.items():
            np.testing.assert_array_equal(windows[slot][key], acc)
    for jb in batches[2:]:
        jagg.update(jb)
        tagg.update(_port(jb))
    got, want = tagg.flush(force=True), jagg.flush(force=True)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("what", ["dense", "ddos", "window"])
def test_carry_refuses_wrong_layouts(what):
    with pytest.raises(ValueError):
        if what == "dense":
            interop.dense_totals_from_reference(
                np.zeros((16, 3, 2), np.float32), device="cpu")
        elif what == "ddos":
            m = 8
            interop.ddos_state_from_reference(
                *(np.zeros(m, np.float32),) * 2, np.zeros(m, bool),
                np.zeros(m, np.float32), np.zeros(5, np.float32),
                np.zeros((m, 4), np.int64), np.zeros(m, np.float32),
                device="cpu")
        else:
            interop.window_agg_from_reference(
                {300: {(1, 2): np.zeros(3, np.uint64)}}, 0, device="cpu")
