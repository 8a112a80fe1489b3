"""Port parity: the dense port tables, torch (CPU) against the JAX
package. Totals are int32 (lo, hi) planes and must be bit-equal, and so
must the top-k keys, planes and validity (tolerance: none); ties in the
float32 rank go to the lower index first, as jax.lax.top_k orders them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_pipeline_tpu.gen import FlowGenerator as JGen
from flow_pipeline_tpu.gen import ZipfProfile as JZipf
from flow_pipeline_tpu.models import dense_top as jdt
from flow_pipeline_tpu_torch.engine import WindowedHeavyHitter
from flow_pipeline_tpu_torch.models import dense_top as tdt
from flow_pipeline_tpu_torch.schema.batch import FlowBatch as TBatch
import torch_cpu  # noqa: F401  (one torch thread; see the module)


def _cols(rng, n, domain, saturate=False):
    """int32 bit patterns of the columns dense_update reads: ports in and
    out of the domain (uint32 >= 2^31 reads as a negative int32), values
    and rates big enough that the saturating multiply and the 16-bit
    carry both run."""
    port = rng.integers(0, domain, n).astype(np.uint32)
    odd = rng.random(n) < 0.05
    port[odd] = rng.choice(np.array([domain, domain + 5, 2**31, 2**32 - 1,
                                     2**32 - domain], np.uint64),
                           odd.sum()).astype(np.uint32)
    hi = 2**32 if saturate else 1 << 16
    cols = {"src_port": port,
            "bytes": rng.integers(0, hi, n, dtype=np.uint64).astype(np.uint32),
            "packets": rng.integers(0, 1 << 12, n).astype(np.uint32),
            "sampling_rate": rng.choice(np.array(
                [0, 1, 3, 1000, 1 << 20, 2**32 - 1], np.uint64), n).astype(
                    np.uint32)}
    return {k: v.view(np.int32) for k, v in cols.items()}


def _both(cfg, batches):
    jt = jnp.zeros((cfg.domain, 3, 2), jnp.int32)
    tt = tdt.dense_init(tdt.DenseTopConfig(**vars(cfg)), "cpu")
    tcfg = tdt.DenseTopConfig(**vars(cfg))
    for cols, valid in batches:
        jt = jdt.dense_update(jt, {k: jnp.asarray(v) for k, v in cols.items()},
                              jnp.asarray(valid), config=cfg)
        tt = tdt.dense_update(tt, {k: torch.from_numpy(v) for k, v in
                                   cols.items()}, torch.from_numpy(valid),
                              config=tcfg)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    return jt, tt, tcfg


@pytest.mark.parametrize("n,domain,saturate", [
    (700, 1 << 16, True),      # saturated values and rates
    (40000, 1 << 16, False),   # above 2^15 rows: two sub-chunks
    (40000, 512, True),        # a small domain: many rows dropped
], ids=["saturated", "two_subchunks", "small_domain"])
def test_dense_update_bit_equal(n, domain, saturate):
    rng = np.random.default_rng(n + domain)
    cfg = jdt.DenseTopConfig(domain=domain, batch_size=n)
    batches = [(_cols(rng, n, domain, saturate), rng.random(n) < 0.9)
               for _ in range(3)]
    jt, tt, _ = _both(cfg, batches)
    hi = np.asarray(jt)[:, :, 1]
    assert hi.max() > 0  # the carry ran
    assert (np.asarray(jt)[:, :, 0] < 1 << 16).all()


def test_dense_top_ties_and_rounded_ranks():
    """Most cells tie at rank 0 or 1 (never seen / seen with zero bytes),
    and totals above 2^23 round to equal float32 ranks: the port keeps
    the reference's order among ties."""
    domain = 4096
    rng = np.random.default_rng(9)
    totals = np.zeros((domain, 3, 2), np.int32)
    seen0 = rng.choice(domain, 300, replace=False)
    totals[seen0, 2, 0] = 1  # seen, zero bytes: rank 1
    big = rng.choice(np.setdiff1d(np.arange(domain), seen0), 60,
                     replace=False)
    # (hi * 65536 + lo) * 2 above 2^24: neighbours round to one float32
    totals[big, 0, 1] = 200
    totals[big, 0, 0] = rng.integers(0, 4, 60)
    totals[big, 2, 0] = 1
    cfg = jdt.DenseTopConfig(domain=domain)
    tcfg = tdt.DenseTopConfig(domain=domain)
    for k in (10, 100, 500):
        want = jdt.dense_top(jnp.asarray(totals), config=cfg, k=k)
        got = tdt.dense_top(torch.from_numpy(totals), config=tcfg, k=k)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_model_windows_bit_equal():
    """DenseTopKModel under the port's WindowedHeavyHitter against the
    reference's, over a stream whose windows close mid-stream."""
    from flow_pipeline_tpu.engine import WindowedHeavyHitter as JWindowed

    gen = JGen(JZipf(n_keys=500, alpha=1.1), seed=3, rate=5.0)
    jw = JWindowed(jdt.DenseTopConfig(key_col="dst_port", batch_size=256),
                   k=20, model_cls=jdt.DenseTopKModel)
    tw = WindowedHeavyHitter(
        tdt.DenseTopConfig(key_col="dst_port", batch_size=256), k=20,
        model_cls=tdt.DenseTopKModel, device="cpu")
    jrows, trows = [], []
    for _ in range(5):
        b = gen.batch(600)
        jw.update(b)
        tw.update(TBatch({k: v.copy() for k, v in b.columns.items()}))
        jrows += jw.flush()
        trows += tw.flush()
    jrows += jw.flush(force=True)
    trows += tw.flush(force=True)
    assert len(trows) == len(jrows) >= 3
    for got, want in zip(trows, jrows):
        assert got.keys() == want.keys()
        for name in want:
            assert got[name].dtype == np.asarray(want[name]).dtype, name
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=name)
