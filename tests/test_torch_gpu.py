"""The port's CUDA kernels on the card, held against their plain PyTorch
versions on the same inputs. Conservative update: tolerance none (the
atomicMax scatter is order-free, so the kernel is bit-exact). Linear
update: tolerance none with integer addends whose cell totals stay below
2^24 (every partial sum is exact, so atomic order cannot show); rtol 1e-6
with real-valued addends (float32 atomic adds in run-to-run order).

Marked ``gpu``: run with ``python -m pytest -m gpu tests/test_torch_gpu.py``
on a machine with a card. Whether a card is present is decided inside
each test, so every worker collects the same tests; without one they
skip with the reason.
"""

import numpy as np
import pytest
import torch

from flow_pipeline_tpu_torch.gen import FlowGenerator, ZipfProfile
from flow_pipeline_tpu_torch.models import heavy_hitter as thh
from flow_pipeline_tpu_torch.ops import cms as tcms
from flow_pipeline_tpu_torch.ops import cms_cuda

pytestmark = pytest.mark.gpu


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")


@pytest.mark.parametrize("wk,key_dtype", [(11, torch.int64), (4, torch.int64),
                                          (4, torch.int32)])
def test_conservative_kernel_matches_plain(wk, key_dtype):
    _require_cuda()
    rng = np.random.default_rng(wk)
    p, d, w, n = 3, 4, 65536, 32768
    counts = torch.from_numpy(
        rng.integers(0, 5000, size=(p, d, w)).astype(np.float32)).cuda()
    ref = counts.clone()
    before = cms_cuda.LAUNCHES["cms_add_conservative"]
    for _ in range(3):
        keys_np = rng.integers(0, 2**32, size=(n, wk), dtype=np.uint32)
        keys_np = np.unique(keys_np, axis=0)  # the update's contract
        keys = torch.from_numpy(keys_np.astype(np.int64) if key_dtype ==
                                torch.int64 else keys_np.view(np.int32))
        keys = keys.cuda()
        m = keys.shape[0]
        vals = torch.from_numpy(
            rng.integers(0, 1500, size=(m, p)).astype(np.float32)).cuda()
        valid = torch.from_numpy(rng.random(m) < 0.8).cuda()
        cms_cuda.cms_add_conservative(counts, keys, vals, valid)
        tcms.cms_add_conservative(ref, keys, vals, valid)
        torch.cuda.synchronize()
        assert torch.equal(counts, ref)
    assert cms_cuda.LAUNCHES["cms_add_conservative"] == before + 3


@pytest.mark.parametrize("wk,key_dtype", [(11, torch.int64), (4, torch.int64),
                                          (4, torch.int32)])
def test_linear_kernel_matches_plain(wk, key_dtype):
    _require_cuda()
    rng = np.random.default_rng(100 + wk)
    p, d, w, n = 3, 4, 65536, 32768
    counts = torch.from_numpy(
        rng.integers(0, 5000, size=(p, d, w)).astype(np.float32)).cuda()
    ref = counts.clone()
    before = dict(cms_cuda.LAUNCHES)
    for real in (False, False, True):
        keys_np = rng.integers(0, 2**32, size=(n, wk), dtype=np.uint32)
        keys = torch.from_numpy(keys_np.astype(np.int64) if key_dtype ==
                                torch.int64 else keys_np.view(np.int32))
        keys = keys.cuda()
        vals_np = (rng.random((n, p)) * 1e4 if real
                   else rng.integers(0, 1500, size=(n, p)))
        vals = torch.from_numpy(vals_np.astype(np.float32)).cuda()
        valid = torch.from_numpy(rng.random(n) < 0.8).cuda()
        cms_cuda.cms_add(counts, keys, vals, valid)
        tcms.cms_add(ref, keys, vals, valid)
        torch.cuda.synchronize()
        if real:  # float32 atomic order
            torch.testing.assert_close(counts, ref, rtol=1e-6, atol=0)
        else:  # integer cells below 2^24: exact in any order
            assert counts.max().item() < 2**24
            assert torch.equal(counts, ref)
    assert cms_cuda.LAUNCHES["cms_add"] == before["cms_add"] + 3
    assert (cms_cuda.LAUNCHES["cms_add_conservative"]
            == before["cms_add_conservative"])


def test_full_model_set_on_card_matches_cpu():
    """flows_5m, a port table and the DDoS detector on the card give the
    CPU's rows and alerts exactly (integer planes; DDoS rates below
    2^24)."""
    _require_cuda()
    from flow_pipeline_tpu_torch.engine import WindowedHeavyHitter
    from flow_pipeline_tpu_torch.models import (DDoSConfig, DDoSDetector,
                                                DenseTopConfig,
                                                DenseTopKModel,
                                                WindowAggConfig,
                                                WindowAggregator)

    gen = FlowGenerator(ZipfProfile(n_keys=2000), seed=2, rate=200.0)
    batches = [gen.batch(5000) for _ in range(4)]
    out = {}
    for dev in ("cuda", "cpu"):
        wagg = WindowAggregator(WindowAggConfig(batch_size=4096), device=dev)
        ports = WindowedHeavyHitter(DenseTopConfig(batch_size=4096), k=50,
                                    model_cls=DenseTopKModel, device=dev)
        ddos = DDoSDetector(DDoSConfig(batch_size=4096, warmup_windows=1),
                            device=dev)
        for b in batches:
            for m in (wagg, ports, ddos):
                m.update(b)
        ddos.close_sub_window()
        out[dev] = (wagg.flush(force=True), ports.flush(force=True),
                    ddos.alerts)
    (gw, gp, ga), (cw, cp, ca) = out["cuda"], out["cpu"]
    for name in cw:
        np.testing.assert_array_equal(gw[name], cw[name], err_msg=name)
    for g, c in zip(gp, cp):
        for name in c:
            np.testing.assert_array_equal(g[name], c[name], err_msg=name)
    assert len(ga) == len(ca)
    for g, c in zip(ga, ca):
        for name in c:
            np.testing.assert_array_equal(g[name], c[name], err_msg=name)


def test_model_on_card_matches_cpu():
    _require_cuda()
    cfg = thh.HeavyHitterConfig(key_cols=("src_addr", "dst_addr"),
                                batch_size=4096, width=8192, capacity=64)
    gen = FlowGenerator(ZipfProfile(n_keys=2000), seed=1, rate=1000.0)
    cpu = thh.HeavyHitterModel(cfg, device="cpu")
    gpu = thh.HeavyHitterModel(cfg, device="cuda")
    for _ in range(3):
        batch = gen.batch(5000)
        cpu.update(batch)
        gpu.update(batch)
    got, want = gpu.top(), cpu.top()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
