"""The port's CUDA kernel on the card, held against its plain PyTorch
version on the same inputs (tolerance: none; the atomicMax scatter is
order-free, so the kernel is bit-exact).

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
    before = cms_cuda.LAUNCHES
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
    assert cms_cuda.LAUNCHES == before + 3


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
