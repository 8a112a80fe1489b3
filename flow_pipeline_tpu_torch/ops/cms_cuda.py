"""The conservative count-min update as a hand-written CUDA kernel.

Counterpart of flow_pipeline_tpu/ops/cms_pallas.py
``cms_add_conservative_pallas`` (TPU kernel ``_max_kernel``). The kernel
is ``csrc/cms_conservative.cu`` (two launches: targets from the
pre-update sketch, then an atomicMax scatter), built by ``kernels.py``.

``cms_add_conservative`` takes the plain PyTorch version
(ops/cms.py) only for tensors on the CPU. For a CUDA tensor it launches
the kernel or raises; nothing falls back. The sketch is updated IN PLACE.
"""

from __future__ import annotations

import torch

from .. import kernels
from . import cms as cms_ops

# Calls of the wrapper that launched the kernel (one per update, however
# many launches it makes inside). chip_smoke.py zeroes it before driving
# the main path and reads it after.
LAUNCHES = 0

_MAX_WK, _MAX_D, _MAX_P = 16, 8, 8


def _check_inputs(counts, keys, values, valid) -> None:
    dev = counts.device
    if counts.dtype != torch.float32 or counts.dim() != 3 or \
            not counts.is_contiguous():
        raise ValueError("counts must be a contiguous [P, D, W] float32 "
                         f"tensor, got {counts.dtype} {tuple(counts.shape)}")
    p, d, w = counts.shape
    if keys.dim() != 2 or keys.dtype not in (torch.int32, torch.int64) or \
            not keys.is_contiguous():
        raise ValueError("keys must be contiguous [N, Wk] int32 or int64 "
                         f"lanes, got {keys.dtype} {tuple(keys.shape)}")
    n, wk = keys.shape
    if values.dtype != torch.float32 or tuple(values.shape) != (n, p) or \
            not values.is_contiguous():
        raise ValueError(f"values must be contiguous [{n}, {p}] float32, "
                         f"got {values.dtype} {tuple(values.shape)}")
    if valid.dtype != torch.bool or tuple(valid.shape) != (n,) or \
            not valid.is_contiguous():
        raise ValueError(f"valid must be a contiguous [{n}] bool tensor, "
                         f"got {valid.dtype} {tuple(valid.shape)}")
    for t, name in ((keys, "keys"), (values, "values"), (valid, "valid")):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, counts on {dev}")
    if not (1 <= wk <= _MAX_WK and 1 <= d <= _MAX_D and 1 <= p <= _MAX_P):
        raise ValueError(f"kernel limits: Wk <= {_MAX_WK}, D <= {_MAX_D}, "
                         f"P <= {_MAX_P}; got Wk={wk} D={d} P={p}")
    if n * d >= 2**31 or w >= 2**31:
        raise ValueError("N * D and W must stay below 2^31")


def cms_add_conservative(counts: torch.Tensor, keys: torch.Tensor,
                         values: torch.Tensor,
                         valid: torch.Tensor | None = None) -> torch.Tensor:
    """Conservative CMS update of ``counts`` in place; returns counts.

    Same contract as ops/cms.py cms_add_conservative: counts [P, D, W]
    float32, keys [N, Wk] unique key lanes (int32 or int64, low 32 bits
    are the word), values [N, P] float32, valid [N] bool."""
    global LAUNCHES
    if valid is None:
        valid = torch.ones(keys.shape[0], dtype=torch.bool,
                           device=keys.device)
    _check_inputs(counts, keys, values, valid)
    if counts.device.type == "cpu":
        return cms_ops.cms_add_conservative(counts, keys, values, valid)
    if counts.device.type != "cuda":
        raise ValueError(f"no kernel for device {counts.device}")
    p, d, w = counts.shape
    n, wk = keys.shape
    if n == 0:
        return counts
    lib = kernels.library()
    buckets = torch.empty((d, n), dtype=torch.int32, device=counts.device)
    target = torch.empty((n, p), dtype=torch.float32, device=counts.device)
    with torch.cuda.device(counts.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fpt_cms_add_conservative(
            counts.data_ptr(), keys.data_ptr(), keys.element_size(),
            values.data_ptr(), valid.data_ptr(), n, wk, p, d, w,
            buckets.data_ptr(), target.data_ptr(), stream)
    kernels.check(lib, err, "fpt_cms_add_conservative")
    LAUNCHES += 1
    return counts
