"""The count-min updates as hand-written CUDA kernels.

Counterparts of flow_pipeline_tpu/ops/cms_pallas.py:

- ``cms_add``: the linear update (``cms_add_pallas``, TPU kernel
  ``_add_kernel``), ``csrc/cms_linear.cu``;
- ``cms_add_conservative``: the conservative update
  (``cms_add_conservative_pallas``, TPU kernel ``_max_kernel``),
  ``csrc/cms_conservative.cu``.

Each is ONE cooperative launch per call. With ``with_estimate=True`` the
same launch also returns the post-update estimates of every row, which
is what ``ops/cms.py cms_query`` would read from the updated sketch, so
a caller that needs them does not hash its keys a second time.

Both are built by ``kernels.py``. Each wrapper takes the plain PyTorch
version (ops/cms.py) only for tensors on the CPU. For a CUDA tensor it
launches the kernel or raises; nothing falls back. The sketch is updated
IN PLACE.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from . import cms as cms_ops

# Wrapper calls that launched each kernel (one launch per call, either
# form). chip_smoke.py zeroes them before driving the main path and reads
# them after.
LAUNCHES = {"cms_add": 0, "cms_add_conservative": 0}

_MAX_WK, _MAX_D, _MAX_P = 16, 8, 8
_F32, _I32, _I64, _BOOL = torch.float32, torch.int32, torch.int64, torch.bool
# (kernel, device index, Wk, D, P) -> rows the register route takes in one
# launch; above it the wrapper passes scratch
_resident: dict = {}


def _check_inputs(counts, keys, values, valid) -> None:
    if counts.dtype != _F32 or counts.dim() != 3 or \
            not counts.is_contiguous():
        raise ValueError("counts must be a contiguous [P, D, W] float32 "
                         f"tensor, got {counts.dtype} {tuple(counts.shape)}")
    p, d, w = counts.shape
    if keys.dim() != 2 or (keys.dtype != _I64 and keys.dtype != _I32) or \
            not keys.is_contiguous():
        raise ValueError("keys must be contiguous [N, Wk] int32 or int64 "
                         f"lanes, got {keys.dtype} {tuple(keys.shape)}")
    n, wk = keys.shape
    if values.dtype != _F32 or values.shape != (n, p) or \
            not values.is_contiguous():
        raise ValueError(f"values must be contiguous [{n}, {p}] float32, "
                         f"got {values.dtype} {tuple(values.shape)}")
    if valid.dtype != _BOOL or valid.shape != (n,) or \
            not valid.is_contiguous():
        raise ValueError(f"valid must be a contiguous [{n}] bool tensor, "
                         f"got {valid.dtype} {tuple(valid.shape)}")
    dev = counts.device
    if keys.device != dev or values.device != dev or valid.device != dev:
        raise ValueError(f"keys, values and valid on {keys.device}, "
                         f"{values.device}, {valid.device}; counts on {dev}")
    if not (1 <= wk <= _MAX_WK and 1 <= d <= _MAX_D and 1 <= p <= _MAX_P):
        raise ValueError(f"kernel limits: Wk <= {_MAX_WK}, D <= {_MAX_D}, "
                         f"P <= {_MAX_P}; got Wk={wk} D={d} P={p}")
    if n * d >= 2**31 or n * p >= 2**31 or w >= 2**31:
        raise ValueError("N * D, N * P and W must stay below 2^31")


def _prepare(counts, keys, valid):
    """valid defaulted to all-true; raises for a device with no kernel."""
    if valid is None:
        valid = torch.ones(keys.shape[0], dtype=_BOOL, device=keys.device)
    if counts.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {counts.device}")
    return valid


def _resident_rows(lib, name, index, wk, d, p) -> int:
    """Rows the register route of ``name``'s kernel (the form that keeps
    state across a barrier) takes in one launch on device ``index``:
    resident blocks times threads, asked of the card once."""
    key = (name, index, wk, d, p)
    rows = _resident.get(key)
    if rows is None:
        out = ctypes.c_int(0)
        if name == "cms_add_conservative":
            err = lib.fpt_cms_conservative_resident_rows(wk, d, p, 1,
                                                         ctypes.byref(out))
        else:
            err = lib.fpt_cms_linear_resident_rows(wk, d, p,
                                                   ctypes.byref(out))
        kernels.check(lib, err, f"{name}: resident rows")
        rows = _resident[key] = out.value
    return rows


def _launch(name, counts, keys, values, valid, est):
    """One kernel launch on counts' device and its current stream."""
    p, d, w = counts.shape
    n, wk = keys.shape
    lib = kernels.library()
    dev = counts.device
    # scratch only where a barrier must carry per-row state and the
    # register route cannot hold every row
    scratch = name == "cms_add_conservative" or est is not None
    buckets = target = None
    if scratch and n > _resident_rows(lib, name, dev.index, wk, d, p):
        buckets = torch.empty((d, n), dtype=_I32, device=dev)
        if name == "cms_add_conservative":
            target = torch.empty((n, p), dtype=_F32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (counts.data_ptr(), keys.data_ptr(), keys.element_size(),
            values.data_ptr(), valid.data_ptr(), n, wk, p, d, w,
            None if est is None else est.data_ptr(),
            None if buckets is None else buckets.data_ptr())
    if name == "cms_add_conservative":
        args += (None if target is None else target.data_ptr(),)
        fn = lib.fpt_cms_conservative
    else:
        fn = lib.fpt_cms_linear
    err = fn(*args, stream)
    kernels.check(lib, err, name)
    LAUNCHES[name] += 1


def _run(name, plain, counts, keys, values, valid, with_estimate):
    valid = _prepare(counts, keys, valid)
    _check_inputs(counts, keys, values, valid)
    if counts.device.type == "cpu":
        plain(counts, keys, values, valid)
        return ((counts, cms_ops.cms_query(counts, keys)) if with_estimate
                else counts)
    est = (torch.empty(tuple(values.shape), dtype=_F32, device=counts.device)
           if with_estimate else None)
    if keys.shape[0]:
        if counts.device.index == torch.cuda.current_device():
            _launch(name, counts, keys, values, valid, est)
        else:
            with torch.cuda.device(counts.device):
                _launch(name, counts, keys, values, valid, est)
    return (counts, est) if with_estimate else counts


def cms_add(counts: torch.Tensor, keys: torch.Tensor, values: torch.Tensor,
            valid: torch.Tensor | None = None, *,
            with_estimate: bool = False):
    """Linear CMS update of ``counts`` in place; returns counts, or
    ``(counts, est)`` with ``with_estimate``.

    Same contract as ops/cms.py cms_add: counts [P, D, W] float32, keys
    [N, Wk] key lanes (int32 or int64, low 32 bits are the word), values
    [N, P] float32, valid [N] bool. ``est`` [N, P] float32 is ops/cms.py
    cms_query(counts, keys) after the update, for every row."""
    return _run("cms_add", cms_ops.cms_add, counts, keys, values, valid,
                with_estimate)


def cms_add_conservative(counts: torch.Tensor, keys: torch.Tensor,
                         values: torch.Tensor,
                         valid: torch.Tensor | None = None, *,
                         with_estimate: bool = False):
    """Conservative CMS update of ``counts`` in place; returns counts, or
    ``(counts, est)`` with ``with_estimate``.

    Same contract as ops/cms.py cms_add_conservative: counts [P, D, W]
    float32, keys [N, Wk] unique key lanes (int32 or int64, low 32 bits
    are the word), values [N, P] float32, valid [N] bool. ``est`` [N, P]
    float32 is ops/cms.py cms_query(counts, keys) after the update, for
    every row."""
    return _run("cms_add_conservative", cms_ops.cms_add_conservative,
                counts, keys, values, valid, with_estimate)
