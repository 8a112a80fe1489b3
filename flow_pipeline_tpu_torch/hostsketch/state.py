"""Host-resident heavy-hitter state and its conversions to the models'.

Counterpart of flow_pipeline_tpu/hostsketch/state.py. The host engine
keeps CMS counters in uint64 (the exact monoid: u64 addition is
associative, which makes the threaded native update deterministic) and
the top-K table in the reference's layout (uint32 keys, float32 values:
both paths accumulate table values by single f32 adds, so keeping f32
here makes table parity unconditional). The model-facing state of the
table family is the port's torch ``HHState`` on the model's device; the
conversions are lossless on the uint64-exact envelope:

- u64 -> f32 export is exact while cells stay below 2^24, the envelope
  inside which the device's own f32 accumulation is exact;
- f32 -> u64 import is exact for every integer-valued f32 cell, which the
  device path produces by construction (counters are integer sums of
  integer-valued addends).

Out-of-envelope values clamp instead of corrupting (NaN and negatives ->
0, overflow -> the largest f32 below 2^64). The invertible family's state
is host numpy uint64 on both sides (``InvState``): there is no f32 layout
for its key-recovery planes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models.heavy_hitter import (HeavyHitterConfig, HHState, InvState,
                                   key_width)

# Largest float32 strictly below 2^64: the clamp for out-of-envelope cells
# on import (astype(u64) of +/-inf or >= 2^64 is undefined).
_U64_CAP = np.float32(1.8446742e19)


@dataclass
class HostHHState:
    """One table family's host state (engine-owned buffers)."""

    cms: np.ndarray         # [P+1, depth, width] uint64, C-contiguous
    table_keys: np.ndarray  # [capacity, key_width] uint32, C-contiguous
    table_vals: np.ndarray  # [capacity, P+1] float32, C-contiguous


@dataclass
class HostInvState:
    """One invertible family's host state: the count/value planes and the
    key-recovery planes, all u64 wrap sums (linear in the stream), from
    which heavy keys are decoded at window close. No candidate table."""

    cms: np.ndarray       # [P+1, depth, width] uint64, C-contiguous
    keysum: np.ndarray    # [depth, width, key_width] uint64
    keycheck: np.ndarray  # [depth, width] uint64


def host_hh_init(config: HeavyHitterConfig) -> HostHHState:
    planes = len(config.value_cols) + 1  # + count plane
    w = key_width(config)
    return HostHHState(
        cms=np.zeros((planes, config.depth, config.width), np.uint64),
        table_keys=np.full((config.capacity, w), 0xFFFFFFFF, np.uint32),
        table_vals=np.zeros((config.capacity, planes), np.float32))


def host_inv_init(config: HeavyHitterConfig) -> HostInvState:
    planes = len(config.value_cols) + 1  # + count plane
    w = key_width(config)
    return HostInvState(
        cms=np.zeros((planes, config.depth, config.width), np.uint64),
        keysum=np.zeros((config.depth, config.width, w), np.uint64),
        keycheck=np.zeros((config.depth, config.width), np.uint64))


def is_inv_state(state) -> bool:
    """Whether a state form (HostInvState, InvState, or a checkpoint field
    dict) is an invertible-family state."""
    if isinstance(state, dict):
        return "keysum" in state
    return hasattr(state, "keysum")


def is_spread_state(state) -> bool:
    """Whether a state form (SpreadState or a checkpoint field dict) is a
    spread-family state (host numpy registers by design)."""
    if isinstance(state, dict):
        return "regs" in state
    return hasattr(state, "regs")


def _np(a) -> np.ndarray:
    """A host numpy view (or copy) of a tensor or array leaf."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _cms_to_u64(cms) -> np.ndarray:
    a = np.asarray(_np(cms), dtype=np.float32)
    # healthy sketches (finite, in [0, 2^64)) convert in one pass; NaN
    # compares False, so any pathological cell takes the clamping path
    lo, hi = a.min(initial=np.float32(0.0)), a.max(initial=np.float32(0.0))
    if np.float32(0.0) <= lo and hi <= _U64_CAP:
        return np.ascontiguousarray(a.astype(np.uint64))
    with np.errstate(invalid="ignore"):
        a = np.nan_to_num(a, nan=0.0, posinf=float(_U64_CAP), neginf=0.0)
        a = np.clip(a, np.float32(0.0), _U64_CAP)
    return np.ascontiguousarray(a.astype(np.uint64))


def frozen_cms(state) -> np.ndarray:
    """The CMS planes of any state form (torch HHState, HostHHState,
    HostInvState, InvState, a checkpoint field dict, or bare planes) as a
    FRESH uint64 array."""
    if isinstance(state, (HostHHState, HostInvState)):
        return state.cms.copy()
    if not isinstance(state, (np.ndarray, torch.Tensor)):
        state = state["cms"] if isinstance(state, dict) else state.cms
    a = _np(state)
    if a.dtype == np.uint64:
        # exact u64 planes: the f32 route would destroy cells past 2^24
        return np.ascontiguousarray(a).copy()
    return _cms_to_u64(a)


def _u64_leaf(a) -> np.ndarray:
    """A fresh C-contiguous uint64 copy of a u64 leaf."""
    return np.array(_np(a), dtype=np.uint64, order="C", copy=True)


def from_device_state(state):
    """Import a model-facing state (the port's HHState of tensors on any
    device, InvState, or a checkpoint field dict) into fresh engine-owned
    host buffers: the engine mutates its state in place and must never
    alias arrays a lazy window close or a checkpoint may still read."""
    if is_inv_state(state):
        if isinstance(state, dict):
            cms, ks, kc = state["cms"], state["keysum"], state["keycheck"]
        else:
            cms, ks, kc = state.cms, state.keysum, state.keycheck
        return HostInvState(cms=_u64_leaf(cms), keysum=_u64_leaf(ks),
                            keycheck=_u64_leaf(kc))
    if isinstance(state, dict):
        cms, tk, tv = (state["cms"], state["table_keys"],
                       state["table_vals"])
    else:
        cms, tk, tv = state.cms, state.table_keys, state.table_vals
    # the port carries u32 lanes in int64 tensors: the values are < 2^32
    return HostHHState(
        cms=_cms_to_u64(cms),
        table_keys=np.array(_np(tk).astype(np.uint32), order="C",
                            copy=True),
        table_vals=np.array(_np(tv), dtype=np.float32, order="C",
                            copy=True))


def to_device_state(host, device: torch.device):
    """Export engine state as a fresh model-facing state: a torch HHState
    on ``device`` for the table family (consumed by the window close's
    top-K extraction, checkpoints and a switch back to the device step),
    a numpy InvState for the invertible family."""
    if isinstance(host, HostInvState):
        return InvState(cms=host.cms.copy(), keysum=host.keysum.copy(),
                        keycheck=host.keycheck.copy())
    return HHState(
        cms=torch.from_numpy(host.cms.astype(np.float32)).to(device),
        table_keys=torch.from_numpy(
            host.table_keys.astype(np.int64)).to(device),
        table_vals=torch.from_numpy(host.table_vals.copy()).to(device))
