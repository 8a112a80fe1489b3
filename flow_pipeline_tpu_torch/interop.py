"""Carry model state between the JAX package and the port.

This system has no weights: a model's window state (a heavy-hitter
family's CMS planes and top-K table, a port table's dense totals, the
DDoS detector's baselines, a spread detector's registers and candidate
table, a flows_5m window store) is what a model's
weights are elsewhere. These functions move it across as numpy arrays, so
neither package imports the other: ``np.asarray`` of the JAX state's
fields goes in, and each inverse gives arrays the JAX package accepts
(``HHState(*map(jnp.asarray, ...))``, ``jnp.asarray(totals)``,
``DDoSState(*map(jnp.asarray, ...))``; a window store is host dicts on
both sides).

A checkpoint (engine/checkpoint.py) that either package writes must load
in the other, so it stores the reference's dtypes: the port keeps u32
lanes in int64 carriers (``HHState.table_keys``, ``DDoSState.addrs``),
and ``*_to_checkpoint`` writes them as uint32 host arrays, while
``*_from_checkpoint`` converts a loaded field dict back onto the model's
device.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import DEFAULT_DEVICE, resolve_device
from .models.ddos import DDoSState
from .models.heavy_hitter import HHState, InvState
from .models.spread import SpreadState
from .models.window_agg import WindowAggConfig, WindowAggregator


def hh_state_from_reference(cms, table_keys, table_vals,
                            device=DEFAULT_DEVICE) -> HHState:
    """The port's HHState on ``device`` from the reference's arrays:
    cms [P, D, W] float32, table_keys [C, Wk] uint32, table_vals [C, P]
    float32."""
    dev = resolve_device(device)
    cms = np.asarray(cms, dtype=np.float32)
    keys = np.asarray(table_keys)
    if keys.dtype != np.uint32:
        raise ValueError(f"table_keys must be uint32, got {keys.dtype}")
    vals = np.asarray(table_vals, dtype=np.float32)
    if cms.ndim != 3 or keys.ndim != 2 or vals.shape != (keys.shape[0],
                                                         cms.shape[0]):
        raise ValueError(f"inconsistent shapes: cms {cms.shape}, table_keys "
                         f"{keys.shape}, table_vals {vals.shape}")
    return HHState(
        cms=torch.from_numpy(cms.copy()).to(dev),
        table_keys=torch.from_numpy(keys.astype(np.int64)).to(dev),
        table_vals=torch.from_numpy(vals.copy()).to(dev))


def hh_state_to_reference(state: HHState):
    """(cms float32, table_keys uint32, table_vals float32) numpy arrays
    in the reference's layout."""
    return (state.cms.cpu().numpy().copy(),
            state.table_keys.cpu().numpy().astype(np.uint32),
            state.table_vals.cpu().numpy().copy())


def dense_totals_from_reference(totals, device=DEFAULT_DEVICE) -> torch.Tensor:
    """A port table's totals on ``device`` from the reference's
    [domain, P+1, 2] int32 (lo, hi) planes."""
    totals = np.asarray(totals)
    if totals.dtype != np.int32 or totals.ndim != 3 or totals.shape[2] != 2:
        raise ValueError(f"totals must be [domain, P+1, 2] int32, got "
                         f"{totals.dtype} {totals.shape}")
    return torch.from_numpy(totals.copy()).to(resolve_device(device))


def dense_totals_to_reference(totals: torch.Tensor) -> np.ndarray:
    """[domain, P+1, 2] int32 numpy planes in the reference's layout."""
    return totals.cpu().numpy().copy()


def ddos_state_from_reference(mean, var, seen, rates, hist, addrs, wmax,
                              device=DEFAULT_DEVICE) -> DDoSState:
    """The port's DDoSState on ``device`` from the reference's seven
    arrays: mean, var, rates, wmax [M] float32, seen [M] bool, hist [B]
    float32, addrs [M, 4] uint32."""
    dev = resolve_device(device)
    addrs = np.asarray(addrs)
    if addrs.dtype != np.uint32 or addrs.ndim != 2 or addrs.shape[1] != 4:
        raise ValueError(f"addrs must be [M, 4] uint32, got {addrs.dtype} "
                         f"{addrs.shape}")
    m = addrs.shape[0]

    def f32(a, name):
        a = np.asarray(a, dtype=np.float32)
        if a.shape != (m,):
            raise ValueError(f"{name} must be [{m}], got {a.shape}")
        return torch.from_numpy(a.copy()).to(dev)

    seen = np.asarray(seen)
    if seen.dtype != np.bool_ or seen.shape != (m,):
        raise ValueError(f"seen must be [{m}] bool, got {seen.dtype} "
                         f"{seen.shape}")
    return DDoSState(
        mean=f32(mean, "mean"), var=f32(var, "var"),
        seen=torch.from_numpy(seen.copy()).to(dev),
        rates=f32(rates, "rates"),
        hist=torch.from_numpy(np.asarray(hist, np.float32).copy()).to(dev),
        addrs=torch.from_numpy(addrs.astype(np.int64)).to(dev),
        wmax=f32(wmax, "wmax"))


def ddos_state_to_reference(state: DDoSState):
    """(mean, var, seen, rates, hist, addrs, wmax) numpy arrays in the
    reference's dtypes (addrs uint32)."""
    out = [t.cpu().numpy().copy() for t in state]
    out[DDoSState._fields.index("addrs")] = out[
        DDoSState._fields.index("addrs")].astype(np.uint32)
    return tuple(out)


def _copy_store(windows: dict, lanes: int) -> dict:
    out = {}
    for slot, store in windows.items():
        copied = {}
        for key, acc in store.items():
            acc = np.asarray(acc)
            if len(key) != lanes or acc.dtype != np.uint64:
                raise ValueError(
                    f"window store rows must be {lanes}-lane key tuples of "
                    f"uint64 accumulators, got {len(key)} lanes, "
                    f"{acc.dtype}")
            copied[tuple(int(x) for x in key)] = acc.copy()
        out[int(slot)] = copied
    return out


def window_agg_from_reference(windows: dict, watermark: int,
                              config: WindowAggConfig = WindowAggConfig(),
                              device=DEFAULT_DEVICE) -> WindowAggregator:
    """A port WindowAggregator holding a copy of the reference's window
    store ({timeslot: {key tuple: uint64 [*values, count]}}, its pending
    partials drained first) and watermark."""
    agg = WindowAggregator(config, device=device)
    agg.windows = _copy_store(windows, agg.store_key_lanes)
    agg.watermark = int(watermark)
    return agg


def window_agg_to_reference(agg: WindowAggregator):
    """(windows, watermark): a copy of the port's store after a drain, in
    the reference's layout."""
    agg._drain()
    return _copy_store(agg.windows, agg.store_key_lanes), agg.watermark


# ---- checkpoint leaves ------------------------------------------------------

def hh_state_to_checkpoint(state):
    """An HHState of host numpy arrays in the reference's dtypes (the
    checkpoint stores the NamedTuple's fields by name); an invertible
    family's InvState as a copy of its uint64 planes, the reference's
    form too."""
    if isinstance(state, InvState):
        return InvState(*(np.array(a, dtype=np.uint64) for a in state))
    return HHState(*hh_state_to_reference(state))


def hh_state_from_checkpoint(fields: dict, device=DEFAULT_DEVICE) -> HHState:
    """The port's HHState on ``device`` from a loaded checkpoint's field
    dict (cms, table_keys uint32, table_vals)."""
    return hh_state_from_reference(fields["cms"], fields["table_keys"],
                                   fields["table_vals"], device)


def inv_state_from_checkpoint(fields: dict) -> InvState:
    """An invertible family's InvState (host numpy uint64) from a loaded
    checkpoint's field dict (or the reference's InvState as
    ``_asdict()``)."""
    cms, ks, kc = (np.asarray(fields[f]) for f in InvState._fields)
    for name, a, ndim in (("cms", cms, 3), ("keysum", ks, 3),
                          ("keycheck", kc, 2)):
        if a.dtype != np.uint64 or a.ndim != ndim:
            raise ValueError(f"{name} must be a {ndim}-D uint64 array, got "
                             f"{a.dtype} {a.shape}")
    if ks.shape[:2] != cms.shape[1:] or kc.shape != cms.shape[1:]:
        raise ValueError(f"inconsistent shapes: cms {cms.shape}, keysum "
                         f"{ks.shape}, keycheck {kc.shape}")
    return InvState(cms.copy(), ks.copy(), kc.copy())


def ddos_state_to_checkpoint(state: DDoSState) -> DDoSState:
    """A DDoSState of host numpy arrays in the reference's dtypes (addrs
    uint32)."""
    return DDoSState(*ddos_state_to_reference(state))


def ddos_state_from_checkpoint(fields: dict,
                               device=DEFAULT_DEVICE) -> DDoSState:
    """The port's DDoSState on ``device`` from a loaded checkpoint's field
    dict."""
    return ddos_state_from_reference(
        *(fields[f] for f in DDoSState._fields), device=device)


def spread_state_to_checkpoint(state: SpreadState) -> SpreadState:
    """A copy of a spread state in the reference's dtypes (regs uint8,
    table_keys uint32, table_metric float32). Spread state is host numpy
    in both packages, so this also is its reference form."""
    return SpreadState(np.array(state.regs, dtype=np.uint8),
                       np.array(state.table_keys, dtype=np.uint32),
                       np.array(state.table_metric, dtype=np.float32))


def spread_state_from_checkpoint(fields: dict) -> SpreadState:
    """A port SpreadState (host numpy) from a loaded checkpoint's field
    dict (or the reference's SpreadState as ``_asdict()``)."""
    regs = np.asarray(fields["regs"])
    keys = np.asarray(fields["table_keys"])
    metric = np.asarray(fields["table_metric"])
    if regs.dtype != np.uint8 or regs.ndim != 3:
        raise ValueError(f"regs must be [D, W, m] uint8, got {regs.dtype} "
                         f"{regs.shape}")
    if keys.dtype != np.uint32 or keys.ndim != 2 or \
            metric.shape != (keys.shape[0],):
        raise ValueError(f"table_keys must be [C, Wk] uint32 and "
                         f"table_metric [C]; got {keys.dtype} {keys.shape}, "
                         f"{metric.shape}")
    return spread_state_to_checkpoint(SpreadState(regs, keys, metric))
