"""Carry sketch state between the JAX package and the port.

This system has no weights: a heavy-hitter family's sketch state (the CMS
planes and the top-K table) is what a model's weights are elsewhere. These
functions move it across as numpy arrays, so neither package imports the
other: ``np.asarray`` of the JAX ``HHState`` fields goes in, and the
inverse gives arrays the JAX package accepts (``HHState(*map(jnp.asarray,
...))``).
"""

from __future__ import annotations

import numpy as np
import torch

from .device import DEFAULT_DEVICE, resolve_device
from .models.heavy_hitter import HHState


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
