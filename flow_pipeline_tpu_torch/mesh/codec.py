"""The mesh codec: serialized per-window sketch and aggregate state.

Counterpart of flow_pipeline_tpu/mesh/codec.py. A payload crosses a
process boundary as one framed byte envelope: a JSON structure tree plus
an in-memory ``.npz`` archive of every array leaf, the same no-pickle
split engine/checkpoint.py uses, so it is safe to accept from another
trust domain and survives encode -> decode bit for bit (dtype, shape and
every word). The envelope's bytes equal the reference's for the same
tree.

The canonical heavy-hitter payload keeps the CMS in uint64 (the exact
merge monoid), converting float32 sketches, on the card too, through
hostsketch/state.py ``frozen_cms``. Table keys stay uint32 (the port's
int64 carriers are narrowed), table values float32.
"""

from __future__ import annotations

import io
import json

import numpy as np

from ..engine.checkpoint import _decode, _encode
from ..families import registry
from ..hostsketch.state import HostHHState, _np, frozen_cms, is_inv_state

MAGIC = b"FMSH1\n"


def encode(obj) -> bytes:
    """Nested dicts, lists, tuples, scalars and numpy arrays -> framed
    bytes."""
    arrays: dict[str, np.ndarray] = {}
    meta = json.dumps(_encode(obj, arrays, "r")).encode()
    buf = io.BytesIO()
    # uncompressed: the CMS planes are incompressible counter noise
    np.savez(buf, **arrays)
    return MAGIC + len(meta).to_bytes(8, "little") + meta + buf.getvalue()


def decode(data: bytes):
    """Framed bytes -> the original structure with numpy array leaves."""
    if not data.startswith(MAGIC):
        raise ValueError("not a flowmesh payload (bad magic)")
    off = len(MAGIC)
    meta_len = int.from_bytes(data[off:off + 8], "little")
    off += 8
    meta = json.loads(data[off:off + meta_len].decode())
    blob = data[off + meta_len:]
    arrays = np.load(io.BytesIO(blob)) if blob else {}
    return _decode(meta, arrays)


# ---- model-state capture ----------------------------------------------------
#
# One payload shape per model kind, all host numpy (no tensor crosses a
# process). ``kind`` tags dispatch the merge.


def _u64_plane(a) -> np.ndarray:
    return np.ascontiguousarray(_np(a), dtype=np.uint64).copy()


def hh_payload(state) -> dict:
    """An HHState (torch, on any device), a host sketch state or a
    checkpoint field dict -> the canonical uint64-CMS payload. Always
    copies. Invertible states ship as ``kind="hh_inv"``: the three u64
    plane sets, linear, so their merge is an element-wise sum."""
    if is_inv_state(state):
        if isinstance(state, dict):
            ks, kc = state["keysum"], state["keycheck"]
        else:
            ks, kc = state.keysum, state.keycheck
        return {"kind": "hh_inv", "cms": frozen_cms(state),
                "keysum": _u64_plane(ks), "keycheck": _u64_plane(kc)}
    if isinstance(state, HostHHState):
        return {"kind": "hh", "cms": frozen_cms(state),
                "table_keys": state.table_keys.copy(),
                "table_vals": state.table_vals.copy()}
    if isinstance(state, dict):
        tk, tv = state["table_keys"], state["table_vals"]
    else:
        tk, tv = state.table_keys, state.table_vals
    return {
        "kind": "hh",
        "cms": frozen_cms(state),
        "table_keys": np.ascontiguousarray(_np(tk), dtype=np.uint32).copy(),
        "table_vals": np.ascontiguousarray(_np(tv), dtype=np.float32).copy(),
    }


def wagg_payload(store: dict) -> dict:
    """One window-store dict {key tuple -> uint64 [values..., count]} ->
    columnar (keys [G, L] uint32, vals [G, V] uint64) payload."""
    if not store:
        return {"kind": "wagg",
                "keys": np.zeros((0, 0), np.uint32),
                "vals": np.zeros((0, 0), np.uint64)}
    lanes = len(next(iter(store)))
    keys = np.fromiter((x for key in store for x in key), dtype=np.uint64,
                       count=len(store) * lanes).reshape(len(store), lanes)
    vals = np.stack([np.asarray(v, dtype=np.uint64)
                     for v in store.values()])
    return {"kind": "wagg", "keys": keys.astype(np.uint32), "vals": vals}


def dense_payload(totals) -> dict:
    """Dense accumulator planes -> payload (int64: headroom for an
    N-member sum)."""
    return {"kind": "dense", "totals": _np(totals).astype(np.int64)}


def spread_payload(state) -> dict:
    """A SpreadState (or checkpoint field dict) -> the canonical spread
    payload: the u8 register planes verbatim (the exact max-monoid form),
    the candidate table as u32 keys and its f32 admission metric."""
    if isinstance(state, dict):
        regs, tk, tm = (state["regs"], state["table_keys"],
                        state["table_metric"])
    else:
        regs, tk, tm = state.regs, state.table_keys, state.table_metric
    return {
        "kind": "spread",
        "regs": np.ascontiguousarray(_np(regs), dtype=np.uint8).copy(),
        "table_keys": np.ascontiguousarray(_np(tk), dtype=np.uint32).copy(),
        "table_metric": np.ascontiguousarray(_np(tm),
                                             dtype=np.float32).copy(),
    }


def capture_model(model) -> dict:
    """The state payload of one windowed model (the object a
    WindowedHeavyHitter wraps): the family registry maps its
    snapshot_kind to the payload hook and the state attribute."""
    kind = getattr(model, "snapshot_kind", None)
    fam = registry.family_for_snapshot(kind) if kind else None
    if fam is None or fam.payload is None or fam.state_attr is None:
        raise TypeError(f"no mesh payload for model kind {kind!r}")
    return registry.hook(fam, "payload")(getattr(model, fam.state_attr))
