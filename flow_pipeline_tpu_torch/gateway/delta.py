"""The subscription feed's snapshot delta codec.

Counterpart of flow_pipeline_tpu/gateway/delta.py (frames byte-equal to
the reference's for equal snapshots). A published
:class:`~..serve.snapshot.Snapshot` is megabytes (the CMS planes
dominate), but consecutive versions are append-mostly: between window
closes only the open window's touched buckets and the freshest top-K rows
move. This codec makes shipping a snapshot O(change):

- :func:`snapshot_state` lowers a snapshot to its **canonical state
  dict**: plain numpy arrays only (top-K row columns, the frozen uint64
  CMS planes, range-slot row sets) plus JSON-safe metadata.
  :func:`state_to_snapshot` rebuilds an immutable ``Snapshot`` whose
  arrays are bit-identical to the source's.
- :func:`diff_states` emits a **delta**: per family the scalar metadata,
  the ranked rows only when a column changed, and the CMS per depth row
  as a **sparse dirty-column patch** (changed column indices and their
  values across all planes) or **dirty tiles** (``TILE_W``-wide column
  slabs, the dense-row fallback); comparison is uint64 equality, exact.
  A spread family's u8 register planes ride the same dirty-column coding
  (registers-last ``[D, W, m]`` viewed planes-first ``[m, D, W]``).
  Range tables ship the slot list plus the row sets of new or changed
  slots.
- Frames are ``FGWD1`` + ``u32 len | u32 crc32`` around a mesh-codec
  body (mesh/codec.py: a JSON tree plus an npz of the arrays). A torn or
  corrupted frame raises :class:`DeltaError`; an out-of-order delta
  raises :class:`DeltaGapError`. Both are the subscriber's cue to fall
  back to a full resync, never to guess. :func:`apply_delta` is the
  subscriber's side: ``apply_delta(prev, diff_states(prev, cur))`` is
  ``cur``, array for array.
"""

from __future__ import annotations

import struct
import zlib
from typing import Iterator, Optional

import numpy as np

from ..families import registry
from ..mesh import codec
from ..serve.snapshot import FamilyView, FrozenCms, Snapshot

MAGIC = b"FGWD1\n"
_HEAD = struct.Struct("<II")  # body_len, crc32(body)

# CMS dirty-tile width (uint64 words along the last plane axis), the
# DENSE-row coding: when most of a depth row changed, whole column
# slabs ship with one coordinate per TILE_W words.
TILE_W = 256

# Sparse-row threshold: hashed updates spread UNIFORMLY over a depth
# row, so even a few thousand touched buckets dirty almost every tile.
# A row whose changed-column fraction is below this ships as (column
# indices, column values) instead; per changed column that costs 8
# bytes of index + (P+1)*8 bytes of values, which beats the full row
# slab up to ~70% density for the 3-plane default.
SPARSE_FRAC = 0.5


class DeltaError(ValueError):
    """A torn, truncated, or CRC-failing frame — resync, don't guess."""


class DeltaGapError(DeltaError):
    """A delta whose ``from`` version does not match the local state:
    the chain has a hole (a missed publish, an evicted history);
    resync."""


# ---- snapshot <-> canonical state ------------------------------------------


def snapshot_state(snap: Snapshot) -> dict:
    """Lower one immutable snapshot to the canonical state dict. CMS
    planes are materialized here (``FrozenCms.get``: the lazy f32->u64
    freeze runs on the CALLER's thread, the feed's reader side, never
    the worker's, as for a first estimate reader)."""
    families = {}
    for name, f in snap.families.items():
        families[name] = {
            "kind": f.kind,
            "window_start": (None if f.window_start is None
                             else int(f.window_start)),
            "depth": int(f.depth),
            "key_lanes": int(f.key_lanes),
            "value_cols": list(f.value_cols),
            "rows": {c: np.asarray(v) for c, v in f.rows.items()},
            "cms": None if f.cms is None else np.asarray(f.cms.get()),
            "regs": None if f.regs is None else np.asarray(f.regs),
        }
    ranges = {
        table: [[int(slot), {c: np.asarray(v) for c, v in rows.items()}]
                for slot, rows in slots]
        for table, slots in snap.ranges.items()
    }
    return {
        "version": int(snap.version),
        "created": float(snap.created),
        "watermark": float(snap.watermark),
        "flows_seen": (None if snap.flows_seen is None
                       else int(snap.flows_seen)),
        "source": snap.source,
        "families": families,
        "ranges": ranges,
        "audit": dict(snap.audit),
    }


def state_to_snapshot(state: dict) -> Snapshot:
    """Rebuild the immutable read view from a canonical state dict.
    Arrays are used as-is (never copied): the rebuilt snapshot's answers
    are bit-identical to the source's because they ARE the same
    words."""
    families = {}
    for name, f in state["families"].items():
        cms = f["cms"]
        families[name] = FamilyView(
            name=name, kind=f["kind"], window_start=f["window_start"],
            depth=int(f["depth"]), rows=dict(f["rows"]),
            key_lanes=int(f["key_lanes"]),
            cms=None if cms is None else FrozenCms(value=cms),
            value_cols=tuple(f["value_cols"]),
            regs=f.get("regs"))
    ranges = {table: tuple((int(slot), dict(rows))
                           for slot, rows in slots)
              for table, slots in state["ranges"].items()}
    return Snapshot(
        version=int(state["version"]), created=float(state["created"]),
        watermark=float(state["watermark"]),
        flows_seen=state["flows_seen"], source=state["source"],
        families=families, ranges=ranges, audit=dict(state["audit"]))


# ---- diff / apply ----------------------------------------------------------


def _arrays_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        bool(np.array_equal(a, b))


def _rows_equal(a: dict, b: dict) -> bool:
    if set(a) != set(b):
        return False
    return all(_arrays_equal(a[c], b[c]) for c in a)


# Every plane layout the canonical state schema can carry: (state key,
# planes-first?). Registered families narrow this via delta_planes.
_ALL_PLANES = (("cms", False), ("regs", True))


def _plane_specs(kind: str) -> tuple:
    specs = registry.delta_planes(kind)
    if specs or registry.family_for_payload(kind) is not None:
        return specs
    # unregistered kind: diff every known plane layout — the gateway
    # must never guess a narrower schema for a family this build does
    # not know about
    return _ALL_PLANES


def _cms_diff(prev: np.ndarray,
              cur: np.ndarray) -> Optional[tuple[list, list]]:
    """Per-depth-row dirty coding: (sparse, tiles), or None when the
    shapes/dtypes force a full-plane ship. A mostly-clean row ships
    sparse ``[d, cols, vals]`` (``vals = cur[:, d, cols]`` — the
    column slice across every plane: a bucket's counts and sums dirty
    in lockstep); a dense row falls back to ``[d, w0, block]``
    TILE_W-wide slabs."""
    if prev.shape != cur.shape or prev.dtype != cur.dtype:
        return None
    sparse: list = []
    tiles: list = []
    depth, width = cur.shape[1], cur.shape[2]
    for d in range(depth):
        changed = (prev[:, d, :] != cur[:, d, :]).any(axis=0)
        cols = np.flatnonzero(changed)
        if cols.size == 0:
            continue
        if cols.size <= SPARSE_FRAC * width:
            sparse.append([int(d), cols.astype(np.int64),
                           np.ascontiguousarray(cur[:, d, cols])])
            continue
        for w0 in range(0, width, TILE_W):
            if changed[w0:w0 + TILE_W].any():
                tiles.append([int(d), int(w0), np.ascontiguousarray(
                    cur[:, d, w0:w0 + TILE_W])])
    return sparse, tiles


def diff_states(prev: dict, cur: dict) -> dict:
    """The delta tree from ``prev`` to ``cur`` (both canonical state
    dicts). The family and range-table maps in the delta are COMPLETE
    (their scalar metadata is tiny and carrying the full key set lets
    apply drop removed entries without a tombstone protocol); the
    arrays inside ship only where they changed.

    Which plane arrays a family diffs — and whether a plane is viewed
    planes-first (spread's registers-last ``[D, W, m]`` becomes ``[m,
    D, W]``: a bucket's m registers dirty together the way a CMS
    bucket's planes do) — comes from the family registry's
    ``delta_planes`` spec; unregistered kinds diff every known plane
    layout (never guess a narrower schema)."""
    families = {}
    for name, f in cur["families"].items():
        pf = prev["families"].get(name)
        entry = {
            "kind": f["kind"], "window_start": f["window_start"],
            "depth": f["depth"], "key_lanes": f["key_lanes"],
            "value_cols": list(f["value_cols"]),
        }
        if pf is None or not _rows_equal(pf["rows"], f["rows"]):
            entry["rows"] = f["rows"]
        for key, planes_first in _plane_specs(f["kind"]):
            val = f.get(key)
            pval = None if pf is None else pf.get(key)
            if val is None:
                if pf is None or pval is not None:
                    entry[key] = None
            elif pval is None:
                entry[key] = val
            else:
                diff = _cms_diff(
                    np.moveaxis(pval, 2, 0) if planes_first else pval,
                    np.moveaxis(val, 2, 0) if planes_first else val)
                if diff is None:
                    entry[key] = val
                else:
                    sparse, tiles = diff
                    if sparse:
                        entry[f"{key}_sparse"] = sparse
                    if tiles:
                        entry[f"{key}_tiles"] = tiles
                    # neither: apply carries the base plane forward
        families[name] = entry
    ranges = {}
    for table, slots in cur["ranges"].items():
        pslots = dict((int(s), rows)
                      for s, rows in prev["ranges"].get(table, []))
        chunks = {}
        for slot, rows in slots:
            old = pslots.get(int(slot))
            if old is None or not _rows_equal(old, rows):
                chunks[int(slot)] = rows
        ranges[table] = {"slots": [int(s) for s, _ in slots],
                         "chunks": chunks}
    delta = {
        "from": int(prev["version"]), "to": int(cur["version"]),
        "created": cur["created"], "watermark": cur["watermark"],
        "flows_seen": cur["flows_seen"], "source": cur["source"],
        "families": families, "ranges": ranges,
    }
    if cur["audit"] != prev["audit"]:
        delta["audit"] = cur["audit"]
    return delta


def apply_delta(prev: dict, delta: dict) -> dict:
    """``prev`` + one delta tree -> the next canonical state dict.
    Unchanged arrays are carried forward BY REFERENCE (states are
    immutable once built, the RCU discipline of the snapshots they
    rebuild). Raises :class:`DeltaGapError` on a chain hole."""
    if int(delta["from"]) != int(prev["version"]):
        raise DeltaGapError(
            f"delta chains from v{delta['from']} but local state is "
            f"v{prev['version']}")
    families = {}
    for name, entry in delta["families"].items():
        pf = prev["families"].get(name)
        rows = entry.get("rows")
        if rows is None:
            if pf is None:
                raise DeltaError(
                    f"delta introduces family {name!r} without rows")
            rows = pf["rows"]
        spec_keys = {k for k, _ in _plane_specs(entry["kind"])}
        planes = {}
        for key, planes_first in _ALL_PLANES:
            if key in entry:
                planes[key] = entry[key]
            elif f"{key}_tiles" in entry or f"{key}_sparse" in entry:
                base = None if pf is None else pf.get(key)
                if base is None:
                    raise DeltaError(
                        f"delta patches {key} planes for {name!r} with "
                        "no base planes")
                arr = base.copy()
                # patch through the planes-first view where the family
                # codes that way: the same words, addressed the way
                # _cms_diff coded them
                view = np.moveaxis(arr, 2, 0) if planes_first else arr
                for d, w0, block in entry.get(f"{key}_tiles", ()):
                    d, w0 = int(d), int(w0)
                    view[:, d, w0:w0 + block.shape[-1]] = block
                for d, cols, vals in entry.get(f"{key}_sparse", ()):
                    view[:, int(d), np.asarray(cols, np.int64)] = vals
                planes[key] = arr
            elif key in spec_keys:
                # unshipped + undiffed but diffable for this kind:
                # carried forward BY REFERENCE (states are immutable)
                planes[key] = None if pf is None else pf.get(key)
            else:
                # a plane this kind never carries (or a kind change):
                # never inherit another layout's words
                planes[key] = None
        families[name] = {
            "kind": entry["kind"], "window_start": entry["window_start"],
            "depth": int(entry["depth"]),
            "key_lanes": int(entry["key_lanes"]),
            "value_cols": list(entry["value_cols"]),
            "rows": rows, "cms": planes["cms"], "regs": planes["regs"],
        }
    ranges = {}
    for table, spec in delta["ranges"].items():
        pslots = dict((int(s), rows)
                      for s, rows in prev["ranges"].get(table, []))
        chunks = {int(s): rows for s, rows in spec["chunks"].items()}
        out = []
        for slot in spec["slots"]:
            slot = int(slot)
            rows = chunks.get(slot, pslots.get(slot))
            if rows is None:
                raise DeltaError(
                    f"delta names range slot {table}:{slot} it neither "
                    "ships nor the base holds")
            out.append([slot, rows])
        ranges[table] = out
    return {
        "version": int(delta["to"]), "created": float(delta["created"]),
        "watermark": float(delta["watermark"]),
        "flows_seen": delta["flows_seen"], "source": delta["source"],
        "families": families, "ranges": ranges,
        "audit": delta["audit"] if "audit" in delta else prev["audit"],
    }


# ---- frames ----------------------------------------------------------------


def _frame(tree: dict) -> bytes:
    body = codec.encode(tree)
    return MAGIC + _HEAD.pack(len(body), zlib.crc32(body)) + body


def encode_full(state: dict) -> bytes:
    return _frame({"t": "full", "to": int(state["version"]),
                   "state": state})


def encode_delta(prev: dict, cur: dict) -> bytes:
    return _frame({"t": "delta", **diff_states(prev, cur)})


def encode_none(version: int) -> bytes:
    """The "you are current" frame: a poll answer, so the subscriber
    can tell an idle upstream from a dead one."""
    return _frame({"t": "none", "to": int(version)})


def decode_frames(data: bytes) -> Iterator[dict]:
    """Yield every frame tree in ``data``. Raises :class:`DeltaError`
    on a bad magic, torn header or body, or CRC mismatch: subscription
    transports deliver whole responses, so any damage means resync, not
    salvage."""
    off = 0
    while off < len(data):
        if data[off:off + len(MAGIC)] != MAGIC:
            raise DeltaError("bad frame magic")
        off += len(MAGIC)
        head = data[off:off + _HEAD.size]
        if len(head) < _HEAD.size:
            raise DeltaError("torn frame header")
        body_len, crc = _HEAD.unpack(head)
        off += _HEAD.size
        body = data[off:off + body_len]
        if len(body) < body_len:
            raise DeltaError("torn frame body")
        if zlib.crc32(body) != crc:
            raise DeltaError("frame CRC mismatch")
        off += body_len
        yield codec.decode(body)
