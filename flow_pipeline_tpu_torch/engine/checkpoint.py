"""Open-window state snapshot and restore.

Counterpart of flow_pipeline_tpu/engine/checkpoint.py, with the same
on-disk format, so a checkpoint either package writes loads in the other.
A checkpoint is a directory with:

- ``arrays.npz``: every array leaf (numpy, compressed);
- ``meta.json``: the tree layout, with consumer offsets, window dicts and
  scalars inline.

Writes follow the durable-publish protocol of ``utils/fsutil``: each
payload is written, fsynced and renamed inside a staging directory, the
staging directory is renamed over the target, and the containing
directory is fsynced, so a crash at any point leaves the complete old
checkpoint (possibly under ``.old``) or the complete new one.
``utils/crashsim.py`` checks every crash point of a save. Only numpy and
json are used, no pickle.

Array leaves must be host numpy arrays in the reference's dtypes: the
worker converts its tensors with ``interop.checkpoint_arrays`` before a
save (a tensor on the card would not be written as one).
"""

from __future__ import annotations

import io
import json
import os
import shutil
import tempfile
from typing import Any

import numpy as np

from ..utils import fsutil


def _encode(obj: Any, arrays: dict[str, np.ndarray], path: str) -> Any:
    """Recursively split a state object into JSON-able structure + arrays."""
    if isinstance(obj, dict):
        return {
            "__kind__": "dict",
            "items": [
                [_encode(k, arrays, f"{path}.k{i}"),
                 _encode(v, arrays, f"{path}.v{i}")]
                for i, (k, v) in enumerate(obj.items())
            ],
        }
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):  # NamedTuple
        return {
            "__kind__": "namedtuple",
            "name": type(obj).__name__,
            "fields": {
                f: _encode(getattr(obj, f), arrays, f"{path}.{f}")
                for f in obj._fields
            },
        }
    if isinstance(obj, (list, tuple)):
        return {
            "__kind__": "list" if isinstance(obj, list) else "tuple",
            "items": [_encode(v, arrays, f"{path}.{i}")
                      for i, v in enumerate(obj)],
        }
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    if not isinstance(obj, (np.ndarray, np.generic)):
        raise TypeError(f"checkpoint leaf {path} is a {type(obj).__name__}, "
                        "not a numpy array (convert tensors first)")
    arrays[path] = np.asarray(obj)
    return {"__kind__": "array", "ref": path}


def _decode(spec: Any, arrays) -> Any:
    if isinstance(spec, dict) and "__kind__" in spec:
        kind = spec["__kind__"]
        if kind == "dict":
            return {
                _freeze(_decode(k, arrays)): _decode(v, arrays)
                for k, v in spec["items"]
            }
        if kind == "namedtuple":
            return {f: _decode(v, arrays) for f, v in spec["fields"].items()}
        if kind in ("list", "tuple"):
            items = [_decode(v, arrays) for v in spec["items"]]
            return items if kind == "list" else tuple(items)
        if kind == "array":
            return arrays[spec["ref"]]
        raise ValueError(f"unknown kind {kind}")
    return spec


def _freeze(key):
    return tuple(key) if isinstance(key, list) else key


def save_checkpoint(path: str, state: Any) -> None:
    """Atomically and durably write ``state`` (nested dicts, lists,
    NamedTuples and numpy arrays). The payloads are staged and fsynced in
    a sibling temporary directory, the directory is renamed over the
    target and the parent directory entry is fsynced; only then is the
    superseded ``.old`` tree deleted."""
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    arrays: dict[str, np.ndarray] = {}
    meta = _encode(state, arrays, "r")
    tmp = tempfile.mkdtemp(prefix=".ckpt-", dir=parent)
    try:
        # serialize in memory, publish through the durable-write idiom:
        # numpy's own savez path never fsyncs
        buf = io.BytesIO()
        np.savez_compressed(buf, **arrays)
        fsutil.write_bytes_durable(os.path.join(tmp, "arrays.npz"),
                                   buf.getvalue())
        fsutil.write_bytes_durable(os.path.join(tmp, "meta.json"),
                                   json.dumps(meta).encode("utf-8"))
        if os.path.isdir(path):
            old = path + ".old"
            # a crash between the renames below can leave a stale .old;
            # clear it or every later snapshot fails with ENOTEMPTY
            if os.path.isdir(old):
                fsutil.rmtree(old)
            fsutil.rename(path, old)
            fsutil.rename(tmp, path)
            fsutil.rmtree(old)
        else:
            fsutil.rename(tmp, path)
            # a crash between the two renames of an earlier save leaves
            # the predecessor under .old with no primary; clear it only
            # after the new checkpoint is published
            if os.path.isdir(path + ".old"):
                fsutil.rmtree(path + ".old")
        # the renames are durable only once the parent directory is
        fsutil.fsync_dir(parent)
    except BaseException:
        # best-effort cleanup of the unpublished staging directory
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def checkpoint_exists(path: str) -> bool:
    return os.path.isdir(path) or os.path.isdir(path + ".old")


def checkpoint_bytes(path: str) -> int:
    """Bytes on disk of a published checkpoint's payload files."""
    return sum(os.path.getsize(os.path.join(path, f))
               for f in ("arrays.npz", "meta.json"))


def load_checkpoint(path: str) -> Any:
    """Load a checkpoint. NamedTuples come back as field dicts; callers
    rebuild their state types (StreamWorker.restore).

    Falls back to ``<path>.old`` when the primary is missing: a crash
    between save_checkpoint's two renames leaves only the previous
    checkpoint under .old, which is still a consistent snapshot."""
    if not os.path.isdir(path) and os.path.isdir(path + ".old"):
        path = path + ".old"
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    arrays = np.load(os.path.join(path, "arrays.npz"))
    return _decode(meta, arrays)
