"""The port's native host code (C++ through ctypes): the frame decoder
and the hash-group kernel.

Counterpart of flow_pipeline_tpu/native/__init__.py's ``decode_stream``,
``flow_count_frames`` and ``hash_group``: ``flowdecode.cc`` beside this
file decodes a length-prefixed FlowMessage stream straight into the
columns of a FlowBatch, and hash-groups key lanes for the host-grouped
pipeline (ops/hostgroup.py). It is built with g++ at first use
(``library()``), never at import, into

    build/torch_native/libflowdecode-<key>.so   (beside the package)

``<key>`` hashes the source, the flags and the compiler's path, so a
change to any of them builds a new library. The build writes a temporary
file and publishes it with ``os.replace``, so processes building at once
(pytest-xdist workers) never load half a file. A failed build raises
with the compiler's output; nothing falls back to the pure-Python codec
(``schema/wire.py``) or to numpy grouping, which stay as the plain
versions the tests hold this library against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "flowdecode.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
LIB_STEM = "libflowdecode"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-pthread", "-shared")

_lock = threading.Lock()
_lib = None


def _cxx() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found on PATH; the native frame decoder "
                           "cannot be built on this machine")
    return found


def build_key(cxx: str, source: Path = SOURCE,
              flags: tuple[str, ...] = CXX_FLAGS) -> str:
    """Hash of what the library is built from: the source, the flags and
    the compiler's path."""
    h = hashlib.sha256(source.read_bytes() + b"\0")
    h.update("\0".join(flags).encode() + b"\0" + cxx.encode())
    return h.hexdigest()[:20]


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile flowdecode.cc into the library its build key names in
    ``build_dir``, unless that library exists already. Returns its path."""
    cxx = _cxx()
    lib = Path(build_dir) / f"{LIB_STEM}-{build_key(cxx)}.so"
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".{lib.name}.", dir=lib.parent)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", tmp],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed building {SOURCE.name}\n"
                               + proc.stdout)
        os.replace(tmp, lib)  # atomic: a reader never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def load(path: Path) -> ctypes.CDLL:
    """Load a built library and declare its C signatures."""
    lib = ctypes.CDLL(str(path))
    lib.fpt_count_frames.argtypes = [ctypes.c_char_p, ctypes.c_longlong]
    lib.fpt_count_frames.restype = ctypes.c_longlong
    lib.fpt_decode_stream.argtypes = [ctypes.c_char_p, ctypes.c_longlong,
                                      ctypes.POINTER(ctypes.c_void_p),
                                      ctypes.c_longlong]
    lib.fpt_decode_stream.restype = ctypes.c_longlong
    group_args = [ctypes.c_void_p,  # [n, w] uint32 lanes
                  ctypes.c_longlong, ctypes.c_longlong,
                  ctypes.c_void_p,  # [n] int32 perm out
                  ctypes.c_void_p,  # [n] int32 starts out
                  ctypes.POINTER(ctypes.c_int32)]  # collided out
    lib.fpt_hash_group.argtypes = group_args
    lib.fpt_hash_group.restype = ctypes.c_longlong
    lib.fpt_hash_group_mt.argtypes = [*group_args, ctypes.c_int]
    lib.fpt_hash_group_mt.restype = ctypes.c_longlong
    return lib


def library() -> ctypes.CDLL:
    """The loaded decoder library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(build())
        return _lib


def available() -> bool:
    """Whether the decoder can serve on this machine: True once the
    library loads (building it if needed), False when there is no g++.
    A compile that fails raises."""
    try:
        library()
    except RuntimeError as e:
        if "g++ not found" in str(e):
            return False
        raise
    return True


def count_frames(data: bytes) -> int:
    """Frames in a length-prefixed stream; raises ValueError on a
    truncated or malformed length prefix."""
    n = library().fpt_count_frames(data, len(data))
    if n < 0:
        raise ValueError(f"truncated frame at byte {-n - 1}")
    return int(n)


def decode_stream(data: bytes):
    """Decode length-prefixed FlowMessage frames into a FlowBatch, columns
    in schema/batch.py order (COLUMNS, then ADDR_COLUMNS). Raises
    ValueError on a malformed or truncated frame, as the pure-Python
    codec does."""
    from ..schema.batch import ADDR_COLUMNS, COLUMNS, FlowBatch

    data = bytes(data)
    lib = library()
    cap = count_frames(data)
    batch = FlowBatch.empty(cap)
    names = [*COLUMNS, *ADDR_COLUMNS]
    ptrs = (ctypes.c_void_p * len(names))()
    for i, name in enumerate(names):
        arr = batch.columns[name]
        if not arr.flags["C_CONTIGUOUS"]:
            raise ValueError(f"column {name} is not contiguous")
        ptrs[i] = arr.ctypes.data
    n = lib.fpt_decode_stream(data, len(data), ptrs, cap)
    if n < 0:
        raise ValueError(f"malformed frame {-n - 1}")
    return batch if n == cap else batch.slice(0, int(n))


def hash_group(lanes: np.ndarray, threads: int = 1):
    """Hash-group [N, W] uint32 key lanes in one C pass: the 64-bit hash
    of ops/hostgroup.py hash_u64, a stable sort by it and a verify of
    every row against its group's first row. Returns (perm [N] int32,
    starts [G] int32, collided bool), the numpy path's contract and
    group order. ``threads`` > 1 runs the partitioned kernel, whose output
    is the same at any thread count."""
    lib = library()
    lanes = np.ascontiguousarray(lanes, dtype=np.uint32)
    n, w = lanes.shape
    perm = np.empty(n, np.int32)
    starts = np.empty(max(n, 1), np.int32)
    collided = ctypes.c_int32(0)
    args = (lanes.ctypes.data_as(ctypes.c_void_p), n, w,
            perm.ctypes.data_as(ctypes.c_void_p),
            starts.ctypes.data_as(ctypes.c_void_p), ctypes.byref(collided))
    if threads > 1:
        g = lib.fpt_hash_group_mt(*args, int(threads))
    else:
        g = lib.fpt_hash_group(*args)
    if g < 0:
        raise ValueError(f"hash_group: {n} rows exceed int32 indexing")
    return perm, starts[:g], bool(collided.value)
