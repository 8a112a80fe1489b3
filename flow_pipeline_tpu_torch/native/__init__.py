"""The port's native host code (C++ through ctypes): the frame decoder,
the hash-group kernel, the host sketch engine and the fused native pass.

Counterpart of flow_pipeline_tpu/native/__init__.py. Three sources beside
this file build into ONE library, as the reference's native/Makefile
builds its three:

- ``flowdecode.cc`` decodes a length-prefixed FlowMessage stream straight
  into the columns of a FlowBatch, encodes a FlowBatch back into one
  (``encode_stream``), and hash-groups key lanes for the host-grouped
  pipeline (ops/hostgroup.py);
- ``hostsketch.cc`` is the host sketch engine of ``-sketch.backend host``
  (uint64 count-min update and query, table prefilter, top-K merge, the
  invertible family's update and decode, the spread register fold);
- ``flowfused.cc`` is the fused pass of ``-ingest.fused`` (group, cascade
  and sketch update in one call) and the lane builders.

Every C export carries the ``fpt_`` prefix, so the reference's library
and this one load into one process without sharing a symbol. The library
is built with g++ at first use (``library()``), never at import, into

    build/torch_native/libflowdecode-<key>.so   (beside the package)

``<key>`` hashes the sources and headers, the flags and the compiler's
path, so a change to any of them builds a new library. The build writes a
temporary file and publishes it with ``os.replace``, so processes
building at once (pytest-xdist workers) never load half a file. A failed
build raises with the compiler's output; nothing falls back to the
pure-Python codec (``schema/wire.py``) or to the numpy twins
(ops/hostgroup.py, hostsketch/engine.py), which stay as the plain
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
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

_HERE = Path(__file__).resolve().parent
SOURCES = tuple(_HERE / name for name in ("flowdecode.cc", "hostsketch.cc",
                                          "flowfused.cc"))
HEADERS = tuple(_HERE / name for name in ("ffpar.h", "ffstat.h"))
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
LIB_STEM = "libflowdecode"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-pthread", "-shared")
# linker version script: only the fpt_ C exports leave the library (the
# C++ template instantiations stay local, so no symbol is shared with the
# reference's library loaded into the same process)
EXPORTS = "{ global: fpt_*; local: *; };\n"

_lock = threading.Lock()
_lib = None


def _cxx() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found on PATH; the native frame decoder "
                           "cannot be built on this machine")
    return found


def build_key(cxx: str, flags: tuple[str, ...] = CXX_FLAGS) -> str:
    """Hash of what the library is built from: the sources and headers,
    the flags and the compiler's path."""
    h = hashlib.sha256()
    for path in (*SOURCES, *HEADERS):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update("\0".join(flags).encode() + b"\0" + EXPORTS.encode() + b"\0"
             + cxx.encode())
    return h.hexdigest()[:20]


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile the sources into the library its build key names in
    ``build_dir``, unless that library exists already. Returns its path."""
    cxx = _cxx()
    lib = Path(build_dir) / f"{LIB_STEM}-{build_key(cxx)}.so"
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".{lib.name}.", dir=lib.parent)
    os.close(fd)
    fd, vmap = tempfile.mkstemp(prefix=f".{lib.name}.", suffix=".map",
                                dir=lib.parent)
    with os.fdopen(fd, "w") as f:
        f.write(EXPORTS)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, f"-Wl,--version-script={vmap}",
                               *map(str, SOURCES), "-o", tmp],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed building {LIB_STEM}\n"
                               + proc.stdout)
        os.replace(tmp, lib)  # atomic: a reader never sees half a file
    finally:
        for path in (tmp, vmap):
            if os.path.exists(path):
                os.unlink(path)
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
    lib.fpt_encode_stream.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                      ctypes.c_longlong, ctypes.c_char_p,
                                      ctypes.c_longlong]
    lib.fpt_encode_stream.restype = ctypes.c_longlong
    group_args = [ctypes.c_void_p,  # [n, w] uint32 lanes
                  ctypes.c_longlong, ctypes.c_longlong,
                  ctypes.c_void_p,  # [n] int32 perm out
                  ctypes.c_void_p,  # [n] int32 starts out
                  ctypes.POINTER(ctypes.c_int32)]  # collided out
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    signatures = {
        # name: argtypes (every kernel returns long long; vp NULL stats
        # disables the phase counters)
        "fpt_hash_group": [*group_args, vp],
        "fpt_hash_group_mt": [*group_args, ci, vp],
        # cms [P, D, W] u64, (P, D, W), keys [n, kw] u32, (n, kw), vals
        # [n, P] f32, valid [n] u8 | NULL, conservative, threads, stats
        "fpt_hs_cms_update": [vp, ll, ll, ll, vp, ll, ll, vp, vp, ci, ci,
                              vp],
        # cms, (P, D, W), keys, (n, kw), out [n, P] f32, threads, stats
        "fpt_hs_cms_query": [vp, ll, ll, ll, vp, ll, ll, vp, ci, vp],
        # table keys [cap, kw], (cap, kw), cand keys [n, kw], sums [n, P],
        # (n, P), selection out [2 cap] i32, threads, stats
        "fpt_hs_hh_prefilter": [vp, ll, ll, vp, vp, ll, ll, vp, ci, vp],
        # table keys, table vals [cap, P] f32 (in place), (cap, kw, P),
        # cand keys, sums, est, valid | NULL, n, stats
        "fpt_hs_topk_merge": [vp, vp, ll, ll, ll, vp, vp, vp, vp, ll, vp],
        # cms, (P, D, W), keysum [D, W, kw], keycheck [D, W], keys, (n,
        # kw), vals (count plane last), valid | NULL, threads, stats
        "fpt_hs_inv_update": [vp, ll, ll, ll, vp, vp, vp, ll, ll, vp, vp,
                              ci, vp],
        # cms, (P, D, W), keysum, keycheck, kw, keys out [D*W, kw] u32,
        # vals out [D*W, P] u64, stats
        "fpt_hs_inv_decode": [vp, ll, ll, ll, vp, vp, ll, vp, vp, vp],
        # regs [D, W, m] u8, (D, W, m), keys, (n, kw), elems [n, ew], ew,
        # valid | NULL, threads, stats
        "fpt_hs_spread_update": [vp, ll, ll, ll, vp, ll, ll, vp, ll, vp,
                                 ci, vp],
        # lanes [n, w], (n, w), vals [n, p] u64, p, uniq out, sums out,
        # counts out [n] i64, (threads,) stats
        "fpt_ff_group_sum": [vp, ll, ll, vp, ll, vp, vp, vp, vp],
        "fpt_ff_group_sum_mt": [vp, ll, ll, vp, ll, vp, vp, vp, ci, vp],
        # cols [ncols], is64 [ncols] u8, widths [ncols] i64, mods [ncols]
        # u32 | NULL, (ncols, n, wtotal), out [n, wtotal] u32, threads,
        # stats
        "fpt_ff_build_lanes": [ctypes.POINTER(vp), vp, vp, vp, ll, ll, ll,
                               vp, ci, vp],
        # cols [p], is64 [p], (p, n), scale | NULL, scale_is64, out f32 |
        # NULL, out u64 | NULL, threads, stats
        "fpt_ff_build_planes": [ctypes.POINTER(vp), vp, ll, ll, vp, ci, vp,
                                vp, ci, vp],
        # root lanes [n, w], (n, w), vals [n, p] f32, (p, nf), parent,
        # sel, sel_off, depth, width, cap (i64 [nf]), conservative,
        # prefilter, plain (u8 [nf]), cms / table key / table val buffers
        # [nf], do_sketch, ddos parent, ddos sel, (ddos sel width, ddos
        # plane), ddos keys out, ddos sums out, threads, stats,
        # invertible flags [nf] u8 | NULL, keysum / keycheck buffers [nf]
        "fpt_ff_fused_update": [vp, ll, ll, vp, ll, ll, vp, vp, vp, vp, vp,
                                vp, vp, vp, vp, ctypes.POINTER(vp),
                                ctypes.POINTER(vp), ctypes.POINTER(vp), ci,
                                ll, vp, ll, ll, vp, vp, ci, vp, vp,
                                ctypes.POINTER(vp), ctypes.POINTER(vp)],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ll
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


def encode_stream(batch, out_capacity: int = 0) -> bytes:
    """Encode a FlowBatch as length-prefixed FlowMessage frames. The same
    bytes as the pure-Python encoder (schema/wire.py) except for all-zero
    addresses: the columns cannot tell an absent address from ``::``, and
    this encoder omits such fields, as the reference's native encoder
    does (decoders read both as the same row). Raises ValueError when
    ``out_capacity`` is too small."""
    from ..schema.batch import ADDR_COLUMNS, COLUMNS

    lib = library()
    n = len(batch)
    # worst case ~ 27 fields * (2 tag + 5 varint) + addresses + prefix
    cap = out_capacity or (n * 256 + 16)
    out = ctypes.create_string_buffer(cap)
    names = [*COLUMNS, *ADDR_COLUMNS]
    ptrs = (ctypes.c_void_p * len(names))()
    keepalive = []  # contiguous copies held for the duration of the call
    for i, name in enumerate(names):
        arr = np.ascontiguousarray(batch.columns[name])
        keepalive.append(arr)
        ptrs[i] = arr.ctypes.data
    written = lib.fpt_encode_stream(ptrs, n, out, cap)
    del keepalive
    if written < 0:
        raise ValueError("native encode: output buffer too small")
    return out.raw[:int(written)]


def hash_group(lanes: np.ndarray, threads: int = 1,
               stats: Optional[np.ndarray] = None):
    """Hash-group [N, W] uint32 key lanes in one C pass: the 64-bit hash
    of ops/hostgroup.py hash_u64, a stable sort by it and a verify of
    every row against its group's first row. Returns (perm [N] int32,
    starts [G] int32, collided bool), the numpy path's contract and
    group order. ``threads`` > 1 runs the partitioned kernel, whose output
    is the same at any thread count. ``stats`` (new_stats()) accumulates
    the radix and refine phase counters."""
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
        g = lib.fpt_hash_group_mt(*args, int(threads), _stats_ptr(stats))
    else:
        g = lib.fpt_hash_group(*args, _stats_ptr(stats))
    if g < 0:
        raise ValueError(f"hash_group: {n} rows exceed int32 indexing")
    return perm, starts[:g], bool(collided.value)


# ---- phase counters (ffstat.h) ---------------------------------------------
#
# Every grouping and sketch kernel takes an optional int64[FF_STATS_LEN]
# buffer that it ACCUMULATES per-phase wall nanoseconds and row/group
# counts into. The slots mirror the FF_STAT_* enum of ffstat.h (the
# reference's FF_STAT_SLOTS, the same layout).

FF_STATS_LEN = 16
FF_STAT_SLOTS = {
    "radix": 0,      # LSD radix passes incl. the row-hash pass (ns)
    "refine": 1,     # run refinement + group boundary scan (ns)
    "regroup": 2,    # cascade regroup: gather + group + fold (ns)
    "cms": 3,        # fpt_hs_cms_update (ns)
    "prefilter": 4,  # fpt_hs_hh_prefilter (ns)
    "topk": 5,       # fpt_hs_cms_query (admission) + fpt_hs_topk_merge
    "fold": 6,       # root group-table accumulation (ns)
    "inv": 10,       # fpt_hs_inv_update / fpt_hs_inv_decode (ns)
    "lanes": 11,     # fpt_ff_build_lanes / fpt_ff_build_planes (ns)
    "spread": 12,    # fpt_hs_spread_update (ns)
}
FF_STAT_ROWS = 7
FF_STAT_GROUPS = 8
FF_STAT_RADIX_PASSES = 9

# feature -> the export that serves it (the flow_build_info ``native``
# label and the native_path_degraded gauge's feature names)
FEATURE_SYMBOLS = {
    "decode": "fpt_decode_stream",
    "group": "fpt_hash_group",
    "sketch": "fpt_hs_cms_update",
    "fused": "fpt_ff_fused_update",
    "invsketch": "fpt_hs_inv_update",
    "lanes": "fpt_ff_build_lanes",
    "spread": "fpt_hs_spread_update",
}


def new_stats() -> np.ndarray:
    """A zeroed phase-counter buffer the kernels accumulate into."""
    return np.zeros(FF_STATS_LEN, np.int64)


def _stats_ptr(stats):
    if stats is None:
        return None
    if stats.dtype != np.int64 or not stats.flags["C_CONTIGUOUS"] or \
            stats.shape != (FF_STATS_LEN,):
        raise ValueError(f"stats must be a C-contiguous int64 "
                         f"[{FF_STATS_LEN}] buffer (new_stats())")
    return _c_arr(stats)


def _c_arr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_void_p)


def _has(symbol: str) -> bool:
    return available() and hasattr(library(), symbol)


def capabilities() -> dict:
    """{feature: whether the library serves it} (all False without g++)."""
    return {feat: _has(sym) for feat, sym in FEATURE_SYMBOLS.items()}


def sketch_available() -> bool:
    """Whether the host sketch engine (fpt_hs_*) can serve: the library
    loads (building it first if needed)."""
    return _has(FEATURE_SYMBOLS["sketch"])


def inv_available() -> bool:
    """Whether the invertible family's kernels can serve."""
    return _has(FEATURE_SYMBOLS["invsketch"])


def spread_available() -> bool:
    """Whether the spread register fold can serve."""
    return _has(FEATURE_SYMBOLS["spread"])


def fused_available() -> bool:
    """Whether the fused pass (fpt_ff_fused_update) can serve."""
    return _has(FEATURE_SYMBOLS["fused"])


def lanes_available() -> bool:
    """Whether the lane builders (fpt_ff_build_*) can serve."""
    return _has(FEATURE_SYMBOLS["lanes"])


def _u64_buffer(a: np.ndarray, name: str) -> None:
    if a.dtype != np.uint64 or not a.flags["C_CONTIGUOUS"]:
        raise ValueError(f"{name} must be a C-contiguous uint64 array "
                         "(the kernel writes it in place)")


def _valid_ptr(valid):
    """(ctypes pointer or None, keepalive) for an optional [n] mask."""
    if valid is None:
        return None, None
    valid = np.ascontiguousarray(valid, dtype=np.uint8)
    return _c_arr(valid), valid


# ---- the host sketch engine (hostsketch.cc) --------------------------------


def hs_cms_update(cms: np.ndarray, keys: np.ndarray, vals: np.ndarray,
                  valid, conservative: bool, threads: int = 1,
                  stats: Optional[np.ndarray] = None) -> None:
    """uint64 CMS update (plain or conservative) in place: cms [P, D, W]
    uint64 C-contiguous; keys [n, kw] uint32; vals [n, P] float32; valid
    [n] bool or None. The same result at any thread count."""
    lib = library()
    _u64_buffer(cms, "cms")
    p, d, w = cms.shape
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    vals = np.ascontiguousarray(vals, dtype=np.float32)
    n, kw = keys.shape
    if vals.shape != (n, p):
        raise ValueError(f"vals {vals.shape} != ({n}, {p})")
    vptr, _keep = _valid_ptr(valid)
    rc = lib.fpt_hs_cms_update(_c_arr(cms), p, d, w, _c_arr(keys), n, kw,
                               _c_arr(vals), vptr, int(bool(conservative)),
                               int(threads), _stats_ptr(stats))
    if rc != 0:
        raise ValueError(f"fpt_hs_cms_update failed (rc={rc}): degenerate "
                         f"shape planes={p} depth={d} width={w}")


def hs_cms_query(cms: np.ndarray, keys: np.ndarray, threads: int = 1,
                 stats: Optional[np.ndarray] = None) -> np.ndarray:
    """CMS point query: [n, P] float32 min-over-depth estimates."""
    lib = library()
    _u64_buffer(cms, "cms")
    p, d, w = cms.shape
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    n, kw = keys.shape
    out = np.empty((n, p), np.float32)
    rc = lib.fpt_hs_cms_query(_c_arr(cms), p, d, w, _c_arr(keys), n, kw,
                              _c_arr(out), int(threads), _stats_ptr(stats))
    if rc != 0:
        raise ValueError(f"fpt_hs_cms_query failed (rc={rc})")
    return out


def hs_hh_prefilter(table_keys: np.ndarray, cand_keys: np.ndarray,
                    cand_sums: np.ndarray, threads: int = 1,
                    stats: Optional[np.ndarray] = None) -> np.ndarray:
    """Table-aware candidate prefilter: the selected row indices in
    (metric desc, index asc) order, [min(n, 2 * cap)] int32."""
    lib = library()
    table_keys = np.ascontiguousarray(table_keys, dtype=np.uint32)
    cand_keys = np.ascontiguousarray(cand_keys, dtype=np.uint32)
    cand_sums = np.ascontiguousarray(cand_sums, dtype=np.float32)
    cap, kw = table_keys.shape
    n, planes = cand_sums.shape
    if cand_keys.shape != (n, kw):
        raise ValueError(f"cand_keys {cand_keys.shape} != ({n}, {kw})")
    sel = np.empty(2 * cap, np.int32)
    m = lib.fpt_hs_hh_prefilter(_c_arr(table_keys), cap, kw,
                                _c_arr(cand_keys), _c_arr(cand_sums), n,
                                planes, _c_arr(sel), int(threads),
                                _stats_ptr(stats))
    if m < 0:
        raise ValueError(f"fpt_hs_hh_prefilter failed (rc={m})")
    return sel[:m]


def hs_topk_merge(table_keys: np.ndarray, table_vals: np.ndarray,
                  cand_keys: np.ndarray, cand_sums: np.ndarray,
                  cand_est: np.ndarray, valid,
                  stats: Optional[np.ndarray] = None) -> int:
    """Space-saving admission merge in place on the table buffers
    (topk_merge_est; pass cand_est=cand_sums for the plain merge).
    Returns the number of real rows."""
    lib = library()
    if table_keys.dtype != np.uint32 or table_vals.dtype != np.float32 \
            or not (table_keys.flags["C_CONTIGUOUS"]
                    and table_vals.flags["C_CONTIGUOUS"]):
        raise ValueError("the table must be C-contiguous uint32 keys and "
                         "float32 values (merged in place)")
    cap, kw = table_keys.shape
    planes = table_vals.shape[1]
    cand_keys = np.ascontiguousarray(cand_keys, dtype=np.uint32)
    cand_sums = np.ascontiguousarray(cand_sums, dtype=np.float32)
    cand_est = np.ascontiguousarray(cand_est, dtype=np.float32)
    n = cand_keys.shape[0]
    if cand_keys.shape != (n, kw) or cand_sums.shape != (n, planes) or \
            cand_est.shape != (n, planes):
        raise ValueError("candidate shapes do not match the table")
    vptr, _keep = _valid_ptr(valid)
    rc = lib.fpt_hs_topk_merge(_c_arr(table_keys), _c_arr(table_vals), cap,
                               kw, planes, _c_arr(cand_keys),
                               _c_arr(cand_sums), _c_arr(cand_est), vptr, n,
                               _stats_ptr(stats))
    if rc < 0:
        raise ValueError(f"fpt_hs_topk_merge failed (rc={rc}): degenerate "
                         f"shape cap={cap} kw={kw} planes={planes}")
    return int(rc)


def hs_inv_update(cms: np.ndarray, keysum: np.ndarray,
                  keycheck: np.ndarray, keys: np.ndarray,
                  vals: np.ndarray, valid, threads: int = 1,
                  stats: Optional[np.ndarray] = None) -> None:
    """Invertible-sketch update in place: cms [P, D, W], keysum [D, W,
    kw], keycheck [D, W] (uint64 wrap sums); keys [n, kw] uint32; vals
    [n, P] float32 with the count plane LAST."""
    lib = library()
    for a, name in ((cms, "cms"), (keysum, "keysum"),
                    (keycheck, "keycheck")):
        _u64_buffer(a, name)
    p, d, w = cms.shape
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    vals = np.ascontiguousarray(vals, dtype=np.float32)
    n, kw = keys.shape
    if keysum.shape != (d, w, kw) or keycheck.shape != (d, w) or \
            vals.shape != (n, p):
        raise ValueError("invertible state and input shapes disagree")
    vptr, _keep = _valid_ptr(valid)
    rc = lib.fpt_hs_inv_update(_c_arr(cms), p, d, w, _c_arr(keysum),
                               _c_arr(keycheck), _c_arr(keys), n, kw,
                               _c_arr(vals), vptr, int(threads),
                               _stats_ptr(stats))
    if rc != 0:
        raise ValueError(f"fpt_hs_inv_update failed (rc={rc}): degenerate "
                         f"shape planes={p} depth={d} width={w} kw={kw}")


def hs_inv_decode(cms: np.ndarray, keysum: np.ndarray,
                  keycheck: np.ndarray,
                  stats: Optional[np.ndarray] = None):
    """Heavy-key recovery by peeling pure buckets (inputs read-only).
    Returns (keys [K, kw] uint32, vals [K, P] uint64) in the kernel's
    peel order; callers sort (hostsketch/engine.py inv_decode_state)."""
    lib = library()
    cms = np.ascontiguousarray(cms, dtype=np.uint64)
    keysum = np.ascontiguousarray(keysum, dtype=np.uint64)
    keycheck = np.ascontiguousarray(keycheck, dtype=np.uint64)
    p, d, w = cms.shape
    kw = keysum.shape[2]
    if keysum.shape != (d, w, kw) or keycheck.shape != (d, w):
        raise ValueError("invertible state shapes disagree")
    keys_out = np.empty((d * w, kw), np.uint32)
    vals_out = np.empty((d * w, p), np.uint64)
    n = lib.fpt_hs_inv_decode(_c_arr(cms), p, d, w, _c_arr(keysum),
                              _c_arr(keycheck), kw, _c_arr(keys_out),
                              _c_arr(vals_out), _stats_ptr(stats))
    if n < 0:
        raise ValueError(f"fpt_hs_inv_decode failed (rc={n})")
    return keys_out[:n], vals_out[:n]


def hs_spread_update(regs: np.ndarray, keys: np.ndarray,
                     elems: np.ndarray, threads: int = 1,
                     stats: Optional[np.ndarray] = None,
                     valid=None) -> None:
    """Distinct-count register update in place (u8 scatter-max): regs
    [D, W, m] uint8 C-contiguous; keys [n, kw] and elems [n, ew]
    uint32."""
    lib = library()
    if regs.dtype != np.uint8 or not regs.flags["C_CONTIGUOUS"]:
        raise ValueError("regs must be C-contiguous uint8 (in place)")
    d, w, m = regs.shape
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    elems = np.ascontiguousarray(elems, dtype=np.uint32)
    n, kw = keys.shape
    ew = elems.shape[1]
    if elems.shape[0] != n:
        raise ValueError(f"elems rows ({elems.shape[0]}) != keys rows "
                         f"({n})")
    vptr, _keep = _valid_ptr(valid)
    rc = lib.fpt_hs_spread_update(_c_arr(regs), d, w, m, _c_arr(keys), n,
                                  kw, _c_arr(elems), ew, vptr, int(threads),
                                  _stats_ptr(stats))
    if rc != 0:
        raise ValueError(f"fpt_hs_spread_update failed (rc={rc}): "
                         f"degenerate shape depth={d} width={w} m={m} "
                         f"kw={kw} ew={ew}")


# ---- the fused pass and the lane builders (flowfused.cc) -------------------


def group_sum(lanes: np.ndarray, vals: np.ndarray,
              stats: Optional[np.ndarray] = None, threads: int = 1):
    """Exact groupby-sum in one pass: lanes [n, w] uint32, vals [n, p]
    uint64. Returns (uniq [G, w] uint32, sums [G, p] uint64, counts [G]
    int64) in hash order, or None when two distinct key rows share a
    64-bit hash (the caller regroups lexicographically). The same result
    at any thread count."""
    lib = library()
    lanes = np.ascontiguousarray(lanes, dtype=np.uint32)
    vals = np.ascontiguousarray(vals, dtype=np.uint64)
    n, w = lanes.shape
    p = vals.shape[1]
    if vals.shape[0] != n:
        raise ValueError(f"lanes rows ({n}) != vals rows ({vals.shape[0]})")
    uniq = np.empty((n, w), np.uint32)
    sums = np.empty((n, p), np.uint64)
    counts = np.empty(max(n, 1), np.int64)
    args = (_c_arr(lanes), n, w, _c_arr(vals), p, _c_arr(uniq),
            _c_arr(sums), _c_arr(counts))
    if threads > 1:
        g = lib.fpt_ff_group_sum_mt(*args, int(threads), _stats_ptr(stats))
    else:
        g = lib.fpt_ff_group_sum(*args, _stats_ptr(stats))
    if g == -2:
        return None
    if g < 0:
        raise ValueError(f"fpt_ff_group_sum failed (rc={g})")
    return uniq[:g], sums[:g], counts[:g]


def _lane_cols(columns):
    """(pointer array, is64, widths, contiguous keepalives) of decoded
    columns: [n] uint32 / [n] uint64 scalars or [n, 4] uint32 words."""
    keep = []
    ptrs = (ctypes.c_void_p * len(columns))()
    is64 = np.zeros(len(columns), np.uint8)
    widths = np.empty(len(columns), np.int64)
    for i, col in enumerate(columns):
        a = np.ascontiguousarray(col)
        if a.ndim == 2:
            if a.shape[1] != 4 or a.dtype != np.uint32:
                raise ValueError(f"column {i}: 2-D lanes must be [n, 4] "
                                 f"uint32, got {a.shape} {a.dtype}")
            widths[i] = 4
        elif a.dtype == np.uint64:
            is64[i] = 1
            widths[i] = 1
        else:
            a = np.ascontiguousarray(a, dtype=np.uint32)
            widths[i] = 1
        keep.append(a)
        ptrs[i] = a.ctypes.data_as(ctypes.c_void_p).value
    for i, a in enumerate(keep[1:], start=1):
        # the kernels read every column for the rows of column 0
        if a.shape[0] != keep[0].shape[0]:
            raise ValueError(f"column {i}: {a.shape[0]} rows, column 0 "
                             f"has {keep[0].shape[0]}")
    return ptrs, is64, widths, keep


def build_lanes(columns, mods=None, threads: int = 1,
                stats: Optional[np.ndarray] = None) -> np.ndarray:
    """[n, W] uint32 key lanes off decoded columns: u64 columns saturate
    at U32_MAX, [n, 4] address words copy through, and ``mods[i]`` (0
    none) applies the window-slot transform v - v % mods[i]. The C twin
    of engine/hostfused.py _key_lanes_into."""
    lib = library()
    ptrs, is64, widths, keep = _lane_cols(columns)
    n = keep[0].shape[0]
    wtotal = int(widths.sum())
    out = np.empty((n, wtotal), np.uint32)
    mods_arr = None
    if mods is not None:
        mods_arr = np.ascontiguousarray(mods, dtype=np.uint32)
        if mods_arr.shape != (len(columns),):
            raise ValueError(f"mods must have one entry per column "
                             f"({len(columns)}), got {mods_arr.shape}")
    rc = lib.fpt_ff_build_lanes(
        ptrs, _c_arr(is64), _c_arr(widths),
        _c_arr(mods_arr) if mods_arr is not None else None, len(keep), n,
        wtotal, _c_arr(out), int(threads), _stats_ptr(stats))
    if rc != 0:
        raise ValueError(f"fpt_ff_build_lanes failed (rc={rc})")
    return out


def build_planes_f32(columns, scale=None, threads: int = 1,
                     stats: Optional[np.ndarray] = None) -> np.ndarray:
    """[n, P] float32 value planes off scalar decoded columns (u32
    saturation, u32 -> f32, one f32 multiply by max(scale, 1) per cell):
    the C twin of engine/hostfused.py _value_planes_np."""
    lib = library()
    ptrs, is64, widths, keep = _lane_cols(columns)
    if (widths != 1).any():
        raise ValueError("value planes take scalar columns only")
    n = keep[0].shape[0]
    out = np.empty((n, len(keep)), np.float32)
    sptr, s64 = None, 0
    if scale is not None:
        s = np.ascontiguousarray(scale)
        if s.dtype == np.uint64:
            s64 = 1
        else:
            s = np.ascontiguousarray(s, dtype=np.uint32)
        if s.shape[0] != n:
            raise ValueError(f"scale has {s.shape[0]} rows, columns have "
                             f"{n}")
        keep.append(s)
        sptr = _c_arr(s)
    rc = lib.fpt_ff_build_planes(ptrs, _c_arr(is64), len(is64), n, sptr,
                                 s64, _c_arr(out), None, int(threads),
                                 _stats_ptr(stats))
    if rc != 0:
        raise ValueError(f"fpt_ff_build_planes failed (rc={rc})")
    return out


def build_planes_u64(columns, threads: int = 1,
                     stats: Optional[np.ndarray] = None) -> np.ndarray:
    """[n, P] uint64 value planes saturated at U32_MAX (the flows_5m
    layout of engine/hostfused.py _wagg_inputs_np)."""
    lib = library()
    ptrs, is64, widths, keep = _lane_cols(columns)
    if (widths != 1).any():
        raise ValueError("value planes take scalar columns only")
    n = keep[0].shape[0]
    out = np.empty((n, len(keep)), np.uint64)
    rc = lib.fpt_ff_build_planes(ptrs, _c_arr(is64), len(is64), n, None, 0,
                                 None, _c_arr(out), int(threads),
                                 _stats_ptr(stats))
    if rc != 0:
        raise ValueError(f"fpt_ff_build_planes failed (rc={rc})")
    return out


@dataclass(frozen=True)
class FusedPlan:
    """Static parameter block of one family tree for fused_update, built
    once per pipeline (hostsketch/pipeline.py). Family 0 is the tree's
    root ("own") family; parents precede children."""

    parent: np.ndarray            # [nf] int64; -1 = root
    sel: np.ndarray               # [sel_off[nf]] int64 child lane picks
    sel_off: np.ndarray           # [nf+1] int64
    depth: np.ndarray             # [nf] int64
    width: np.ndarray             # [nf] int64
    cap: np.ndarray               # [nf] int64
    conservative: np.ndarray      # [nf] uint8
    prefilter: np.ndarray         # [nf] uint8
    admission_plain: np.ndarray   # [nf] uint8
    ddos_parent: int = -1         # family index, -1 = no DDoS side table
    ddos_sel: Optional[np.ndarray] = None  # [ddos_sel_w] int64
    ddos_plane: int = -1
    invertible: Optional[np.ndarray] = None  # [nf] uint8; None = all table


def fused_update(lanes: np.ndarray, vals: np.ndarray, plan: FusedPlan,
                 states, do_sketch: bool, do_ddos: bool = True,
                 threads: int = 1,
                 stats: Optional[np.ndarray] = None):
    """One group -> cascade -> sketch pass over a chunk's root-family
    lanes [n, w] uint32 and value planes [n, p] float32 (the count plane
    is appended natively): every family state in ``states`` (plan order;
    HostHHState or HostInvState) is updated IN PLACE. ``do_sketch=False``
    groups only (a late part that still feeds DDoS; states may be None);
    ``do_ddos=False`` skips the DDoS side table. Returns (ddos_uniq [G,
    dw] uint32, ddos_sums [G] float32), or None without a side table."""
    lib = library()
    lanes = np.ascontiguousarray(lanes, dtype=np.uint32)
    vals = np.ascontiguousarray(vals, dtype=np.float32)
    n, w = lanes.shape
    p = vals.shape[1]
    if vals.shape[0] != n:
        raise ValueError(f"lanes rows ({n}) != vals rows ({vals.shape[0]})")
    i64 = [np.ascontiguousarray(a, dtype=np.int64) for a in (
        plan.parent, plan.sel, plan.sel_off, plan.depth, plan.width,
        plan.cap)]
    u8 = [np.ascontiguousarray(a, dtype=np.uint8) for a in (
        plan.conservative, plan.prefilter, plan.admission_plain)]
    nf = i64[0].shape[0]
    ptrs = [(ctypes.c_void_p * nf)() for _ in range(5)]
    cms_p, tkey_p, tval_p, ks_p, kc_p = ptrs
    inv = None
    if plan.invertible is not None:
        inv = np.ascontiguousarray(plan.invertible, dtype=np.uint8)
    if do_sketch:
        if len(states) != nf:
            raise ValueError(f"{len(states)} states for {nf} families")
        for i, st in enumerate(states):
            _u64_buffer(st.cms, "cms")
            cms_p[i] = st.cms.ctypes.data
            if inv is not None and inv[i]:
                _u64_buffer(st.keysum, "keysum")
                _u64_buffer(st.keycheck, "keycheck")
                ks_p[i] = st.keysum.ctypes.data
                kc_p[i] = st.keycheck.ctypes.data
                continue
            if st.table_keys.dtype != np.uint32 or \
                    st.table_vals.dtype != np.float32 or not (
                        st.table_keys.flags["C_CONTIGUOUS"]
                        and st.table_vals.flags["C_CONTIGUOUS"]):
                raise ValueError("table state must be C-contiguous uint32 "
                                 "keys and float32 values")
            tkey_p[i] = st.table_keys.ctypes.data
            tval_p[i] = st.table_vals.ctypes.data
    ddos_keys = ddos_sums = ddos_sel = None
    ddos_parent, ddos_sel_w = -1, 0
    if do_ddos and plan.ddos_parent >= 0:
        ddos_parent = plan.ddos_parent
        ddos_sel = np.ascontiguousarray(plan.ddos_sel, dtype=np.int64)
        ddos_sel_w = ddos_sel.shape[0]
        ddos_keys = np.empty((max(n, 1), ddos_sel_w), np.uint32)
        ddos_sums = np.empty(max(n, 1), np.float32)
    g = lib.fpt_ff_fused_update(
        _c_arr(lanes), n, w, _c_arr(vals), p, nf,
        *(_c_arr(a) for a in i64), *(_c_arr(a) for a in u8),
        cms_p, tkey_p, tval_p, int(bool(do_sketch)), ddos_parent,
        _c_arr(ddos_sel) if ddos_sel is not None else None, ddos_sel_w,
        plan.ddos_plane if ddos_parent >= 0 else -1,
        _c_arr(ddos_keys) if ddos_keys is not None else None,
        _c_arr(ddos_sums) if ddos_sums is not None else None,
        int(threads), _stats_ptr(stats),
        _c_arr(inv) if inv is not None else None, ks_p, kc_p)
    if g < 0:
        raise ValueError(f"fpt_ff_fused_update failed (rc={g}): degenerate "
                         f"shape n={n} w={w} p={p} nf={nf}")
    if ddos_parent < 0:
        return None
    return ddos_keys[:g], ddos_sums[:g]
