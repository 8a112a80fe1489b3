"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled for ``sm_90a`` by an ``nvcc`` of its own,
all started at once, and one ``nvcc`` links the objects into one shared
library with a plain C interface, loaded with ctypes:

    build/torch_kernels/libfpt_kernels-<key>.so   (beside the package)

``<key>`` hashes every source and header, the flags and the ``nvcc``
path, so a change to any of them builds a new library instead of loading
an old one. The build happens at first use (``library()``), never at
import, so the CPU tests can import every module on a machine without
``nvcc``. Call ``build(force=True)`` to rebuild and read the compiler's
register, stack and spill report (``-Xptxas -v``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
LIB_STEM = "libfpt_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None


@dataclass
class BuildInfo:
    path: Path
    seconds: float
    log: str  # nvcc's stderr: ptxas registers / shared memory per kernel


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be "
                       "built on this machine")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_key(nvcc: str, csrc: Path = CSRC,
              flags: tuple[str, ...] = NVCC_FLAGS) -> str:
    """Hash of what the library is built from: every source and header
    (name and bytes), the flags and the compiler's path."""
    h = hashlib.sha256()
    for src in sorted([*csrc.glob("*.cu"), *csrc.glob("*.cuh")]):
        h.update(src.name.encode() + b"\0" + src.read_bytes() + b"\0")
    h.update("\0".join(flags).encode() + b"\0" + nvcc.encode())
    return h.hexdigest()[:20]


def build(force: bool = False) -> BuildInfo:
    """Compile csrc/*.cu into the library its build key names, unless
    that library exists already (or ``force``)."""
    nvcc = _nvcc()
    lib = BUILD_DIR / f"{LIB_STEM}-{build_key(nvcc)}.so"
    if not force and lib.exists():
        return BuildInfo(lib, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_lib = Path(tmp) / lib.name
        objs = [Path(tmp) / f"{src.stem}.o" for src in _sources()]
        compiles = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-I", str(CSRC), str(src), "-o",
             str(obj)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for src, obj in zip(_sources(), objs)]
        log = "".join(p.communicate()[0] for p in compiles)
        if any(p.returncode != 0 for p in compiles):
            raise RuntimeError("nvcc failed\n" + log)
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o",
             str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log += link.stdout
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed\n" + log)
        os.replace(tmp_lib, lib)  # atomic: a reader never sees half a file
    return BuildInfo(lib, time.perf_counter() - t0, log)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    for name, argtypes in (
            ("fpt_cms_conservative", [p, p, i, p, p, i, i, i, i, i, p, p, p,
                                      p]),
            ("fpt_cms_linear", [p, p, i, p, p, i, i, i, i, i, p, p, p]),
            ("fpt_cms_conservative_resident_rows", [i, i, i, i, ip]),
            ("fpt_cms_linear_resident_rows", [i, i, i, ip])):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i
    lib.fpt_error_string.argtypes = [i]
    lib.fpt_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build().path)))
        return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a C entry returned a CUDA error code."""
    if err != 0:
        msg = lib.fpt_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
