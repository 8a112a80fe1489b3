"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled by one ``nvcc`` call for ``sm_90a`` into
one shared library with a plain C interface, loaded with ctypes:

    build/torch_kernels/libfpt_kernels.so   (beside the package)

The build happens at first use (``library()``), never at import, so the
CPU tests can import every module on a machine without ``nvcc``. Call
``build(force=True)`` to rebuild and read the compiler's register and
shared-memory report (``-Xptxas -v``).
"""

from __future__ import annotations

import ctypes
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
LIB_NAME = "libfpt_kernels.so"
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


def _stale(lib: Path) -> bool:
    if not lib.exists():
        return True
    mtime = lib.stat().st_mtime
    return any(src.stat().st_mtime > mtime
               for src in [*_sources(), *CSRC.glob("*.cuh")])


def build(force: bool = False) -> BuildInfo:
    """Compile csrc/*.cu into the shared library (when stale or forced)."""
    lib = BUILD_DIR / LIB_NAME
    if not force and not _stale(lib):
        return BuildInfo(lib, 0.0, "")
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_lib = Path(tmp) / LIB_NAME
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-I", str(CSRC),
             *map(str, _sources()), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed\n" + proc.stdout)
        os.replace(tmp_lib, lib)  # atomic: a reader never sees half a file
    return BuildInfo(lib, time.perf_counter() - t0, proc.stdout)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.fpt_cms_add_conservative
    fn.argtypes = [p, p, i, p, p, i, i, i, i, i, p, p, p]
    fn.restype = i
    fn = lib.fpt_cms_add
    fn.argtypes = [p, p, i, p, p, i, i, i, i, i, p]
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
