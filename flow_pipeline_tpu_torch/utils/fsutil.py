"""Durable-filesystem helpers: one idiom for every durable surface.

A copy of flow_pipeline_tpu/utils/fsutil.py (stdlib only). The
checkpoint and the dead-letter spill write through these helpers, and
every helper reports its operation to an injectable observer
(:func:`observed`), so a real run's op log can be replayed crash point by
crash point by ``utils/crashsim.py``.

The protocol:

- file contents become durable at ``fsync_file`` (or the fsync inside
  ``write_bytes_durable``), never at ``flush()``;
- a fresh or renamed name becomes durable at ``fsync_dir`` on its
  directory;
- an atomic publish is ``write tmp -> fsync tmp -> replace -> fsync_dir``;
  :func:`write_bytes_durable` is that sequence as one call.

``suppressed(...)`` exists for mutation checks only: it deletes one
barrier kind (``fsync`` / ``fsync_dir`` / ``replace``) from the recorded
protocol, so the crash-point checker can show each barrier matters.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Optional

__all__ = [
    "OpRecorder", "observed", "suppressed", "open_durable",
    "fsync_file", "fsync_dir", "write_bytes_durable", "replace",
    "rename", "remove", "rmtree",
]


# ---- the injectable observer (crash-point model checking) ---------------

class OpRecorder:
    """Append-only log of durable-filesystem operations, recorded by
    the helpers below while installed via :func:`observed`. Ops are
    plain tuples whose first element is the kind::

        ("open", path, mode)         mode in {"w", "a", "x"}
        ("write", path, offset, b"") one buffered write
        ("fsync", path)              contents durable up to here
        ("fsync_dir", dir)           names in dir durable up to here
        ("replace", src, dst)        atomic publish
        ("rename", src, dst)         atomic move (files or dirs)
        ("remove", path)             unlink
        ("rmtree", path)             recursive unlink (one entry)
        ("mark", label)              test-harness ack marker

    ``mark()`` is called by crash-point scenarios (never production
    code) to pin WHERE in the op order an ack went out — the invariant
    checks are phrased over "everything acked by this crash point".
    """

    def __init__(self) -> None:
        self.ops: list[tuple] = []
        self._lock = threading.Lock()

    def record(self, op: tuple) -> None:
        with self._lock:
            self.ops.append(op)

    def mark(self, label: str) -> None:
        self.record(("mark", label))


_observer: Optional[OpRecorder] = None
_suppress: frozenset = frozenset()

_SUPPRESSIBLE = frozenset({"fsync", "fsync_dir", "replace"})


@contextlib.contextmanager
def observed(recorder: OpRecorder):
    """Install ``recorder`` as the op observer for the duration of the
    block. Not reentrant; crash-point scenarios are single-run."""
    global _observer
    prev = _observer
    _observer = recorder
    try:
        yield recorder
    finally:
        _observer = prev


@contextlib.contextmanager
def suppressed(*kinds: str):
    """MUTATION TESTING ONLY: drop the named barrier kinds from the
    protocol (the op is neither performed nor recorded — exactly as if
    the call site had been deleted). ``replace`` degrades to a
    non-atomic in-place rewrite instead of vanishing: the file must
    still be published for the run to proceed, the mutation is losing
    its atomicity."""
    global _suppress
    unknown = set(kinds) - _SUPPRESSIBLE
    if unknown:
        raise ValueError(f"unknown suppressible barrier(s): "
                         f"{sorted(unknown)} (know {sorted(_SUPPRESSIBLE)})")
    prev = _suppress
    _suppress = prev | set(kinds)
    try:
        yield
    finally:
        _suppress = prev


def _rec(op: tuple) -> None:
    obs = _observer
    if obs is not None:
        obs.record(op)


# ---- the durable-write helpers ------------------------------------------

class DurableFile:
    """Thin binary-file proxy that reports writes to the observer.
    Supports the surface the durable writers use: ``write``, ``flush``,
    ``fileno``, ``tell``, ``close``, context manager."""

    def __init__(self, path: str, raw):
        self.path = path
        self._raw = raw

    def write(self, data) -> int:
        off = self._raw.tell()
        n = self._raw.write(data)
        _rec(("write", self.path, off, bytes(data)))
        return n

    def flush(self) -> None:
        self._raw.flush()

    def fileno(self) -> int:
        return self._raw.fileno()

    def tell(self) -> int:
        return self._raw.tell()

    def close(self) -> None:
        self._raw.close()

    @property
    def closed(self) -> bool:
        return self._raw.closed

    def __enter__(self) -> "DurableFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def open_durable(path: str, mode: str = "wb") -> DurableFile:
    """Open a durable-state file for writing (binary modes only: text
    mode has opaque ``tell`` cookies, and durable surfaces frame bytes).
    The open and every subsequent write are reported to the observer."""
    if "b" not in mode or not any(c in mode for c in "wax"):
        raise ValueError(
            f"open_durable wants a binary write mode, got {mode!r}")
    existed = os.path.exists(path)
    raw = open(path, mode)
    kind = "a" if "a" in mode and existed else \
        ("a" if "a" in mode else ("x" if "x" in mode else "w"))
    _rec(("open", path, kind))
    return DurableFile(path, raw)


def fsync_file(f) -> None:
    """Flush + fsync one open file: the CONTENT durability barrier.
    Accepts a :class:`DurableFile` or any raw file object."""
    f.flush()
    if "fsync" in _suppress:
        return
    os.fsync(f.fileno())
    _rec(("fsync", getattr(f, "path", getattr(f, "name", "?"))))


def fsync_dir(path: str) -> None:
    """Make a directory entry durable: fsyncing file CONTENTS alone
    does not persist a freshly created or renamed name — power loss
    can drop the file after its data was synced, silently voiding a
    durability contract. Best-effort on platforms whose directories
    cannot be opened for sync."""
    if "fsync_dir" in _suppress:
        return
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover - platform-dependent
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    _rec(("fsync_dir", path))


def replace(src: str, dst: str) -> None:
    """Atomic publish: ``os.replace`` plus the op record. Callers still
    owe a :func:`fsync_dir` on the containing directory afterwards (the
    static rule enforces it)."""
    if "replace" in _suppress:
        # mutation mode: publish non-atomically (truncate + rewrite in
        # place), which is what losing the atomic step amounts to. The
        # real filesystem still sees a replace so the run proceeds; the
        # RECORDED protocol is the mutated one the checker judges.
        try:
            with open(src, "rb") as f:
                data = f.read()
        except OSError:
            data = b""
        _rec(("open", dst, "w"))
        _rec(("write", dst, 0, data))
        _rec(("remove", src))
        os.replace(src, dst)
        return
    os.replace(src, dst)
    _rec(("replace", src, dst))


def rename(src: str, dst: str) -> None:
    """Atomic move of a file OR directory tree (``os.rename``); same
    dir-fsync obligation as :func:`replace`."""
    os.rename(src, dst)
    _rec(("rename", src, dst))


def remove(path: str) -> None:
    """Unlink a durable name (recorded); the removal is durable only
    after :func:`fsync_dir` on the containing directory."""
    os.remove(path)
    _rec(("remove", path))


def rmtree(path: str) -> None:
    """Recursive unlink, recorded as ONE op (only ever used on
    superseded staging/backup trees, e.g. a checkpoint's ``.old``)."""
    import shutil
    shutil.rmtree(path, ignore_errors=True)
    _rec(("rmtree", path))


def write_bytes_durable(path: str, data: bytes) -> None:
    """The whole atomic-publish sentence as one call: write a sibling
    temp file, fsync it, atomically replace ``path``, fsync the
    containing directory. After this returns, ``path`` holds exactly
    ``data`` across any crash — or the previous contents of ``path``
    if the crash beat the replace."""
    tmp = path + ".tmp"
    with open_durable(tmp, "wb") as f:
        f.write(data)
        fsync_file(f)
    replace(tmp, path)
    fsync_dir(os.path.dirname(os.path.abspath(path)) or ".")
