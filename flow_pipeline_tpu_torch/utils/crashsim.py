"""Crash-point model checker over the durable-filesystem op log.

A copy of flow_pipeline_tpu/utils/crashsim.py (stdlib only).
``utils/fsutil.py`` records the op log of a real run; this module
replays every legal crash point of that log into a fresh directory and
runs the real recovery code over each one.

**Persistence model.** A ``write`` becomes durable at the next ``fsync``
on that file; a name operation (create / rename / replace / remove)
becomes durable at the next ``fsync_dir`` on its directory.
``replace``/``rename`` are atomic, but the inode the new name points at
holds only its synced content.

**Crash states per crash point** (after each op prefix): everything
applied; only the durable effects; names applied with only synced
content; synced names with applied content; the last unsynced write cut
at 0 / 1 / half / len-1 bytes; and each unsynced write lost on its own
while later ones landed. States are deduplicated by content hash before
recovery runs.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from dataclasses import dataclass, field
from typing import Callable, Optional

from .fsutil import OpRecorder

# cap the torn-tail cut points and drop-one variants per crash point so
# pathological op logs cannot make the sweep quadratic-times-huge; the
# caps are far above what any repo scenario produces
MAX_DROP_VARIANTS = 8


class _Inode:
    """One file's content state during the walk: ``synced`` survived an
    fsync; ``pending`` writes are at the disk's mercy."""

    __slots__ = ("synced", "pending")

    def __init__(self) -> None:
        self.synced = b""
        self.pending: list[tuple[int, bytes, int]] = []  # (off, data, op idx)

    def content(self, *, include_pending: bool = True,
                drop_idx: Optional[int] = None,
                cut: Optional[tuple[int, int]] = None) -> bytes:
        """Materialize content under a policy: optionally apply pending
        writes, optionally drop the pending write with op index
        ``drop_idx`` (later writes still land; the hole is zeros),
        optionally cut the pending write with op index ``cut[0]`` to
        ``cut[1]`` bytes (torn tail)."""
        buf = bytearray(self.synced)
        if not include_pending:
            return bytes(buf)
        for off, data, idx in self.pending:
            if idx == drop_idx:
                continue
            if cut is not None and idx == cut[0]:
                data = data[:cut[1]]
            end = off + len(data)
            if end > len(buf):
                buf.extend(b"\0" * (end - len(buf)))
            buf[off:off + len(data)] = data
        return bytes(buf)


@dataclass
class _NameOp:
    """One atomic namespace transition: a list of (verb, path[, inode])
    edits applied all-or-nothing. ``durable_at`` is the op index of the
    fsync_dir that persisted it (None = still pending)."""

    idx: int
    edits: list[tuple]
    dirs: set[str]
    durable_at: Optional[int] = None


@dataclass
class Violation:
    crash_op: int
    state_kind: str
    acked: list[str]
    error: str

    def render(self) -> str:
        return (f"crash after op {self.crash_op} [{self.state_kind}] "
                f"acked={self.acked!r}: {self.error}")


@dataclass
class CrashReport:
    ops: int = 0
    crash_points: int = 0
    states_explored: int = 0
    states_deduped: int = 0
    violations: list[Violation] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    def render(self) -> str:
        head = (f"crashsim: {self.ops} ops, {self.crash_points} crash "
                f"points, {self.states_explored} distinct states "
                f"({self.states_deduped} deduped)")
        if self.ok:
            return head + " — all invariants held"
        lines = [head + f" — {len(self.violations)} VIOLATION(S):"]
        lines += ["  " + v.render() for v in self.violations[:20]]
        return "\n".join(lines)


class _Walk:
    """Replay a recorded op prefix into the persistence model."""

    def __init__(self) -> None:
        self.files: dict[str, _Inode] = {}   # runtime path -> inode
        self.name_ops: list[_NameOp] = []
        self.acked: list[str] = []

    def _bind(self, idx: int, path: str, inode: _Inode) -> None:
        self.files[path] = inode
        self.name_ops.append(_NameOp(
            idx, [("set", path, inode)], {os.path.dirname(path)}))

    def _move(self, idx: int, src: str, dst: str) -> None:
        """rename/replace of a file OR a directory subtree, as one
        atomic namespace transition."""
        edits: list[tuple] = []
        dirs = {os.path.dirname(src), os.path.dirname(dst)}
        if src in self.files:  # plain file
            inode = self.files.pop(src)
            self.files[dst] = inode
            edits = [("del", src), ("set", dst, inode)]
        else:  # directory: move every tracked path under it
            prefix = src.rstrip(os.sep) + os.sep
            moved = [p for p in self.files if p.startswith(prefix)]
            for p in moved:
                inode = self.files.pop(p)
                newp = dst.rstrip(os.sep) + os.sep + p[len(prefix):]
                self.files[newp] = inode
                edits.append(("del", p))
                edits.append(("set", newp, inode))
        self.name_ops.append(_NameOp(idx, edits, dirs))

    def apply(self, idx: int, op: tuple) -> None:
        kind = op[0]
        if kind == "open":
            _, path, mode = op
            if mode == "a" and path in self.files:
                return  # append to an existing inode: no name change
            self._bind(idx, path, _Inode())
        elif kind == "write":
            _, path, off, data = op
            inode = self.files.get(path)
            if inode is None:  # write with no recorded open: adopt
                inode = _Inode()
                self._bind(idx, path, inode)
            inode.pending.append((off, data, idx))
        elif kind == "fsync":
            inode = self.files.get(op[1])
            if inode is not None:
                inode.synced = inode.content()
                inode.pending = []
        elif kind == "fsync_dir":
            d = op[1].rstrip(os.sep)
            for nop in self.name_ops:
                if nop.durable_at is None and nop.idx < idx and \
                        any(x.rstrip(os.sep) == d for x in nop.dirs):
                    nop.durable_at = idx
        elif kind in ("replace", "rename"):
            self._move(idx, op[1], op[2])
        elif kind == "remove":
            _, path = op
            self.files.pop(path, None)
            self.name_ops.append(_NameOp(
                idx, [("del", path)], {os.path.dirname(path)}))
        elif kind == "rmtree":
            _, path = op
            prefix = path.rstrip(os.sep) + os.sep
            doomed = [p for p in self.files
                      if p == path or p.startswith(prefix)]
            for p in doomed:
                self.files.pop(p, None)
            self.name_ops.append(_NameOp(
                idx, [("del", p) for p in doomed],
                {os.path.dirname(path)}))
        elif kind == "mark":
            self.acked.append(op[1])
        else:  # pragma: no cover - future op kinds
            raise ValueError(f"crashsim: unknown op kind {kind!r}")

    # ---- crash-state construction ----------------------------------------

    def namespace(self, upto: int, *, all_names: bool) -> dict[str, _Inode]:
        """path -> inode after applying the name ops with idx <= upto
        that are durable (or all of them when ``all_names``)."""
        ns: dict[str, _Inode] = {}
        for nop in self.name_ops:
            if nop.idx > upto:
                break
            durable = nop.durable_at is not None and nop.durable_at <= upto
            if not (durable or all_names):
                continue
            for edit in nop.edits:
                if edit[0] == "set":
                    ns[edit[1]] = edit[2]
                else:
                    ns.pop(edit[1], None)
        return ns


def _state_bytes(ns: dict[str, _Inode], **content_kw) -> dict[str, bytes]:
    return {p: inode.content(**content_kw) for p, inode in ns.items()}


def _crash_states(walk: _Walk, upto: int):
    """Yield (kind, {path: bytes}) for every modeled crash state at
    this crash point."""
    ns_all = walk.namespace(upto, all_names=True)
    ns_dur = walk.namespace(upto, all_names=False)
    yield "all-applied", _state_bytes(ns_all)
    yield "durable-only", _state_bytes(ns_dur, include_pending=False)
    yield "names-applied/content-synced", \
        _state_bytes(ns_all, include_pending=False)
    yield "names-synced/content-applied", _state_bytes(ns_dur)
    # torn tail of the LAST unsynced write
    pend = [(idx, len(data))
            for inode in ns_all.values()
            for _off, data, idx in inode.pending]
    if pend:
        last_idx, last_len = max(pend)
        for cut in sorted({0, 1, last_len // 2, max(0, last_len - 1)}):
            if cut >= last_len:
                continue
            yield f"torn-tail@{cut}", \
                _state_bytes(ns_all, cut=(last_idx, cut))
        # drop-one: unsynced writes may be reordered/lost independently
        drop = sorted({idx for idx, _n in pend})[-MAX_DROP_VARIANTS:]
        for idx in drop:
            yield f"drop-write@{idx}", _state_bytes(ns_all, drop_idx=idx)


def explore(recorder: OpRecorder, workdir: str,
            check: Callable[[str, list[str]], None],
            *, fail_fast: bool = False) -> CrashReport:
    """Enumerate every crash state of the recorded run and call
    ``check(recovered_dir, acked_labels)`` on each; ``check`` runs the
    real recovery code and raises (AssertionError or any exception) on
    an invariant violation. Paths in the op log must live under
    ``workdir``; each state is materialized into a fresh directory laid
    out the same way."""
    ops = list(recorder.ops)
    workdir = os.path.abspath(workdir)
    report = CrashReport(ops=len(ops))
    seen: set[bytes] = set()
    # crash before the first op, between every pair, and after the last
    for upto in range(-1, len(ops)):
        report.crash_points += 1
        walk = _Walk()
        for i, op in enumerate(ops[:upto + 1]):
            walk.apply(i, op)
        for kind, state in _crash_states(walk, upto):
            digest = hashlib.sha256(repr(
                sorted((p, hashlib.sha256(b).digest())
                       for p, b in state.items())
            ).encode() + repr(walk.acked).encode()).digest()
            if digest in seen:
                report.states_deduped += 1
                continue
            seen.add(digest)
            report.states_explored += 1
            with tempfile.TemporaryDirectory(
                    prefix="crashsim-") as croot:
                for path, data in state.items():
                    rel = os.path.relpath(os.path.abspath(path), workdir)
                    if rel.startswith(".."):
                        raise ValueError(
                            f"crashsim: op path {path!r} escapes "
                            f"workdir {workdir!r}")
                    dst = os.path.join(croot, rel)
                    os.makedirs(os.path.dirname(dst), exist_ok=True)
                    with open(dst, "wb") as f:
                        f.write(data)
                try:
                    check(croot, list(walk.acked))
                except Exception as e:  # noqa: BLE001 -- any recovery failure is the finding
                    report.violations.append(Violation(
                        upto, kind, list(walk.acked),
                        f"{type(e).__name__}: {e}"))
                    if fail_fast:
                        return report
    return report
