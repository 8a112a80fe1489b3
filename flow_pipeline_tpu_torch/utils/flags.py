"""Dotted-flag config system.

The reference configures everything through Go stdlib flags with dotted
names — ``-kafka.brokers``, ``-flush.dur``, ``-proto.fixedlen``,
``-loglevel`` (ref: inserter/inserter.go:26-42, mocker/mocker.go:15-23) —
This module reproduces that surface (single-dash long flags, ``-flag value`` and ``-flag=value``,
bools accepting bare ``-flag`` / ``-flag=false``) so compose command lines
written for the reference binaries carry over. A string flag may name an
env var read when the flag is not given (``-faults``: FLOWTPU_FAULTS).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

# Every flag the port's binaries declare (a subset of the JAX package's
# registry, plus -device). FlagSet's declaring methods refuse any other
# name, so a typo in a flag declaration fails at startup.
KNOWN_FLAGS = frozenset({
    # common
    "loglevel", "kafka.topic",
    # generator / mocker
    "produce.count", "produce.rate", "produce.seed", "produce.profile",
    "produce.batch", "zipf.keys", "zipf.alpha", "zipf.spread", "out",
    # processor
    "device", "in", "sink", "processor.batch", "processor.mesh",
    "processor.fused",
    "processor.hostassist", "feed.prefetch",
    "model.flows5m", "model.talkers", "model.ips", "model.ports",
    "model.ddos", "sketch.width", "sketch.backend", "sketch.prefilter",
    "sketch.admission", "sketch.capacity", "sketch.topk", "hh.sketch",
    "window.lateness", "flush.count", "checkpoint.path",
    # spread detectors, host-grouped ingest runtime, host sketch dataplane
    "spread.enabled", "spread.depth", "spread.width", "spread.regs",
    "spread.capacity", "spread.topk", "ingest.mode", "ingest.shards",
    "ingest.depth", "ingest.flush_queue", "ingest.native_group",
    "ingest.fused", "ingest.threads",
    # sinks, observability and fault injection
    "sink.retries", "sink.deadletter", "metrics.addr", "obs.trace",
    "obs.audit", "faults",
    # the single-worker entry points: pipeline, the gRPC feed, the live
    # query API, the collector, the inserter and replay
    "bus.partitions", "listen.feed", "query.addr", "listen.netflow",
    "listen.sflow", "run.seconds", "postgres.dsn", "postgres.pass",
    "sqlite", "replay.dir", "replay.delete",
    # the raw archive and the serving tier (with its read-side admission)
    "archive.raw", "serve.addr", "serve.refresh", "serve.feed_bytes",
    "guard.serve_queue", "guard.serve_deadline",
    # the guard's ladder, the gateway and the history tier
    "guard.lag", "guard.max_level",
    "gateway.listen", "gateway.upstream", "gateway.poll",
    "gateway.adopt-restart",
    "history.dir", "history.keyframe", "history.retain",
    "history.upstream", "history.listen", "history.poll",
    # the mesh, in process and over HTTP, and its lineage query
    "mesh.workers", "mesh.heartbeat", "mesh.journal", "mesh.role",
    "mesh.coordinator", "mesh.id", "mesh.listen",
    "lineage.model", "lineage.slot", "lineage.raw",
})


@dataclass
class Flag:
    name: str
    default: Any
    help: str
    parse: Callable[[str], Any]
    env: Optional[str] = None  # env var read when the flag is not given
    is_bool: bool = False


def _parse_bool(s: str) -> bool:
    if s.lower() in ("1", "true", "t", "yes"):
        return True
    if s.lower() in ("0", "false", "f", "no"):
        return False
    raise ValueError(f"invalid boolean {s!r}")


class FlagSet:
    def __init__(self, prog: str):
        self.prog = prog
        self._flags: dict[str, Flag] = {}
        self.values: dict[str, Any] = {}

    def _register(self, flag: Flag) -> None:
        if flag.name not in KNOWN_FLAGS:
            raise ValueError(
                f"flag -{flag.name} is not in utils.flags.KNOWN_FLAGS")
        self._flags[flag.name] = flag

    def string(self, name: str, default: str, help_: str,
               env: Optional[str] = None):
        self._register(Flag(name, default, help_, str, env))
        return self

    def integer(self, name: str, default: int, help_: str):
        self._register(Flag(name, default, help_, int))
        return self

    def number(self, name: str, default: float, help_: str):
        self._register(Flag(name, default, help_, float))
        return self

    def boolean(self, name: str, default: bool, help_: str):
        self._register(Flag(name, default, help_, _parse_bool, is_bool=True))
        return self

    def usage(self) -> str:
        lines = [f"Usage of {self.prog}:"]
        for name in sorted(self._flags):
            f = self._flags[name]
            lines.append(f"  -{name} (default {f.default!r})\n        {f.help}")
        return "\n".join(lines)

    def parse(self, argv: Sequence[str]) -> dict[str, Any]:
        """Parse Go-style flags; raises SystemExit on -h/-help, ValueError on
        unknown or malformed flags."""
        vals = {}
        i = 0
        argv = list(argv)
        while i < len(argv):
            arg = argv[i]
            if not arg.startswith("-"):
                raise ValueError(f"unexpected positional argument {arg!r}")
            name = arg.lstrip("-")
            value = None
            if "=" in name:
                name, value = name.split("=", 1)
            if name in ("h", "help"):
                print(self.usage())
                raise SystemExit(0)
            flag = self._flags.get(name)
            if flag is None:
                raise ValueError(f"flag provided but not defined: -{name}\n{self.usage()}")
            if value is None:
                if flag.is_bool:
                    value = "true"  # bare -flag
                else:
                    i += 1
                    if i >= len(argv):
                        raise ValueError(f"flag -{name} needs a value")
                    value = argv[i]
            try:
                vals[name] = flag.parse(value)
            except ValueError as e:
                raise ValueError(f"invalid value for -{name}: {e}") from e
            i += 1
        for name, flag in self._flags.items():
            if name not in vals:
                if flag.env and os.environ.get(flag.env):
                    vals[name] = flag.parse(os.environ[flag.env])
                else:
                    vals[name] = flag.default
        self.values = vals
        return vals
