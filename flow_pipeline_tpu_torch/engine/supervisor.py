"""Failure detection and restart for deployments without a container
supervisor.

A copy of flow_pipeline_tpu/engine/supervisor.py: run a worker factory,
restart on a crash with exponential backoff, give up after
``max_restarts`` crashes within ``window_seconds`` (a crash loop is a bug,
not a transient). The worker's checkpoints and committed offsets make a
restart safe: a fresh worker restores the snapshot and resumes from the
committed offsets.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Callable

from ..obs.metrics import REGISTRY

log = logging.getLogger("flow_pipeline_tpu_torch.supervisor")


@dataclass(frozen=True)
class SupervisorConfig:
    max_restarts: int = 5
    window_seconds: float = 300.0
    backoff_initial: float = 0.5
    backoff_max: float = 30.0


class Supervisor:
    """``run()`` builds a worker with ``factory()`` and calls
    ``worker.run(**run_kwargs)``; on an exception it rebuilds (the factory
    should restore) and retries with backoff. A crash inside
    ``factory()`` counts as a worker crash. ``time_fn``/``sleep_fn`` are
    injectable for tests."""

    def __init__(self, factory: Callable,
                 config: SupervisorConfig = SupervisorConfig(),
                 time_fn: Callable[[], float] = time.monotonic,
                 sleep_fn: Callable[[float], None] = time.sleep,
                 **run_kwargs):
        self.factory = factory
        self.config = config
        self.run_kwargs = run_kwargs
        self.restarts = 0
        self._time = time_fn
        self._sleep = sleep_fn
        self.m_restarts = REGISTRY.counter("worker_restarts_total",
                                           "supervisor worker restarts")

    def run(self) -> None:
        crash_times: list[float] = []
        backoff = self.config.backoff_initial
        while True:
            worker = None
            try:
                worker = self.factory()
                worker.run(**self.run_kwargs)
                return  # a clean exit
            except KeyboardInterrupt:
                if worker is not None:
                    worker.finalize()
                raise
            except Exception as e:  # noqa: BLE001 -- the supervisor's job
                now = self._time()
                recent = [t for t in crash_times
                          if now - t < self.config.window_seconds]
                if not recent:  # a healthy era since the last burst
                    backoff = self.config.backoff_initial
                crash_times = recent + [now]
                self.restarts += 1
                self.m_restarts.inc()
                if len(crash_times) > self.config.max_restarts:
                    log.error("crash loop (%d crashes in %.0fs); giving up",
                              len(crash_times), self.config.window_seconds)
                    raise
                log.exception("worker crashed (%s); restarting in %.1fs",
                              e, backoff)
                self._sleep(backoff)
                backoff = min(backoff * 2, self.config.backoff_max)
