"""Host-side per-stage wall-clock timers.

Counterpart of flow_pipeline_tpu/obs/tracing.py's ``StageTimer`` (the
JAX profiler hook there has no counterpart here): each stage feeds a
``flow_summary_<stage>_time_us`` summary, the family the reference's
dashboards chart, and the aggregable ``flow_stage_duration_us``
histogram by stage.
"""

from __future__ import annotations

import contextlib
import time

from .metrics import REGISTRY

# Stage names are minted by callers and each one registers a summary
# family, so the set is capped: beyond MAX_STAGES distinct names the
# observations fold into flow_summary_other_time_us.
MAX_STAGES = 64
OVERFLOW_STAGE = "other"

STAGE_HISTOGRAM = "flow_stage_duration_us"


class StageTimer:
    """Named per-stage timers -> flow_summary_<stage>_time_us summaries
    + the shared flow_stage_duration_us{stage=...} histogram."""

    def __init__(self):
        self._summaries = {}
        # registered eagerly: /metrics carries the family before the
        # first observation
        self._hist = REGISTRY.histogram(
            STAGE_HISTOGRAM,
            "per-stage wall time histogram (us; aggregable across "
            "instances, unlike the summary quantiles)")

    def _resolve(self, name: str) -> str:
        if name in self._summaries or len(self._summaries) < MAX_STAGES:
            return name
        return OVERFLOW_STAGE

    def _summary(self, name: str):
        s = self._summaries.get(name)
        if s is None:
            s = REGISTRY.summary(f"flow_summary_{name}_time_us",
                                 f"{name} stage wall time")
            self._summaries[name] = s
        return s

    def observe(self, name: str, us: float) -> None:
        """Record one measurement directly (for callers that decide after
        the fact whether a timing counts, e.g. skipping no-op flushes)."""
        name = self._resolve(name)
        self._summary(name).observe(us)
        self._hist.observe(us, stage=name)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, (time.perf_counter() - t0) * 1e6)
