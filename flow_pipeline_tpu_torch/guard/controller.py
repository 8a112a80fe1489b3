"""The guard (``-guard.lag``): the per-worker overload controller.

Counterpart of flow_pipeline_tpu/guard/controller.py (numpy and stdlib
only), copied so the port imports nothing of the JAX package. A
deterministic degradation ladder:

- **Level 0** (the normal state): exact. The rows are the unguarded
  run's; the guard costs one attribute read per batch when disarmed and
  one hash-free ``observe`` when armed but idle.
- **Level 1**: drop optional work. The sketch audit's cohort refresh
  pauses and the trace ring stops recording.
- **Level >= 2**: deterministic hash-sampled admission at keep rate
  ``1/2^(level-1)``. The shed set is a pure function of (flow key,
  level): the sketch audit's multiply-shift hash family minted from
  another protocol seed, so the shed set is uncorrelated with the audit
  cohort. Admitted rows carry the scale factor in their
  ``sampling_rate`` column, which the CMS and the window aggregator
  already honour, so scaled estimates stay unbiased.

The ladder is driven by watermark lag (bus produce time to worker
pickup, the age of the backlog head): past the ``-guard.lag`` budget the
controller steps down one level per dwell period; once lag re-enters the
hysteresis band (``hysteresis * budget``) it steps back up, one level per
dwell. ``-guard.lag 0`` (the default) disarms it.

Shed is never silent: ``guard_shed_total{stage,reason}`` counts every
dropped flow and query, ``flow_guard_level`` gauges the level. The
families are obs/families.py's, registered there once. The admission
hash is host numpy and runs on the host before any card step: it is not
a kernel.
"""

from __future__ import annotations

# Ladder transitions are serialized by _lock; ``level`` is also read
# without it from the ingest group thread (a racy but monotone int read:
# a stale read sheds one batch at the previous level, which the per-row
# scale factor still accounts for).

import logging
import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..obs.audit import _lane_mults, _sample_hash
from ..obs.families import GUARD_METRICS, register_guard_metrics

log = logging.getLogger("flow_pipeline_tpu_torch.guard")

# The admission-hash protocol seed, distinct from obs.audit's
# AUDIT_SAMPLE_SEED: the shed set must be uncorrelated with the audit
# cohort, so the audit keeps an unbiased exact shadow of the keys that
# survive admission and measures the sampling error.
GUARD_SAMPLE_SEED = 0x6A4D_BA1A

_GUARD_MULTS = _lane_mults(16, GUARD_SAMPLE_SEED)


def flow_key_lanes(columns) -> np.ndarray:
    """[N, 11] uint32 admission-key lanes of a batch's columns: the
    5-tuple (src_addr, dst_addr, src_port, dst_port, proto), the same
    lanes on every worker, so one flow sheds identically everywhere."""
    n = len(columns["proto"])
    lanes = np.empty((n, 11), dtype=np.uint32)
    lanes[:, 0:4] = columns["src_addr"]
    lanes[:, 4:8] = columns["dst_addr"]
    lanes[:, 8] = columns["src_port"]
    lanes[:, 9] = columns["dst_port"]
    lanes[:, 10] = columns["proto"]
    return lanes


def admission_mask(columns, shift: int) -> np.ndarray:
    """[N] bool: which rows survive admission at sampling shift ``shift``
    (keep rate 1/2^shift). A pure function of (flow key, shift);
    shift <= 0 keeps all."""
    if shift <= 0:
        return np.ones(len(columns["proto"]), dtype=bool)
    h = _sample_hash(flow_key_lanes(columns), _GUARD_MULTS)
    return (h & np.uint32((1 << shift) - 1)) == np.uint32(0)


@dataclass(frozen=True)
class GuardConfig:
    """Ladder tuning. ``lag_budget`` <= 0 disarms the controller (the
    default, so every exact path runs untouched)."""

    lag_budget: float = 0.0   # seconds of watermark lag tolerated
    max_level: int = 6        # ladder ceiling (keep rate 1/32 at 6)
    hysteresis: float = 0.5   # step up when lag < hysteresis * budget
    dwell: float = 5.0        # min seconds between ladder transitions


class GuardController:
    """The degradation-ladder state machine of one worker.

    ``observe(lag)`` runs on the worker thread per batch (and with lag
    0.0 on idle polls, so recovery needs no traffic); ``level`` is read
    without the lock from the ingest group thread by the admission
    wrapper."""

    def __init__(self, config: GuardConfig = GuardConfig()):
        self.config = config
        if config.max_level < 1:
            raise ValueError(
                f"guard max_level must be >= 1, got {config.max_level}")
        m = register_guard_metrics()
        self.m_level = m["level"]
        self.m_lag = m["lag"]
        self.m_shed = m["shed"]
        self.m_transitions = m["transitions"]
        self.level = 0
        self._lock = threading.Lock()
        self._last_change = 0.0      # guarded by _lock
        self._shed_rows = 0          # guarded by _lock
        self._max_level_seen = 0     # guarded by _lock

    @property
    def armed(self) -> bool:
        return self.config.lag_budget > 0.0

    @property
    def sample_shift(self) -> int:
        """Admission sampling shift s at the current level (keep rate
        1/2^s): levels 0 and 1 admit everything; level L >= 2 is L-1."""
        return max(0, self.level - 1)

    @property
    def drop_optional(self) -> bool:
        """Level >= 1: the audit's cohort refresh and the trace ring
        pause."""
        return self.level >= 1

    # ---- ladder ------------------------------------------------------------

    def observe(self, lag: float, now: Optional[float] = None) -> int:
        """Feed one watermark-lag measurement; returns the (possibly
        stepped) level. One transition per dwell period either way;
        recovery needs lag back inside the hysteresis band, not merely
        under budget, so the level does not flap at the boundary."""
        if not self.armed:
            return 0
        now = time.monotonic() if now is None else now
        self.m_lag.set(lag)
        cfg = self.config
        with self._lock:
            level = self.level
            if now - self._last_change < cfg.dwell:
                return level
            if lag > cfg.lag_budget and level < cfg.max_level:
                self.level = level + 1
                self._last_change = now
                self._max_level_seen = max(self._max_level_seen,
                                           self.level)
                new = self.level
                direction = "down"
            elif lag < cfg.hysteresis * cfg.lag_budget and level > 0:
                self.level = level - 1
                self._last_change = now
                new = self.level
                direction = "up"
            else:
                return level
        self.m_level.set(new)
        self.m_transitions.inc(direction=direction)
        log.warning("guard level %d -> %d (lag %.2fs, budget %.2fs)",
                    level, new, lag, cfg.lag_budget)
        return new

    # ---- admission ---------------------------------------------------------

    def admit(self, batch):
        """Deterministic hash-sampled admission of one FlowBatch at the
        current level. Returns (admitted batch, rows shed). The admitted
        batch keeps the full offset range (shed rows still commit: they
        were consumed and counted, not lost), and its survivors'
        ``sampling_rate`` is multiplied by 2^shift so every scale-aware
        estimate downstream stays unbiased."""
        shift = self.sample_shift
        if shift <= 0 or len(batch) == 0:
            return batch, 0
        mask = admission_mask(batch.columns, shift)
        dropped = int(len(batch) - mask.sum())
        if dropped == 0:
            return batch, 0
        admitted = batch.take(mask)
        # absent-rate rows (rate 0) scale as rate 1: the max(rate, 1)
        # convention of the heavy hitters' scale plane
        sr = admitted.columns["sampling_rate"]
        np.maximum(sr, np.uint64(1), out=sr)
        sr *= np.uint64(1 << shift)
        self.m_shed.inc(dropped, stage="ingest", reason="admission")
        with self._lock:
            self._shed_rows += dropped
        return admitted, dropped

    def count_shed(self, n: int, stage: str, reason: str) -> None:
        """Count ``n`` items shed at a stage other than admission (the
        serve accept queue, a deadline miss). Never silent."""
        if n <= 0:
            return
        self.m_shed.inc(n, stage=stage, reason=reason)
        with self._lock:
            self._shed_rows += n

    # ---- snapshot metadata -------------------------------------------------

    def meta(self) -> dict:
        """JSON-safe guard state: readers can tell which sampling level
        the answer they hold was built under."""
        with self._lock:
            return {
                "level": self.level,
                "sample_shift": self.sample_shift,
                "max_level_seen": self._max_level_seen,
                "shed_total": self._shed_rows,
                "lag_budget": self.config.lag_budget,
            }

