"""Mesh-wide trace aggregation with clock alignment across processes.

Counterpart of flow_pipeline_tpu/mesh/scope.py (stdlib only, copied):

- ``estimate_offset`` / ``ClockSync``: NTP-midpoint clock offset
  samples; a requester stamps ``t0``/``t1`` around a round trip whose
  reply carries the remote wall clock, ``offset = remote_now - (t0 +
  t1) / 2`` estimates ``remote_clock - local_clock`` within ``rtt / 2``.
  ``ClockSync`` keeps a sliding window and answers with the minimum-RTT
  sample; a member sends it on its heartbeat (mesh/member.py).
- ``aggregate_traces``: per-process Chrome traces merged into one, each
  source on its own ``pid`` lane, member timestamps shifted by their
  offset onto the first lane's clock (a constant per lane, so each
  lane's event order is kept).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Optional


def estimate_offset(t0: float, t1: float,
                    remote_now: float) -> tuple[float, float]:
    """One NTP-midpoint sample: ``(offset, rtt)`` where ``offset`` is
    the estimate of ``remote_clock - local_clock`` in seconds and the
    true offset lies within ``rtt / 2`` of it."""
    rtt = max(0.0, t1 - t0)
    return remote_now - (t0 + t1) / 2.0, rtt


class ClockSync:
    """Sliding best-of-N offset estimator (member side). ``add()`` one
    sample per heartbeat round-trip; ``best()`` answers with the
    minimum-RTT sample in the window — RTT spikes (a stalled executor,
    a slow accept loop) widen the midpoint bound, so the tightest trip
    wins. Single-threaded by construction (the member's own thread)."""

    def __init__(self, window: int = 16):
        self._samples: deque[tuple[float, float]] = deque(maxlen=window)

    def add(self, t0: float, t1: float, remote_now: float) -> None:
        offset, rtt = estimate_offset(t0, t1, remote_now)
        self._samples.append((rtt, offset))

    def best(self) -> Optional[tuple[float, float]]:
        """(offset, rtt) of the tightest sample, or None before any."""
        if not self._samples:
            return None
        rtt, offset = min(self._samples)
        return offset, rtt

    def report(self) -> Optional[dict]:
        """The heartbeat payload: {"offset": remote-local s, "rtt": s}
        (None before the first sample — sync() omits the field)."""
        best = self.best()
        if best is None:
            return None
        return {"offset": best[0], "rtt": best[1]}


@dataclass
class TraceLane:
    """One process's contribution to the aggregate: its Chrome trace
    plus the clock estimate that aligns it. ``offset_s`` is this
    process's clock minus the reference (coordinator) clock; the
    reference lane passes 0."""

    name: str
    trace: dict
    offset_s: float = 0.0
    rtt_s: float = 0.0


def aggregate_traces(lanes: list[TraceLane]) -> dict:
    """Merge per-process Chrome traces into one clock-aligned trace.

    The FIRST lane is the reference clock (the coordinator). Each lane
    gets its own synthetic ``pid`` (stable: list order) with
    ``process_name`` / ``process_sort_index`` metadata events so
    Perfetto renders one labeled process track per mesh node; member
    event timestamps are shifted by ``-offset_s`` onto the reference
    clock (a constant per lane — order within a lane is preserved).
    ``otherData.lanes`` records each lane's offset, RTT, and the
    ``rtt/2`` alignment error bound."""
    events: list[dict] = []
    meta_lanes: list[dict] = []
    for i, lane in enumerate(lanes):
        pid = i + 1  # synthetic: the real pids may collide across hosts
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": lane.name}})
        events.append({"name": "process_sort_index", "ph": "M",
                       "pid": pid, "args": {"sort_index": i}})
        shift_us = lane.offset_s * 1e6
        n = 0
        for ev in lane.trace.get("traceEvents", []):
            ev = dict(ev)
            ev["pid"] = pid
            if ev.get("ph") != "M" and "ts" in ev:
                ev["ts"] = round(ev["ts"] - shift_us, 1)
            events.append(ev)
            n += 1
        other = lane.trace.get("otherData") or {}
        meta_lanes.append({
            "name": lane.name,
            "pid": pid,
            "events": n,
            "clock_offset_ms": round(lane.offset_s * 1e3, 3),
            "rtt_ms": round(lane.rtt_s * 1e3, 3),
            "alignment_error_bound_ms": round(lane.rtt_s * 1e3 / 2, 3),
            "mode": other.get("mode"),
            "dropped_spans": other.get("dropped_spans", 0),
        })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "source": "flow-pipeline-tpu meshscope",
            "reference": lanes[0].name if lanes else None,
            "lanes": meta_lanes,
        },
    }
