"""Name and help specs of the reference's metric families that every
worker registers, as zeros where the subsystem is off or not ported.

The reference's worker registers these on every worker, so the deploy/
dashboards and alerts resolve against any worker's ``/metrics``. The
port registers the same families under the same names and help (copied
from flow_pipeline_tpu/obs/audit.py, guard/controller.py,
hostsketch/pipeline.py, engine/hostfused.py and obs/buildinfo.py). The
sketch audit's series move on the host-grouped pipelines (obs/audit.py
binds these families); the guard ladder is not ported, so its series
stay at zero; the host_fused counters and ``native_path_degraded`` move
on the host sketch backend (hostsketch/pipeline.py). ``flow_build_info``
is published by the worker with what this process runs.
"""

from __future__ import annotations

from .metrics import REGISTRY
from .trace import TRACER

ERROR_RATIO_BUCKETS = (
    -1.0, -0.5, -0.25, -0.1, -0.01, 0.0, 0.001, 0.01, 0.05, 0.1, 0.25,
    0.5, 1.0, 2.5, 10.0,
)

AUDIT_METRICS = {
    "error": ("sketch_estimate_error_ratio",
              "sampled-cohort relative error (value - exact) / exact "
              "(labels: family, path=cms|table)"),
    "recall": ("sketch_hh_recall",
               "sampled-ground-truth heavy-hitter recall at k "
               "(label: family)"),
    "precision": ("sketch_hh_precision",
                  "sampled-ground-truth heavy-hitter precision at k "
                  "(label: family)"),
    "false_drop": ("sketch_audit_false_drop_total",
                   "sampled ground-truth top-k keys absent from the "
                   "candidate table at window close (label: family)"),
    "cohort": ("sketch_audit_sampled_keys",
               "sampled exact-shadow cohort size at the last window "
               "close (label: family)"),
    "windows": ("sketch_audit_windows_total",
                "windows audited (label: family)"),
    "overflow": ("sketch_audit_cohort_overflow_total",
                 "sampled keys dropped past AUDIT_MAX_COHORT — a "
                 "capped cohort is no longer shard-comparable "
                 "(label: family)"),
    "fill": ("sketch_cms_fill_ratio",
             "nonzero-cell fraction of the CMS (labels: family, "
             "plane) — the epsilon-degradation driver"),
    "row_min": ("sketch_cms_row_load_min",
                "min nonzero-cell fraction across depth rows, count "
                "plane (label: family)"),
    "row_max": ("sketch_cms_row_load_max",
                "max nonzero-cell fraction across depth rows, count "
                "plane (label: family)"),
    "occupancy": ("sketch_table_occupancy",
                  "top-K candidate table fill fraction "
                  "(label: family)"),
    "evictions": ("sketch_table_evictions_total",
                  "keys displaced from the candidate table "
                  "(admission churn; label: family)"),
    "est_frac": ("sketch_table_est_admitted_fraction",
                 "fraction of sampled table-resident keys whose table "
                 "value exceeds their exact count — the est-admission "
                 "(CMS-seeded entry) signature (label: family)"),
}

_AUDIT_GAUGES = frozenset({"recall", "precision", "cohort", "fill",
                           "row_min", "row_max", "occupancy",
                           "est_frac"})

GUARD_METRICS = {
    "level": ("flow_guard_level",
              "active flowguard degradation-ladder level (0 = exact, "
              "1 = optional work dropped, >=2 = hash-sampled admission "
              "at keep rate 1/2^(level-1))"),
    "lag": ("flow_guard_lag_seconds",
            "watermark lag the guard controller last observed (bus "
            "produce time -> worker pickup, age of the backlog head)"),
    "shed": ("guard_shed_total",
             "flows/queries shed by flowguard (labels: stage, reason) "
             "— every admission drop and serve-path rejection counts "
             "here; nothing is dropped silently"),
    "transitions": ("guard_transitions_total",
                    "flowguard ladder level changes (label: "
                    "direction=down|up; down = degrading)"),
    "buffer_bytes": ("guard_buffer_bytes",
                     "bytes resident in a bounded ingest stage buffer "
                     "(label: stage) — memory is bounded by "
                     "construction; this is the live occupancy"),
}

_GUARD_GAUGES = frozenset({"level", "lag", "buffer_bytes"})


HOST_FUSED_COUNTERS = (
    ("host_fused_phase_ns_total",
     "host_fused stage wall ns by in-kernel phase "
     "(radix|refine|regroup|fold|cms|prefilter|topk)"),
    ("host_fused_rows_total", "rows through the fused native dataplane"),
    ("host_fused_groups_total",
     "groups produced by the fused native dataplane"),
)

DEGRADED_GAUGE = (
    "native_path_degraded",
    "1 when a requested native dataplane feature fell back to the slow "
    "path (label: feature) — benchmarks must check this is 0",
)

BUILD_INFO = (
    "flow_build_info",
    "build/runtime identity (constant 1; labels pin the native "
    "capability set, trace mode, sketch backend, and mesh role)",
)


def register_guard_metrics() -> dict:
    """Register (or fetch) the guard families; idempotent."""
    return {key: (REGISTRY.gauge(*spec) if key in _GUARD_GAUGES
                  else REGISTRY.counter(*spec))
            for key, spec in GUARD_METRICS.items()}


def register_audit_metrics() -> dict:
    """Register (or fetch) the sketch-audit families; idempotent."""
    out = {}
    for key, spec in AUDIT_METRICS.items():
        if key == "error":
            out[key] = REGISTRY.histogram(*spec,
                                          buckets=ERROR_RATIO_BUCKETS)
        elif key in _AUDIT_GAUGES:
            out[key] = REGISTRY.gauge(*spec)
        else:
            out[key] = REGISTRY.counter(*spec)
    return out


def publish_build_info(native: str, hh_sketch: str,
                       sketch_backend: str = "device", role: str = "worker"):
    """Set the constant-1 identity gauge with the reference's labels: the
    role (worker, member or coordinator), the native capability set, the
    trace mode, the sketch backend (device | host) and the heavy-hitter
    family."""
    g = REGISTRY.gauge(*BUILD_INFO)
    g.set(1, role=role, native=native, trace=TRACER.mode,
          sketch=sketch_backend, hh_sketch=hh_sketch)
    return g
