"""The guard: end-to-end backpressure and deterministic overload shedding.

Counterpart of flow_pipeline_tpu/guard; see :mod:`.controller`.
"""

from .controller import (GUARD_METRICS, GUARD_SAMPLE_SEED, GuardConfig,
                         GuardController, admission_mask, flow_key_lanes,
                         register_guard_metrics)

__all__ = [
    "GUARD_METRICS",
    "GUARD_SAMPLE_SEED",
    "GuardConfig",
    "GuardController",
    "admission_mask",
    "flow_key_lanes",
    "register_guard_metrics",
]
