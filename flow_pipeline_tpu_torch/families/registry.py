"""The SketchFamily registry: one descriptor per sketch family.

Counterpart of flow_pipeline_tpu/families/registry.py, only the part the
port's host sketch pipeline reads: ``SketchFamily``, ``register``,
``family`` and ``resolve``, and the four registrations (hh, wagg, dense,
spread) with their identity tags, merge monoids, checkpoint hooks and
native probes. Hooks are "module:attr" strings resolved lazily, which
keeps this module free of import cycles. The reference's mesh, serve,
gateway and audit surfaces of a family are not ported and not declared
here.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Any, Optional


@dataclass(frozen=True)
class SketchFamily:
    """The per-kind facts of one sketch family that the port uses."""

    kind: str                              # the family's kind tag
    snapshot_kind: Optional[str] = None    # model.snapshot_kind tag
    checkpoint_kind: Optional[str] = None  # tag in worker checkpoints
    merge_monoid: Optional[str] = None     # "u64-sum" | "max" | "i64-sum"
    ranked: bool = True                    # has a top-K surface
    state_attr: Optional[str] = None       # model attr holding its state
    checkpoint_save: Optional[str] = None     # "module:attr": model -> dict
    checkpoint_restore: Optional[str] = None  # "module:attr": dict -> model
    # (feature, C symbol, since) triples the host sketch pipeline probes
    # at start-up: a serving feature publishes native_path_degraded 0
    native_probes: tuple = ()
    flag_namespace: Optional[str] = None   # the family's flag prefix


FAMILIES: dict[str, SketchFamily] = {}
_RESOLVED: dict[str, Any] = {}


def register(fam: SketchFamily) -> SketchFamily:
    if fam.kind in FAMILIES:
        raise ValueError(f"sketch family {fam.kind!r} registered twice")
    FAMILIES[fam.kind] = fam
    return fam


def family(kind: str) -> SketchFamily:
    try:
        return FAMILIES[kind]
    except KeyError:
        raise KeyError(f"unknown sketch family kind {kind!r} (registered: "
                       f"{sorted(FAMILIES)})") from None


def resolve(ref: str) -> Any:
    """Import and cache a "module:attr" hook reference."""
    hit = _RESOLVED.get(ref)
    if hit is None:
        mod, _, attr = ref.partition(":")
        hit = getattr(importlib.import_module(mod), attr)
        _RESOLVED[ref] = hit
    return hit


register(SketchFamily(
    kind="hh",
    snapshot_kind="windowed_hh",
    checkpoint_kind="windowed_hh",
    merge_monoid="u64-sum",
    ranked=True,
    state_attr="state",
    checkpoint_save="flow_pipeline_tpu_torch.engine.worker:save_hh_state",
    checkpoint_restore=(
        "flow_pipeline_tpu_torch.engine.worker:restore_hh_state"),
    native_probes=(("fused", "fpt_ff_fused_update", "r10"),
                   ("invsketch", "fpt_hs_inv_update", "r16")),
    flag_namespace="hh.",
))

register(SketchFamily(
    kind="wagg",
    snapshot_kind=None,
    checkpoint_kind="window_agg",
    merge_monoid="u64-sum",
    ranked=False,
    state_attr=None,
    checkpoint_save="flow_pipeline_tpu_torch.engine.worker:save_wagg_state",
    checkpoint_restore=(
        "flow_pipeline_tpu_torch.engine.worker:restore_wagg_state"),
    native_probes=(),
    flag_namespace="window.",
))

register(SketchFamily(
    kind="dense",
    snapshot_kind="windowed_dense",
    checkpoint_kind="windowed_dense",
    merge_monoid="i64-sum",
    ranked=True,
    state_attr="totals",
    checkpoint_save=(
        "flow_pipeline_tpu_torch.engine.worker:save_dense_state"),
    checkpoint_restore=(
        "flow_pipeline_tpu_torch.engine.worker:restore_dense_state"),
    native_probes=(),
    flag_namespace="sketch.",
))

register(SketchFamily(
    kind="spread",
    snapshot_kind="windowed_spread",
    checkpoint_kind="windowed_spread",
    merge_monoid="max",
    ranked=True,
    state_attr="state",
    checkpoint_save=(
        "flow_pipeline_tpu_torch.engine.worker:save_spread_state"),
    checkpoint_restore=(
        "flow_pipeline_tpu_torch.engine.worker:restore_spread_state"),
    native_probes=(("spread", "fpt_hs_spread_update", "r21"),),
    flag_namespace="spread.",
))
