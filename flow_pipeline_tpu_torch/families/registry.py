"""The SketchFamily registry: one descriptor per sketch family.

Counterpart of flow_pipeline_tpu/families/registry.py, the part the
port's layers read: ``SketchFamily``, ``register``, the lookups by kind,
snapshot kind and payload kind, ``resolve`` and ``hook``, and the four
registrations (hh, wagg, dense, spread) with their identity tags, merge
monoids, payload, merge and row hooks (mesh/codec.py, mesh/merge.py),
serve capture hooks (serve/publisher.py), gateway delta planes
(gateway/delta.py), audit attributes, checkpoint hooks and native
probes. Hooks are "module:attr" strings resolved lazily, which keeps
this module free of import cycles. The reference's merged-view serve
capture (``serve_capture_merged``) waits for the mesh's serving tier and
is not declared here.
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
    payload_kinds: tuple = ()              # mesh codec payload["kind"] tags
    merge_monoid: Optional[str] = None     # "u64-sum" | "max" | "i64-sum"
    ranked: bool = True                    # has a top-K surface
    state_attr: Optional[str] = None       # model attr holding its state
    payload: Optional[str] = None          # "module:attr": state -> payload
    merge: Optional[str] = None            # "module:attr": payloads -> merged
    top_rows: Optional[str] = None         # "module:attr": merged -> rows
    serve_capture: Optional[str] = None    # "module:attr": FamilyView parts
    checkpoint_save: Optional[str] = None     # "module:attr": model -> dict
    checkpoint_restore: Optional[str] = None  # "module:attr": dict -> model
    # (snapshot-state key, planes-first?) per plane array the gateway's
    # delta coder diffs; planes-first marks a lanes-last array ([D, W, m]
    # registers) viewed plane-major for the diff
    delta_planes: tuple = ()
    audit_attr: Optional[str] = None       # host-grouped pipeline attribute
    # (feature, C symbol, since) triples the host sketch pipeline probes
    # at start-up: a serving feature publishes native_path_degraded 0
    native_probes: tuple = ()
    flag_namespace: Optional[str] = None   # the family's flag prefix


FAMILIES: dict[str, SketchFamily] = {}
_BY_SNAPSHOT: dict[str, SketchFamily] = {}
_BY_PAYLOAD: dict[str, SketchFamily] = {}
_RESOLVED: dict[str, Any] = {}


def register(fam: SketchFamily) -> SketchFamily:
    if fam.kind in FAMILIES:
        raise ValueError(f"sketch family {fam.kind!r} registered twice")
    FAMILIES[fam.kind] = fam
    if fam.snapshot_kind:
        _BY_SNAPSHOT[fam.snapshot_kind] = fam
    for pk in fam.payload_kinds:
        _BY_PAYLOAD[pk] = fam
    return fam


def family(kind: str) -> SketchFamily:
    try:
        return FAMILIES[kind]
    except KeyError:
        raise KeyError(f"unknown sketch family kind {kind!r} (registered: "
                       f"{sorted(FAMILIES)})") from None


def family_for_snapshot(snapshot_kind: str) -> Optional[SketchFamily]:
    """The family owning a ``model.snapshot_kind`` tag, else None."""
    return _BY_SNAPSHOT.get(snapshot_kind)


def family_for_payload(payload_kind: str) -> Optional[SketchFamily]:
    return _BY_PAYLOAD.get(payload_kind)


def resolve(ref: str) -> Any:
    """Import and cache a "module:attr" hook reference."""
    hit = _RESOLVED.get(ref)
    if hit is None:
        mod, _, attr = ref.partition(":")
        hit = getattr(importlib.import_module(mod), attr)
        _RESOLVED[ref] = hit
    return hit


def hook(fam: SketchFamily, name: str) -> Any:
    """The resolved hook of one family field, or None when the family
    does not take part in that surface."""
    ref = getattr(fam, name)
    return resolve(ref) if ref else None


def audit_attrs() -> tuple[tuple[str, str], ...]:
    """(kind, host-grouped pipeline attribute) of every family with a
    shadow auditor."""
    return tuple((f.kind, f.audit_attr) for f in FAMILIES.values()
                 if f.audit_attr)


def delta_planes(payload_kind: str) -> tuple:
    """The gateway delta's plane specs of one snapshot family kind; ()
    for an unregistered kind (the delta then ships it whole)."""
    fam = _BY_PAYLOAD.get(payload_kind)
    return fam.delta_planes if fam else ()


register(SketchFamily(
    kind="hh",
    snapshot_kind="windowed_hh",
    checkpoint_kind="windowed_hh",
    payload_kinds=("hh", "hh_inv"),
    merge_monoid="u64-sum",
    ranked=True,
    state_attr="state",
    payload="flow_pipeline_tpu_torch.mesh.codec:hh_payload",
    merge="flow_pipeline_tpu_torch.mesh.merge:merge_hh",
    top_rows="flow_pipeline_tpu_torch.mesh.merge:hh_top_rows",
    serve_capture="flow_pipeline_tpu_torch.serve.publisher:hh_view_parts",
    checkpoint_save="flow_pipeline_tpu_torch.engine.worker:save_hh_state",
    checkpoint_restore=(
        "flow_pipeline_tpu_torch.engine.worker:restore_hh_state"),
    delta_planes=(("cms", False),),
    audit_attr="audit",
    native_probes=(("fused", "fpt_ff_fused_update", "r10"),
                   ("invsketch", "fpt_hs_inv_update", "r16")),
    flag_namespace="hh.",
))

register(SketchFamily(
    kind="wagg",
    snapshot_kind=None,
    checkpoint_kind="window_agg",
    payload_kinds=("wagg",),
    merge_monoid="u64-sum",
    ranked=False,
    state_attr=None,
    payload="flow_pipeline_tpu_torch.mesh.codec:wagg_payload",
    merge="flow_pipeline_tpu_torch.mesh.merge:merge_wagg",
    top_rows="flow_pipeline_tpu_torch.models.window_agg:wagg_rows",
    serve_capture=None,
    checkpoint_save="flow_pipeline_tpu_torch.engine.worker:save_wagg_state",
    checkpoint_restore=(
        "flow_pipeline_tpu_torch.engine.worker:restore_wagg_state"),
    delta_planes=(),
    native_probes=(),
    flag_namespace="window.",
))

register(SketchFamily(
    kind="dense",
    snapshot_kind="windowed_dense",
    checkpoint_kind="windowed_dense",
    payload_kinds=("dense",),
    merge_monoid="i64-sum",
    ranked=True,
    state_attr="totals",
    payload="flow_pipeline_tpu_torch.mesh.codec:dense_payload",
    merge="flow_pipeline_tpu_torch.mesh.merge:merge_dense",
    top_rows="flow_pipeline_tpu_torch.mesh.merge:dense_top_rows",
    serve_capture=(
        "flow_pipeline_tpu_torch.serve.publisher:dense_view_parts"),
    checkpoint_save=(
        "flow_pipeline_tpu_torch.engine.worker:save_dense_state"),
    checkpoint_restore=(
        "flow_pipeline_tpu_torch.engine.worker:restore_dense_state"),
    delta_planes=(),
    native_probes=(),
    flag_namespace="sketch.",
))

register(SketchFamily(
    kind="spread",
    snapshot_kind="windowed_spread",
    checkpoint_kind="windowed_spread",
    payload_kinds=("spread",),
    merge_monoid="max",
    ranked=True,
    state_attr="state",
    payload="flow_pipeline_tpu_torch.mesh.codec:spread_payload",
    merge="flow_pipeline_tpu_torch.mesh.merge:merge_spread",
    top_rows="flow_pipeline_tpu_torch.mesh.merge:spread_top_rows",
    serve_capture=(
        "flow_pipeline_tpu_torch.serve.publisher:spread_view_parts"),
    checkpoint_save=(
        "flow_pipeline_tpu_torch.engine.worker:save_spread_state"),
    checkpoint_restore=(
        "flow_pipeline_tpu_torch.engine.worker:restore_spread_state"),
    delta_planes=(("regs", True),),
    audit_attr="spread_audit",
    native_probes=(("spread", "fpt_hs_spread_update", "r21"),),
    flag_namespace="spread.",
))
