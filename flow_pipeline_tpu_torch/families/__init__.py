"""The sketch family registry (see registry.py)."""

from .registry import (FAMILIES, SketchFamily, audit_attrs, delta_planes,
                       family, family_for_payload, family_for_snapshot,
                       hook, register, resolve)

__all__ = ["FAMILIES", "SketchFamily", "audit_attrs", "delta_planes",
           "family", "family_for_payload", "family_for_snapshot", "hook",
           "register", "resolve"]
