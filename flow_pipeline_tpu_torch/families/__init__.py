"""The sketch family registry, the part the host sketch pipeline reads
(see registry.py)."""

from .registry import FAMILIES, SketchFamily, family, register, resolve

__all__ = ["FAMILIES", "SketchFamily", "family", "register", "resolve"]
