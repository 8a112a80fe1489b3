"""Aggregation models (the heavy-hitter table family so far)."""

from .heavy_hitter import HeavyHitterConfig, HeavyHitterModel, HHState

__all__ = ["HeavyHitterConfig", "HeavyHitterModel", "HHState"]
