"""Aggregation models: flows_5m, the heavy-hitter table family, the dense
port tables and the DDoS detector."""

from .ddos import DDoSConfig, DDoSDetector, DDoSState
from .dense_top import DenseTopConfig, DenseTopKModel
from .heavy_hitter import HeavyHitterConfig, HeavyHitterModel, HHState
from .window_agg import WindowAggConfig, WindowAggregator

__all__ = ["DDoSConfig", "DDoSDetector", "DDoSState", "DenseTopConfig",
           "DenseTopKModel", "HeavyHitterConfig", "HeavyHitterModel",
           "HHState", "WindowAggConfig", "WindowAggregator"]
