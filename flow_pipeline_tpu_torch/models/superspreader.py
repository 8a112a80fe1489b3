"""Superspreader detector preset: src addr -> distinct dst addrs.

Counterpart of flow_pipeline_tpu/models/superspreader.py: a source that
touches an anomalous number of distinct destinations (worm propagation,
scanning, spam) is invisible to the volume sketches. This module wires
the spread family (models/spread.py) to that key and element, the window
wrapper and the detector's metric label.
"""

from __future__ import annotations

from ..device import DEFAULT_DEVICE
from .oracle import SECONDS_PER_SLOT
from .spread import SpreadConfig, SpreadModel

# the detector's model name: the ``model`` label on spread_top_max and
# the worker's model key
SUPERSPREADER_MODEL = "superspreaders"


def superspreader_config(depth: int = 2, width: int = 1 << 12,
                         registers: int = 64, capacity: int = 512,
                         batch_size: int = 8192) -> SpreadConfig:
    """src_addr -> distinct dst_addr (2 x 4096 buckets x 64 registers:
    512 KiB, about 1.04/sqrt(64) = 13 % standard error past the
    linear-counting range)."""
    return SpreadConfig(
        key_cols=("src_addr",), elem_col="dst_addr", depth=depth,
        width=width, registers=registers, capacity=capacity,
        batch_size=batch_size)


def superspreader_model(config: SpreadConfig | None = None,
                        window_seconds: int = SECONDS_PER_SLOT,
                        k: int = 64, device=DEFAULT_DEVICE):
    """The windowed detector: a WindowedHeavyHitter over SpreadModel with
    the alert gauge labelled for this detector."""
    from ..engine.windowed import WindowedHeavyHitter

    whh = WindowedHeavyHitter(config or superspreader_config(),
                              window_seconds=window_seconds, k=k,
                              model_cls=SpreadModel, device=device)
    whh.model.metric_label = SUPERSPREADER_MODEL
    return whh
