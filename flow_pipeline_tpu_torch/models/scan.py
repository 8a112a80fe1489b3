"""Port-scan detector preset: src addr -> distinct dst ports.

Counterpart of flow_pipeline_tpu/models/scan.py: a vertical port scan
touches many distinct destination ports at almost no volume per port,
the inverse of what the byte and packet sketches rank. This module wires
the spread family (models/spread.py) to that key and element, the window
wrapper and the detector's metric label.
"""

from __future__ import annotations

from ..device import DEFAULT_DEVICE
from .oracle import SECONDS_PER_SLOT
from .spread import SpreadConfig, SpreadModel

# the detector's model name: the ``model`` label on spread_top_max and
# the worker's model key
SCAN_MODEL = "portscan"


def scan_config(depth: int = 2, width: int = 1 << 12,
                registers: int = 64, capacity: int = 512,
                batch_size: int = 8192) -> SpreadConfig:
    """src_addr -> distinct dst_port. The element space is 2^16, so most
    keys stay in the linear-counting range; the sizing matches the
    superspreader preset."""
    return SpreadConfig(
        key_cols=("src_addr",), elem_col="dst_port", depth=depth,
        width=width, registers=registers, capacity=capacity,
        batch_size=batch_size)


def scan_model(config: SpreadConfig | None = None,
               window_seconds: int = SECONDS_PER_SLOT,
               k: int = 64, device=DEFAULT_DEVICE):
    """The windowed detector: a WindowedHeavyHitter over SpreadModel with
    the alert gauge labelled for this detector."""
    from ..engine.windowed import WindowedHeavyHitter

    whh = WindowedHeavyHitter(config or scan_config(),
                              window_seconds=window_seconds, k=k,
                              model_cls=SpreadModel, device=device)
    whh.model.metric_label = SCAN_MODEL
    return whh
