"""Log-bucket quantile histogram (DDSketch-flavored), in torch.

Counterpart of flow_pipeline_tpu/ops/quantile.py: relative-error
quantiles over non-negative values as a fixed [B] float32 counter array;
value v lands in bucket ceil(log(v) / log(gamma)) + 1, clamped, with
[0, 1] in bucket 1 and zeros in bucket 0. Updating is a scatter-add and
querying a cumulative sum on the host.

Bucket ids must equal the reference's bit for bit: an id one off near
``gamma^k`` moves the DDoS alert gate. So the log is ops/f32math.py
log_f32 (the reference's CPU formula, not torch.log), and the division by
the constant log(gamma) is a multiplication by its float32 reciprocal, as
the reference's compiler rewrites it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .f32math import log_f32


class QuantileSketchSpec:
    """Static parameters: relative error -> gamma and bucket count."""

    def __init__(self, rel_err: float = 0.01, max_value: float = 1e12,
                 n_buckets: int | None = None):
        self.rel_err = rel_err
        self.gamma = (1 + rel_err) / (1 - rel_err)
        self.log_gamma = math.log(self.gamma)
        # bucket 0 holds zeros, bucket 1 (0, 1]; buckets 2.. log ranges
        need = int(math.ceil(math.log(max_value) / self.log_gamma)) + 2
        self.n_buckets = n_buckets or need
        self._inv_log_gamma = float(np.float32(1.0) /
                                    np.float32(self.log_gamma))

    def init(self, device="cpu") -> torch.Tensor:
        return torch.zeros(self.n_buckets, dtype=torch.float32,
                           device=device)

    def bucket_of(self, values: torch.Tensor) -> torch.Tensor:
        """[N] values -> [N] int64 bucket ids."""
        values = values.to(torch.float32)
        v = torch.clamp(values, min=1e-9)
        inv = torch.tensor(self._inv_log_gamma, dtype=torch.float32,
                           device=values.device)
        idx = torch.ceil(log_f32(v) * inv).to(torch.int64) + 1
        idx = torch.where(values <= 1.0, 1, idx)  # (0, 1] -> bucket 1
        idx = torch.where(values <= 0.0, 0, idx)  # zeros -> bucket 0
        return torch.clamp(idx, 0, self.n_buckets - 1)

    def add(self, hist: torch.Tensor, values: torch.Tensor, weights=None,
            valid=None) -> torch.Tensor:
        w = (torch.ones_like(values, dtype=torch.float32) if weights is None
             else weights.to(torch.float32))
        if valid is not None:
            w = torch.where(valid, w, 0.0)
        return hist.index_add(0, self.bucket_of(values), w)

    def value_of_bucket(self, idx):
        """Representative (upper-bound) value of bucket idx (numpy)."""
        idx = np.asarray(idx)
        val = self.gamma ** (idx.astype(np.float64) - 1)
        return np.where(idx <= 0, 0.0, np.where(idx == 1, 1.0, val))

    def quantile(self, hist, q: float) -> float:
        """Host-side quantile: smallest bucket value covering q mass."""
        h = np.asarray(hist, dtype=np.float64)
        total = h.sum()
        if total <= 0:
            return 0.0
        cum = np.cumsum(h)
        idx = int(np.searchsorted(cum, q * total, side="left"))
        idx = min(idx, self.n_buckets - 1)
        return float(self.value_of_bucket(np.array([idx]))[0])
