"""Count-min sketch ops, in plain PyTorch.

Counterpart of flow_pipeline_tpu/ops/cms.py, same layout and bucket
scheme: ``counts`` is [planes, depth, width] float32, and depth row d
hashes a key's uint32 word lanes with murmur3 seed d, bucket =
hash % width (unsigned).

The two updates here are the plain versions of the port's kernels. The
conservative one is the yardstick of ``ops/cms_cuda.py``'s CUDA kernel
(the tests on the CPU and ``chip_smoke.py`` on the card hold the kernel
to it) and serves CPU tensors; a CUDA tensor on the main path never
reaches it. Unlike the functional JAX ops, both updates write ``counts``
IN PLACE and return it.
"""

from __future__ import annotations

import torch

from ..schema.keys import hash_words


def cms_init(planes: int, depth: int, width: int,
             device: str | torch.device = "cuda") -> torch.Tensor:
    """Fresh sketch."""
    return torch.zeros((planes, depth, width), dtype=torch.float32,
                       device=device)


def cms_buckets(keys: torch.Tensor, depth: int, width: int) -> torch.Tensor:
    """Per-depth bucket indices for [N, W] key lanes: [depth, N] int64 in
    [0, width). Seeds 0..depth-1 give independent rows."""
    return torch.stack([hash_words(keys, seed=d) % width
                        for d in range(depth)], dim=0)


def cms_add(counts: torch.Tensor, keys: torch.Tensor, values: torch.Tensor,
            valid=None) -> torch.Tensor:
    """Linear (mergeable) update with pre-aggregated per-key values, in
    place: counts[:, d, b_d(key)] += values for every depth row d.

    counts [P, D, W] float32, keys [N, W_k] lanes, values [N, P],
    valid [N] bool (invalid rows add nothing)."""
    p, d, w = counts.shape
    buckets = cms_buckets(keys, d, w)
    vals = values.to(torch.float32)
    if valid is not None:
        vals = torch.where(valid[:, None], vals, 0.0)
    vals_t = vals.T.contiguous()  # [P, N]
    for di in range(d):
        counts[:, di].index_add_(1, buckets[di], vals_t)
    return counts


def cms_query(counts: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Point estimate, min over depth rows: [N, P] float32."""
    p, d, w = counts.shape
    buckets = cms_buckets(keys, d, w)
    ests = torch.stack([counts[:, di, buckets[di]] for di in range(d)])
    return ests.amin(dim=0).T  # [N, P]


def cms_add_conservative(counts: torch.Tensor, keys: torch.Tensor,
                         values: torch.Tensor, valid=None) -> torch.Tensor:
    """Conservative update, in place: with target = (estimate from the
    PRE-update sketch) + value, every cell a key hashes to is raised to the
    max target of its keys and never lowered. Invalid rows get target 0,
    which is inert (cells are >= 0). Keys must be unique within the call.
    """
    p, d, w = counts.shape
    buckets = cms_buckets(keys, d, w)
    est = torch.stack([counts[:, di, buckets[di]] for di in range(d)])
    target = est.amin(dim=0).T + values.to(torch.float32)  # [N, P]
    if valid is not None:
        target = torch.where(valid[:, None], target, 0.0)
    target_t = target.T.contiguous()  # [P, N]
    for di in range(d):
        idx = buckets[di].expand(p, -1)
        counts[:, di].scatter_reduce_(1, idx, target_t, "amax")
    return counts
