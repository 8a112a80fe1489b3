"""murmur3 key hashing over uint32 word lanes, in torch.

Counterpart of flow_pipeline_tpu/schema/keys.py. torch has no ``+``,
``>>``, ``<<`` or ``%`` for ``uint32`` on every backend, so a u32 lane is
carried as an int64 holding a value in [0, 2^32). Products of two such
values would overflow int64, so ``mul32`` splits the constant into 16-bit
halves: each partial product stays below 2^48. The same bits come out on
the CPU and on the card, and they equal the JAX package's uint32
wraparound arithmetic.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_FMIX1 = 0x85EBCA6B
_FMIX2 = 0xC2B2AE35


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor -> int64 holding its low 32 bits as unsigned
    (an int32 bit pattern of a uint32 counter becomes its unsigned value)."""
    return x.to(torch.int64) & MASK32


def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 ``a`` in [0, 2^32) and a constant c."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer: full-avalanche 32-bit mix."""
    h = h ^ (h >> 16)
    h = mul32(h, _FMIX1)
    h = h ^ (h >> 13)
    h = mul32(h, _FMIX2)
    return h ^ (h >> 16)


def hash_words(words: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """murmur3_x86_32 over uint32 word lanes.

    words: [..., W] integer tensor (low 32 bits of each element are the
    word). Returns int64 [...] holding the uint32 hash.
    """
    w = as_u32(words)
    h = torch.full(w.shape[:-1], seed & MASK32, dtype=torch.int64,
                   device=w.device)
    nwords = w.shape[-1]
    for i in range(nwords):
        k = mul32(w[..., i], _C1)
        k = rotl32(k, 15)
        k = mul32(k, _C2)
        h = h ^ k
        h = rotl32(h, 13)
        h = (mul32(h, 5) + 0xE6546B64) & MASK32
    h = h ^ (nwords * 4)
    return fmix32(h)
