"""float32 math evaluated the way the reference's CPU backend evaluates it.

Two pieces of the DDoS detector's arithmetic are not pinned by IEEE
rounding alone:

- ``log``: XLA's CPU backend does not call libm. It inlines the Cephes
  polynomial (range reduction to [sqrt(1/2), sqrt(2)), a degree-8
  polynomial, ln 2 split in two parts) and LLVM contracts its
  multiply-adds into fused ones. That result differs from a correctly
  rounded log (torch's CPU kernel, CUDA's ``logf``) by an ulp on about
  0.6 % of float32 inputs, and an ulp near ``gamma^k`` moves a value to
  the next quantile bucket.
- fused multiply-adds: the same contraction turns ``m + a * d`` into
  one rounding, where two torch ops round twice.
- ``sqrt``: the reference's is correctly rounded; torch's vectorized CPU
  kernel is not always (an ulp off on about 0.6 % of inputs).

``log_f32``, ``fma32`` and ``sqrt32`` reproduce these with plain torch
ops, so the same bits come out on the CPU and on the card. ``fma32`` is exact: the
product of two float32 values is exact in float64, the float64 sum is
rounded to odd (its error found by TwoSum), and the final cast to float32
then rounds once, as a hardware fused multiply-add does.
"""

from __future__ import annotations

import torch

# Cephes logf coefficients, as the reference's backend emits them
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1 = -2.12194440e-4  # ln 2 = _LOG_Q2 + _LOG_Q1 (approximately)
_LOG_Q2 = 0.693359375
_SQRT_HALF = 0.707106781186547524
_MIN_NORMAL = 1.1754943508222875e-38  # 0x00800000


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c with ONE float32 rounding. ``b`` and ``c`` may be python
    floats (taken as float32 constants)."""
    a64 = a.to(torch.float64)
    b64 = torch.as_tensor(b, dtype=torch.float32, device=a.device).to(
        torch.float64)
    c64 = torch.as_tensor(c, dtype=torch.float32, device=a.device).to(
        torch.float64)
    p = a64 * b64  # exact: 24 + 24 bits fit the 53-bit significand
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)  # TwoSum: s + err == p + c exactly
    # round to odd: an inexact sum with an even significand moves one
    # ulp toward the exact value, so the float32 cast cannot round twice
    inexact_even = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(s.dtype)
    s = torch.where(inexact_even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def sqrt32(v: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root: the float64 root of a
    float32 value rounds to float32 without a double-rounding error."""
    return torch.sqrt(v.to(torch.float64)).to(torch.float32)


def log_f32(v: torch.Tensor) -> torch.Tensor:
    """Natural log of positive finite float32 values, bit-equal to the
    reference's CPU backend (zero, negative, inf and NaN inputs are not
    handled: callers clamp)."""
    v = torch.clamp(v.to(torch.float32), min=_MIN_NORMAL)
    bits = v.view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & 0x807FFFFF) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    small = m < _SQRT_HALF
    x = (m - 1.0) + torch.where(small, m, 0.0)  # [sqrt(1/2)-1, sqrt(2)-1)
    e = e - small.to(torch.float32)
    x2 = x * x
    x3 = x2 * x
    p = _LOG_P
    y = fma32(fma32(x, p[0], p[1]), x, p[2])
    y1 = fma32(fma32(x, p[3], p[4]), x, p[5])
    y2 = fma32(fma32(x, p[6], p[7]), x, p[8])
    y = fma32(fma32(y, x3, y1), x3, y2)
    q1 = torch.tensor(_LOG_Q1, dtype=torch.float32, device=v.device)
    y = fma32(y, x3, e * q1)
    x = fma32(x2, -0.5, x)
    return fma32(e, _LOG_Q2, x + y)
