"""Fused multiply-adds rounded once, in torch ops that run on any device.

Two plain versions need them: ``utils/rng.py``'s uniform epilogue, which
XLA's CPU code contracts into an FMA instruction, and
``ops/kernel_eval.py``'s mirror of B2's fused L2 sum, which nvcc contracts
into one. torch has no FMA of its own, so the product is split exactly
(it fits float64 for float32 operands; Dekker's product for float64) and
the sum is rounded to odd before the last rounding.
"""

from __future__ import annotations

import torch


def _round_to_odd(s: torch.Tensor, err: torch.Tensor) -> torch.Tensor:
    """``s`` (float64, the rounded sum) with its last bit set where the
    exact sum was not ``s``: rounding that to a narrower format rounds the
    exact sum once."""
    bits = s.view(torch.int64)
    nudge = (err != 0) & ((bits & 1) == 0)
    up = (err > 0) == (s > 0)
    return torch.where(nudge, torch.where(up, bits + 1, bits - 1),
                       bits).view(torch.float64)


def _two_sum(a: torch.Tensor, b: torch.Tensor):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _wide(t):
    """A tensor in float64, or a Python float (exact in float64) as it is."""
    return t.double() if isinstance(t, torch.Tensor) else float(t)


def fma32(a, b, c) -> torch.Tensor:
    """A float32 fused multiply-add, rounded once. ``a`` is a float32
    tensor; ``b`` and ``c`` tensors or float32 values."""
    s, err = _two_sum(_wide(a) * _wide(b), _wide(c))  # the product is exact
    return _round_to_odd(s, err).float()


def _two_prod(a: torch.Tensor, b: torch.Tensor):
    """a * b as an exact float64 pair (Dekker's product)."""
    def halves(x):
        t = x * 134217729.0  # 2^27 + 1
        hi = t - (t - x)
        return hi, x - hi
    p = a * b
    ah, al = halves(a)
    bh, bl = halves(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def fma64(a, b, c) -> torch.Tensor:
    """A float64 fused multiply-add, rounded once (Boldo and Melquiond's
    emulation: the low parts summed with rounding to odd). ``a`` is a
    float64 tensor; ``b`` and ``c`` tensors or floats."""
    ph, pl = _two_prod(a, b if isinstance(b, torch.Tensor)
                       else torch.full_like(a, b))
    th, tl = _two_sum(c if isinstance(c, torch.Tensor)
                      else torch.full_like(a, c), ph)
    v, verr = _two_sum(tl, pl)
    return th + _round_to_odd(v, verr)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once, for float32 or float64 tensors of one
    shape."""
    return (fma64 if a.dtype == torch.float64 else fma32)(a, b, c)
