"""Operator library with NaN-safe semantics, on torch tensors.

Counterpart of ``symbolicregression_jl_tpu/ops/operators.py``: the same
names, the same NaN-domain guards (invalid domains return NaN, never
raise), the same ``OperatorSet`` ordering (op index = position in the
operator list, so encoded trees carry across packages unchanged).

Binary operators are called ``fn(left, right)``: ``left`` is the second
stack entry and ``right`` the top, as in the reference interpreter.

The CUDA kernel (``csrc/postfix_eval.cu``) carries its own device function
for each name in ``KERNEL_UNARY_IDS`` / ``KERNEL_BINARY_IDS`` with the same
guards; names outside those tables run only on the plain path.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch

_NAN = float("nan")


def _where_nan(ok: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    return torch.where(ok, value, torch.full_like(value, _NAN))


def safe_pow(x, y):
    """x^y, NaN when x<0 with non-integer y, or x==0 with y<0."""
    bad = ((x < 0) & (y != torch.round(y))) | ((x == 0) & (y < 0))
    base = torch.where(bad, torch.ones_like(x), x)
    return _where_nan(~bad, torch.pow(base, y))


def safe_log(x):
    ok = x > 0
    return _where_nan(ok, torch.log(torch.where(ok, x, torch.ones_like(x))))


def safe_log2(x):
    ok = x > 0
    return _where_nan(ok, torch.log2(torch.where(ok, x, torch.ones_like(x))))


def safe_log10(x):
    ok = x > 0
    return _where_nan(ok, torch.log10(torch.where(ok, x, torch.ones_like(x))))


def safe_log1p(x):
    ok = x > -1
    return _where_nan(ok, torch.log1p(torch.where(ok, x, torch.zeros_like(x))))


def safe_sqrt(x):
    ok = x >= 0
    return _where_nan(ok, torch.sqrt(torch.where(ok, x, torch.zeros_like(x))))


def safe_acosh(x):
    ok = x >= 1
    return _where_nan(ok, torch.acosh(torch.where(ok, x, torch.ones_like(x))))


def safe_asin(x):
    return _where_nan(torch.abs(x) <= 1, torch.asin(torch.clamp(x, -1, 1)))


def safe_acos(x):
    return _where_nan(torch.abs(x) <= 1, torch.acos(torch.clamp(x, -1, 1)))


def atanh_clip(x):
    """atanh of x wrapped to (-1, 1)."""
    return torch.atanh(torch.remainder(x + 1.0, 2.0) - 1.0)


def gamma_op(x):
    """gamma(x) with poles -> NaN (reflection formula for x < 0)."""
    pos = torch.exp(torch.lgamma(x))
    neg = math.pi / (torch.sin(math.pi * x) * torch.exp(torch.lgamma(1.0 - x)))
    out = torch.where(x > 0, pos, neg)
    is_pole = (x <= 0) & (x == torch.round(x))
    return _where_nan(~is_pole & torch.isfinite(out), out)


def square(x):
    return x * x


def cube(x):
    return x * x * x


def neg(x):
    return -x


def relu(x):
    return torch.maximum(x, torch.zeros_like(x))


def greater(x, y):
    return (x > y).to(x.dtype)


def logical_or(x, y):
    return ((x > 0) | (y > 0)).to(x.dtype)


def logical_and(x, y):
    return ((x > 0) & (y > 0)).to(x.dtype)


def plus(x, y):
    return x + y


def sub(x, y):
    return x - y


def mult(x, y):
    return x * y


def div(x, y):
    return x / y


def mod_op(x, y):
    return torch.remainder(x, y)


def identity_op(x):
    return x


def sign(x):
    return torch.where(torch.isnan(x), x, torch.sign(x))


def gauss(x):
    return torch.exp(-(x * x))


def inv(x):
    return 1.0 / x


UNARY_REGISTRY: Dict[str, Callable] = {
    "cos": torch.cos,
    "sin": torch.sin,
    "tan": torch.tan,
    "exp": torch.exp,
    "log": safe_log,
    "log2": safe_log2,
    "log10": safe_log10,
    "log1p": safe_log1p,
    "sqrt": safe_sqrt,
    "abs": torch.abs,
    "square": square,
    "cube": cube,
    "neg": neg,
    "relu": relu,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "tanh": torch.tanh,
    "asin": safe_asin,
    "acos": safe_acos,
    "atan": torch.atan,
    "asinh": torch.asinh,
    "acosh": safe_acosh,
    "atanh": atanh_clip,
    "erf": torch.erf,
    "erfc": torch.erfc,
    "gamma": gamma_op,
    "sigmoid": torch.sigmoid,
    "gauss": gauss,
    "inv": inv,
    "sign": sign,
    "identity": identity_op,
}

BINARY_REGISTRY: Dict[str, Callable] = {
    "+": plus,
    "-": sub,
    "*": mult,
    "/": div,
    "^": safe_pow,
    "pow": safe_pow,
    "mod": mod_op,
    "max": torch.maximum,
    "min": torch.minimum,
    "greater": greater,
    "logical_or": logical_or,
    "logical_and": logical_and,
    "atan2": torch.atan2,
}

# Operators the CUDA kernel carries, by the id its switch dispatches on
# (csrc/postfix_eval.cu keeps the same numbers). 0/1/2 are PAD/CONST/VAR.
KERNEL_UNARY_IDS: Dict[str, int] = {
    "cos": 10, "sin": 11, "tan": 12, "exp": 13, "log": 14, "log2": 15,
    "log10": 16, "log1p": 17, "sqrt": 18, "abs": 19, "square": 20,
    "cube": 21, "neg": 22, "relu": 23, "sinh": 24, "cosh": 25, "tanh": 26,
    "sigmoid": 27, "inv": 28, "identity": 29, "sign": 30, "gauss": 31,
}
KERNEL_BINARY_IDS: Dict[str, int] = {
    "+": 40, "-": 41, "*": 42, "/": 43, "^": 44, "pow": 44, "max": 45,
    "min": 46,
}

# ---------------------------------------------------------------------------
# Closed-form derivatives of the kernel operators (the adjoint sweep of the
# loss+gradient kernel, csrc/postfix_grad.cu, computes the same forms)
# ---------------------------------------------------------------------------
# Each entry is the vector-Jacobian product of the JAX registry function:
# unary ``vjp(a, v, w) -> dL/da`` and binary ``vjp(b, a, v, w) -> (dL/db,
# dL/da)``, where ``a`` (and the left operand ``b``) are the operands, ``v``
# the operator's value and ``w`` the adjoint arriving at it. The forms are
# the lax JVP rules, so the guards and edges come out as ``jax.vjp`` gives
# them: a select (the NaN-domain guards, ``abs``) passes 0 whatever ``w``
# is, a product gives ``0 * inf = NaN``; ``max``/``min`` (hence ``relu``)
# split a tie 0.5/0.5; ``abs'(0) = 1``; ``sqrt'(+-0) = +-inf``; the
# exponent derivative of ``^`` uses log(1) at base 0; ``sign'`` is 0.

_LN2_F32 = float(torch.tensor(math.log(2.0), dtype=torch.float32))
_INV_LN10_F32 = float(torch.tensor(1.0 / math.log(10.0), dtype=torch.float32))


def _sel(cond, x):
    return torch.where(cond, x, torch.zeros_like(x))


def _balanced_eq(x, z, y):
    """1 where x alone reaches the max/min z, 0.5 on a tie, else 0."""
    one = torch.ones_like(z)
    return torch.where(x == z, torch.where(y == z, 0.5 * one, one), 0.0 * one)


def _pow_vjp(b, a, v, w):
    bad = ((b < 0) & (a != torch.round(a))) | ((b == 0) & (a < 0))
    base = torch.where(bad, torch.ones_like(b), b)
    g = _sel(~bad, w)
    db = _sel(~bad, g * (a * torch.pow(base, a - 1.0)))
    da = g * (torch.log(torch.where(base == 0, torch.ones_like(base), base))
              * torch.pow(base, a))
    return db, da


UNARY_VJP: Dict[str, Callable] = {
    "cos": lambda a, v, w: -(w * torch.sin(a)),
    "sin": lambda a, v, w: w * torch.cos(a),
    "tan": lambda a, v, w: w * (1.0 + v * v),
    "exp": lambda a, v, w: w * v,
    "log": lambda a, v, w: _sel(a > 0, w / a),
    "log2": lambda a, v, w: _sel(a > 0, (w / _LN2_F32) / a),
    "log10": lambda a, v, w: _sel(a > 0, (w * _INV_LN10_F32) / a),
    "log1p": lambda a, v, w: _sel(a > -1, w / (a + 1.0)),
    "sqrt": lambda a, v, w: _sel(a >= 0, w * (0.5 / v)),
    "abs": lambda a, v, w: torch.where(a >= 0, w, -w),
    "square": lambda a, v, w: 2.0 * (w * a),
    "cube": lambda a, v, w: (a * a) * w + 2.0 * ((w * a) * a),
    "neg": lambda a, v, w: -w,
    "relu": lambda a, v, w: w * _balanced_eq(a, v, torch.zeros_like(a)),
    "sinh": lambda a, v, w: w * torch.cosh(a),
    "cosh": lambda a, v, w: w * torch.sinh(a),
    "tanh": lambda a, v, w: (w + w * v) * (1.0 - v),
    "sigmoid": lambda a, v, w: w * (v * (1.0 - v)),
    "inv": lambda a, v, w: -w * (1.0 / (a * a)),
    "identity": lambda a, v, w: w,
    "sign": lambda a, v, w: torch.zeros_like(w),
    "gauss": lambda a, v, w: -2.0 * ((w * v) * a),
}

BINARY_VJP: Dict[str, Callable] = {
    "+": lambda b, a, v, w: (w, w),
    "-": lambda b, a, v, w: (w, -w),
    "*": lambda b, a, v, w: (w * a, b * w),
    "/": lambda b, a, v, w: (w / a, (-w * b) * (1.0 / (a * a))),
    "^": _pow_vjp,
    "pow": _pow_vjp,
    "max": lambda b, a, v, w: (w * _balanced_eq(b, v, a), w * _balanced_eq(a, v, b)),
    "min": lambda b, a, v, w: (w * _balanced_eq(b, v, a), w * _balanced_eq(a, v, b)),
}

_ALIASES = {
    "plus": "+",
    "sub": "-",
    "mult": "*",
    "div": "/",
    "safe_pow": "^",
    "safe_log": "log",
    "safe_log2": "log2",
    "safe_log10": "log10",
    "safe_log1p": "log1p",
    "safe_sqrt": "sqrt",
    "safe_acosh": "acosh",
    "atanh_clip": "atanh",
}

INFIX = {"+", "-", "*", "/", "^"}


def canonical_name(name: str) -> str:
    return _ALIASES.get(name, name)


@dataclasses.dataclass(frozen=True)
class OperatorSet:
    """Ordered unary and binary operator tables; tree nodes store indices
    into these lists."""

    unary_names: Tuple[str, ...]
    binary_names: Tuple[str, ...]

    @property
    def unary_fns(self) -> List[Callable]:
        return [UNARY_REGISTRY[n] for n in self.unary_names]

    @property
    def binary_fns(self) -> List[Callable]:
        return [BINARY_REGISTRY[n] for n in self.binary_names]

    @property
    def n_unary(self) -> int:
        return len(self.unary_names)

    @property
    def n_binary(self) -> int:
        return len(self.binary_names)

    def unary_index(self, name: str) -> int:
        return self.unary_names.index(canonical_name(name))

    def binary_index(self, name: str) -> int:
        return self.binary_names.index(canonical_name(name))


def make_operator_set(
    binary_operators: Sequence[str] = ("+", "-", "*", "/"),
    unary_operators: Sequence[str] = (),
) -> OperatorSet:
    bins = tuple(canonical_name(b) for b in binary_operators)
    unas = tuple(canonical_name(u) for u in unary_operators)
    for b in bins:
        if b not in BINARY_REGISTRY:
            raise ValueError(f"Unknown binary operator {b!r}")
    for u in unas:
        if u not in UNARY_REGISTRY:
            raise ValueError(f"Unknown unary operator {u!r}")
    if set(bins) & set(unas):
        raise ValueError("Operators cannot be both unary and binary")
    if len(set(bins)) != len(bins) or len(set(unas)) != len(unas):
        raise ValueError("Duplicate operators")
    return OperatorSet(unary_names=unas, binary_names=bins)
