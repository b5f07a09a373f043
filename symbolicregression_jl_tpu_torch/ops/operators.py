"""Operator library with NaN-safe semantics, on torch tensors.

Counterpart of ``symbolicregression_jl_tpu/ops/operators.py``: the same
names, the same NaN-domain guards (invalid domains return NaN, never
raise), the same ``OperatorSet`` ordering (op index = position in the
operator list, so encoded trees carry across packages unchanged).

Binary operators are called ``fn(left, right)``: ``left`` is the second
stack entry and ``right`` the top, as in the reference interpreter.

The CUDA kernels carry one device function for every name of the two
registries, with the same guards, in one header (``csrc/operators.cuh``),
under the ids of ``KERNEL_UNARY_IDS`` / ``KERNEL_BINARY_IDS``; each
operator's closed-form derivative is in ``UNARY_VJP`` / ``BINARY_VJP``
here and in the header.

``register_unary`` / ``register_binary`` add an operator of the user's own
(an elementwise torch callable), or replace a registry one. Such a "user
operator" (``is_user_operator``) runs as its callable on the CPU, with
``torch.func.vjp`` of it as its derivative (``vjp_of``); on the card the
kernels run device code generated from its trace (``ops/user_ops.py``).
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
    return torch.atanh(mod_op(x + 1.0, 2.0) - 1.0)


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


def _fmod(x, y):
    """The truncated remainder of x by y, exact as C's ``fmod``. torch's
    vectorised CPU ``fmod`` is exact except where ``x / y`` overflows
    float32 (it gives NaN there); those elements are first reduced by
    ``y * 2^k`` (exact, and an integer multiple of y, so the remainder is
    unchanged) until the quotient is finite."""
    r = torch.fmod(x, y)
    over = torch.isinf(x / y) & torch.isfinite(x) & (y != 0)
    if not bool(over.any()):
        return r
    xr, yr = x[over], y[over]
    while True:
        q_over = torch.isinf(xr / yr)
        if not bool(q_over.any()):
            break
        gap = torch.frexp(xr)[1] - torch.frexp(yr)[1] - 100
        ym = (yr.double() * torch.pow(2.0, gap.double())).float()
        xr = torch.where(q_over, torch.fmod(xr, ym), xr)
    out = r.clone()
    out[over] = torch.fmod(xr, yr)
    return out


def _mod_fix(r, y):
    """Where ``jnp.mod`` moves the truncated remainder ``r`` by ``y``: it is
    non-zero and its sign differs from ``y``'s."""
    return ((r < 0) != (y < 0)) & (r != 0)


def mod_op(x, y):
    """``jnp.mod``: the truncated remainder (exact), moved by ``y`` where
    its sign differs from ``y``'s. ``torch.remainder`` computes
    ``x - floor(x / y) * y`` instead, which is NaN where ``x / y``
    overflows (``mod(3e38, 0.5)``) and inexact where it is large."""
    r = _fmod(x, y)
    return torch.where(_mod_fix(r, y), r + y, r)


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

# Every registry operator, by the id the CUDA kernels' switches dispatch on
# (csrc/operators.cuh keeps the same numbers). 0/1/2 are PAD/CONST/VAR;
# unary ids lie below the first binary id.
KERNEL_UNARY_IDS: Dict[str, int] = {
    "cos": 10, "sin": 11, "tan": 12, "exp": 13, "log": 14, "log2": 15,
    "log10": 16, "log1p": 17, "sqrt": 18, "abs": 19, "square": 20,
    "cube": 21, "neg": 22, "relu": 23, "sinh": 24, "cosh": 25, "tanh": 26,
    "sigmoid": 27, "inv": 28, "identity": 29, "sign": 30, "gauss": 31,
    "asin": 32, "acos": 33, "atan": 34, "asinh": 35, "acosh": 36,
    "atanh": 37, "erf": 38, "erfc": 39, "gamma": 40,
}
KERNEL_BINARY_IDS: Dict[str, int] = {
    "+": 50, "-": 51, "*": 52, "/": 53, "^": 54, "pow": 54, "max": 55,
    "min": 56, "mod": 57, "atan2": 58, "greater": 59, "logical_or": 60,
    "logical_and": 61,
}

# The operators csrc/operators.cuh compiles into each kernel's full
# instantiation only; a batch without them runs the compact one, which
# runs the others faster (unary ids from "asin", binary ids from "mod")
KERNEL_FULL_ONLY = frozenset({
    "asin", "acos", "atan", "asinh", "acosh", "atanh", "erf", "erfc",
    "gamma", "mod", "atan2", "greater", "logical_or", "logical_and",
})

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


_TWO_OVER_SQRT_PI_F32 = float(torch.tensor(2.0 / math.sqrt(math.pi),
                                          dtype=torch.float32))
_PI_F32 = float(torch.tensor(math.pi, dtype=torch.float32))


def _clip_vjp(a, g):
    """``jnp.clip(a, -1, 1)`` is ``minimum(1, maximum(-1, a))``: the
    adjoint ``g`` of its value times each step's tie-splitting share (0.5
    at a = +-1, 0 beyond)."""
    m = torch.maximum(a, torch.full_like(a, -1.0))
    c = torch.minimum(m, torch.ones_like(a))
    g = g * _balanced_eq(m, c, torch.ones_like(a))
    return g * _balanced_eq(a, m, torch.full_like(a, -1.0))


def _asin_vjp(a, v, w, sign=1.0):
    """safe_asin (and with ``sign`` -1 safe_acos): the guard's select, the
    lax rule ``g * (+-rsqrt(1 - c^2))`` at the clipped operand ``c``, then
    the clip."""
    c = torch.clamp(a, -1.0, 1.0)
    r = torch.rsqrt(1.0 - c * c)
    return _clip_vjp(a, _sel(torch.abs(a) <= 1, w) * (r if sign > 0 else -r))


def _acosh_vjp(a, v, w):
    ok = a >= 1
    xs = torch.where(ok, a, torch.ones_like(a))
    return _sel(ok, _sel(ok, w) * torch.rsqrt(xs * xs - 1.0))


def _atanh_clip_vjp(a, v, w):
    """d mod(x + 1, 2) / dx is 1, so the lax atanh rule
    ``(1 / (1 + u)) * (g / (1 - u))`` at the wrapped operand u."""
    u = mod_op(a + 1.0, 2.0) - 1.0
    return (1.0 / (1.0 + u)) * (w / (1.0 - u))


def _gamma_vjp(a, v, w):
    """Through both branches of gamma_op's ``where`` as ``jax.vjp`` runs
    them: the poles and non-finite values take adjoint 0, the positive
    branch ``exp(lgamma(x))`` the adjoint where x > 0, the reflection
    ``pi / (sin(pi x) exp(lgamma(1 - x)))`` elsewhere; an unselected
    branch still multiplies its 0 by its own local derivatives, so an
    infinite one (lgamma overflowing, a zero denominator) gives NaN, as in
    JAX (gamma'(2) is NaN there). The three contributions to x add in the
    reverse order of the forward graph."""
    pos_sel = a > 0
    g = _sel(~(((a <= 0) & (a == torch.round(a))) | ~torch.isfinite(v)), w)
    g_pos = _sel(pos_sel, g)
    g_neg = _sel(~pos_sel, g)
    ct_pos = (g_pos * torch.exp(torch.lgamma(a))) * torch.digamma(a)
    u = _PI_F32 * a
    s = torch.sin(u)
    one_minus = 1.0 - a
    e = torch.exp(torch.lgamma(one_minus))
    den = s * e
    ct_den = (-g_neg * _PI_F32) * (1.0 / (den * den))
    ct_u = (ct_den * e) * torch.cos(u)
    ct_v = ((s * ct_den) * e) * torch.digamma(one_minus)
    return (-ct_v + _PI_F32 * ct_u) + ct_pos


def _mod_vjp(b, a, v, w):
    """``jnp.mod(b, a)``: the truncated remainder passes w to b, and
    ``-w * trunc(b / a)`` to a, plus w where the sign fix added a."""
    q = b / a
    da = (-w) * (sign(q) * torch.floor(torch.abs(q)))
    return w, _sel(_mod_fix(_fmod(b, a), a), w) + da


def _atan2_vjp(b, a, v, w):
    r2 = b * b + a * a
    return w * (a / r2), w * (-b / r2)


def _zero_vjp(b, a, v, w):
    return torch.zeros_like(w), torch.zeros_like(w)


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
    "asin": _asin_vjp,
    "acos": lambda a, v, w: _asin_vjp(a, v, w, -1.0),
    "atan": lambda a, v, w: w / (1.0 + a * a),
    "asinh": lambda a, v, w: w * torch.rsqrt(a * a + 1.0),
    "acosh": _acosh_vjp,
    "atanh": _atanh_clip_vjp,
    "erf": lambda a, v, w: _TWO_OVER_SQRT_PI_F32 * (w * torch.exp(-(a * a))),
    "erfc": lambda a, v, w: -_TWO_OVER_SQRT_PI_F32 * (w * torch.exp(-(a * a))),
    "gamma": _gamma_vjp,
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
    "mod": _mod_vjp,
    "atan2": _atan2_vjp,
    "greater": _zero_vjp,
    "logical_or": _zero_vjp,
    "logical_and": _zero_vjp,
}

# the registries as the package defines them: a name whose function is
# still this one runs the kernels' own device function
_BUILTIN_UNARY = dict(UNARY_REGISTRY)
_BUILTIN_BINARY = dict(BINARY_REGISTRY)
# name -> the variant of a user operator that the kernels are generated
# from (the counterpart of the JAX package's Mosaic-lowerable substitutes);
# unary and binary names are separate namespaces, as the registries are
KERNEL_FNS_UNARY: Dict[str, Callable] = {}
KERNEL_FNS_BINARY: Dict[str, Callable] = {}


def register_unary(name: str, fn: Callable,
                   kernel_fn: Callable | None = None) -> None:
    """Register a unary operator of the user's own: ``fn`` is an
    elementwise torch callable; ``kernel_fn``, when given, is the variant
    the CUDA kernels are generated from (``ops/user_ops.py`` traces
    ``kernel_fn or fn``). Re-registering a name drops a stale
    ``kernel_fn``."""
    UNARY_REGISTRY[name] = fn
    if kernel_fn is not None:
        KERNEL_FNS_UNARY[name] = kernel_fn
    else:
        KERNEL_FNS_UNARY.pop(name, None)


def register_binary(name: str, fn: Callable,
                    kernel_fn: Callable | None = None) -> None:
    """Register a binary operator of the user's own, ``fn(left, right)``;
    as ``register_unary``."""
    BINARY_REGISTRY[name] = fn
    if kernel_fn is not None:
        KERNEL_FNS_BINARY[name] = kernel_fn
    else:
        KERNEL_FNS_BINARY.pop(name, None)


def is_user_operator(arity: int, name: str) -> bool:
    """Whether the kernels run ``name`` (of arity 1 or 2) from generated
    code: it was registered by the user, or a registry name was
    re-registered with another function."""
    reg, builtin, kfns = ((UNARY_REGISTRY, _BUILTIN_UNARY, KERNEL_FNS_UNARY)
                          if arity == 1 else
                          (BINARY_REGISTRY, _BUILTIN_BINARY, KERNEL_FNS_BINARY))
    return name in kfns or reg.get(name) is not builtin.get(name)


def kernel_fn_of(arity: int, name: str) -> Callable:
    """The callable the kernels' code of a user operator comes from."""
    if arity == 1:
        return KERNEL_FNS_UNARY.get(name, UNARY_REGISTRY[name])
    return KERNEL_FNS_BINARY.get(name, BINARY_REGISTRY[name])


def vjp_of(arity: int, name: str) -> Callable:
    """The derivative rule of operator ``name`` in ``UNARY_VJP`` /
    ``BINARY_VJP``'s form; for a user operator ``torch.func.vjp`` of its
    callable (the plain versions' counterpart of ``jax.vjp``)."""
    if not is_user_operator(arity, name):
        return (UNARY_VJP if arity == 1 else BINARY_VJP)[name]
    if arity == 1:
        fn = UNARY_REGISTRY[name]

        def unary(a, v, w):
            return torch.func.vjp(fn, a)[1](w)[0]

        return unary
    fn = BINARY_REGISTRY[name]

    def binary(b, a, v, w):
        return torch.func.vjp(fn, b, a)[1](w)

    return binary


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
