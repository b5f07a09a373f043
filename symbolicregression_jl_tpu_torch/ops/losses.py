"""Elementwise loss library + weighted aggregation, on torch tensors.

Counterpart of ``symbolicregression_jl_tpu/ops/losses.py``: distance
losses take (pred, target) and act on the residual; margin losses act on
the agreement target*pred. ``aggregate_loss`` is the (weighted) mean over
rows and ``contain_nonfinite`` the one containment rule every scoring path
ends in.

Every loss of the registry is an ``ElementwiseLoss``: a frozen, hashable
callable that carries what a kernel needs, its ``kind`` (the loss id of
``csrc/losses.cuh``) and up to three float32 ``constants``. The constants
are computed on the host in double, as the JAX package's Python
expressions compute them before they meet a float32 array (``0.5 *
delta``, ``0.5 / gamma``, ``q / (q + 1.0)``, ...), then rounded to
float32, or kept in double for a float64 array (``constants_of``, which
the float64 kernels get; pi and log 2 are float64's there too); every
function applies them in the JAX package's order of operations
(``periodic_loss`` is ``((d * 2) * pi) / c``, not ``d * (2 pi / c)``).

``LOSS_VJP[kind](pred, target, constants)`` is d elem / d pred, the root
seed of the constant-gradient kernel's adjoint sweep, composed as
``jax.vjp`` composes it (with cotangent 1; the kernels multiply by the
row weight): ``abs'`` is ``where(x >= 0, 1, -1)`` (1 at 0, -1 at NaN), a
``maximum`` gives each side 0.5 at a tie and 0 to the side it did not
pick, a ``where`` sends a zero cotangent into the branch it did not take
(so a non-finite local derivative there gives NaN), and ``pow`` is
``p * x ** (p - 1)``. ``csrc/losses.cuh`` repeats the same operations in
the same order, so the kernels and these functions agree bit for bit
where no transcendental function is involved.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

# loss ids: the order of csrc/losses.cuh's enum
(L2, L1, LP, LOGIT_DIST, HUBER, L1_EPS, L2_EPS, PERIODIC, QUANTILE, ZERO_ONE,
 PERCEPTRON, L1_HINGE, L2_HINGE, SMOOTHED_L1_HINGE, MODIFIED_HUBER, L2_MARGIN,
 EXP, SIGMOID, DWD_MARGIN, LOGIT_MARGIN, LOG_COSH) = range(21)
KIND_NAMES = (
    "L2DistLoss", "L1DistLoss", "LPDistLoss", "LogitDistLoss", "HuberLoss",
    "L1EpsilonInsLoss", "L2EpsilonInsLoss", "PeriodicLoss", "QuantileLoss",
    "ZeroOneLoss", "PerceptronLoss", "L1HingeLoss", "L2HingeLoss",
    "SmoothedL1HingeLoss", "ModifiedHuberLoss", "L2MarginLoss", "ExpLoss",
    "SigmoidLoss", "DWDMarginLoss", "LogitMarginLoss", "LogCoshLoss")
PI = float(np.float32(math.pi))  # jnp.pi as a float32 operand
LN2 = float(np.float32(math.log(2.0)))  # jnp.log(2.0) in float32


def _f32(x: float) -> float:
    return float(np.float32(x))


def _rnd(x: float, like: torch.Tensor) -> float:
    """A constant computed in double as it meets ``like``: rounded to
    float32 unless ``like`` is float64."""
    return x if like.dtype == torch.float64 else _f32(x)


def _pi(like: torch.Tensor) -> float:
    return math.pi if like.dtype == torch.float64 else PI


def _ln2(like: torch.Tensor) -> float:
    return math.log(2.0) if like.dtype == torch.float64 else LN2


def _constants(kind: int, params: Tuple[float, ...],
               double: bool = False) -> Tuple[float, float, float]:
    """The loss's float32 constants (float64 ones with ``double``), each
    computed in double from its parameter as the JAX package's expression
    computes it."""
    if kind == LP:
        (p,) = params
        c = (p,)
    elif kind == HUBER:
        (delta,) = params
        c = (delta, 0.5 * delta)
    elif kind in (L1_EPS, L2_EPS, PERIODIC):
        c = params
    elif kind == QUANTILE:
        (tau,) = params
        c = (tau, tau - 1.0)
    elif kind == SMOOTHED_L1_HINGE:
        (gamma,) = params
        c = (1.0 - gamma, 0.5 / gamma, 1.0 - gamma / 2.0)
    elif kind == DWD_MARGIN:
        (q,) = params
        c = (q / (q + 1.0), (q ** q) / ((q + 1.0) ** (q + 1.0)), q)
    else:
        c = ()
    c = tuple(float(v) if double else _f32(v) for v in c)
    return c + (0.0,) * (3 - len(c))


@dataclasses.dataclass(frozen=True)
class ElementwiseLoss:
    """One loss of the registry: ``kind`` (a loss id above) and its
    parameters (``(p,)``, ``(delta,)``, ``(eps,)``, ``(c,)``, ``(tau,)``,
    ``(gamma,)`` or ``(q,)``; empty for the others). Called on (pred,
    target) it computes the elementwise loss; ``seed`` is ``LOSS_VJP``."""

    kind: int
    params: Tuple[float, ...] = ()

    @property
    def name(self) -> str:
        return KIND_NAMES[self.kind]

    @property
    def constants(self) -> Tuple[float, float, float]:
        return _constants(self.kind, self.params)

    def constants_of(self, dtype: torch.dtype) -> Tuple[float, float, float]:
        """The constants for data of ``dtype``: float64's at float64, else
        ``constants``."""
        return _constants(self.kind, self.params, dtype == torch.float64)

    def __call__(self, pred, target):
        return LOSS_ELEM[self.kind](pred, target,
                                    self.constants_of(pred.dtype))

    def seed(self, pred, target):
        """d elem / d pred (``LOSS_VJP``)."""
        return LOSS_VJP[self.kind](pred, target,
                                   self.constants_of(pred.dtype))

    def __repr__(self):
        args = ", ".join(repr(p) for p in self.params)
        return f"{self.name}({args})"


# ---------------------------------------------------------------------------
# The pieces the losses share, each with its JAX rule
# ---------------------------------------------------------------------------


def _abs_vjp(x, g):
    """abs's rule: select(x >= 0, g, -g)."""
    return torch.where(x >= 0, g, -g)


def _max(a, b: float):
    """jnp.maximum(a, b) for a constant b: NaN in ``a`` stays NaN."""
    return torch.clamp_min(a, b)


def _max_share(x, ans, other):
    """d maximum(x, other) / dx at ``ans``: 1 where x was picked, 0.5 at a
    tie, 0 elsewhere (NaN included); lax's balanced equality."""
    return (torch.where(x == ans, 1.0, 0.0)
            / torch.where(ans == other, 2.0, 1.0))


def _pow(x, e: float):
    """x ** e with the exponents 1 and 2 exact (x, x * x), as the kernels
    compute them."""
    if e == 1.0:
        return x
    if e == 2.0:
        return x * x
    return torch.pow(x, e)


def _div(a, b):
    """a / b, correctly rounded, for a constant on either side: torch
    divides by a Python number as a multiplication by its reciprocal (two
    roundings), the kernels and XLA by a division."""
    if isinstance(b, torch.Tensor):
        return torch.full_like(b, a) / b
    return a / torch.full_like(a, b)


def _taken(cond):
    """(1 where ``cond``, 0 elsewhere), (the converse): the cotangents a
    ``where`` sends into its two branches."""
    one = torch.where(cond, 1.0, 0.0)
    return one, 1.0 - one


def _sigmoid(x):
    """jax.nn.sigmoid as XLA lowers it: 1 / (1 + exp(-x))."""
    return 1.0 / (1.0 + torch.exp(-x))


# ---------------------------------------------------------------------------
# Forward (elem) and seed (d elem / d pred) of each kind
# ---------------------------------------------------------------------------


def _l2(p, t, c):
    d = p - t
    return d * d


def _l2_vjp(p, t, c):
    return 2.0 * (p - t)


def _l1(p, t, c):
    return torch.abs(p - t)


def _l1_vjp(p, t, c):
    return _abs_vjp(p - t, torch.ones_like(p))


def _lp(p, t, c):
    return _pow(torch.abs(p - t), c[0])


def _lp_vjp(p, t, c):
    r = p - t
    e = _rnd(c[0] - 1.0, p)  # sub(y, 1) in float32
    return _abs_vjp(r, c[0] * _pow(torch.abs(r), e))


def _logit_dist(p, t, c):
    d = p - t
    return -torch.log((4.0 * _sigmoid(d)) * _sigmoid(-d))


def _logit_dist_vjp(p, t, c):
    d = p - t
    s1, s2 = _sigmoid(d), _sigmoid(-d)
    four_s1 = 4.0 * s1
    ct_x = -1.0 / (four_s1 * s2)
    g1 = (4.0 * (ct_x * s2)) * (s1 * (1.0 - s1))
    g2 = (four_s1 * ct_x) * (s2 * (1.0 - s2))
    return g1 - g2


def _huber(p, t, c):
    d = torch.abs(p - t)
    return torch.where(d <= c[0], (0.5 * d) * d, c[0] * (d - c[1]))


def _huber_vjp(p, t, c):
    r = p - t
    d = torch.abs(r)
    cq, cl = _taken(d <= c[0])
    return _abs_vjp(r, cq * d + cl * c[0])


def _l1_eps(p, t, c):
    return _max(torch.abs(p - t) - c[0], 0.0)


def _l1_eps_vjp(p, t, c):
    r = p - t
    a = torch.abs(r) - c[0]
    return _abs_vjp(r, _max_share(a, _max(a, 0.0), 0.0))


def _l2_eps(p, t, c):
    e = _max(torch.abs(p - t) - c[0], 0.0)
    return e * e


def _l2_eps_vjp(p, t, c):
    r = p - t
    a = torch.abs(r) - c[0]
    e = _max(a, 0.0)
    return _abs_vjp(r, (2.0 * e) * _max_share(a, e, 0.0))


def _periodic_arg(p, t, c):
    return _div(((p - t) * 2.0) * _pi(p), c[0])


def _periodic(p, t, c):
    return 1.0 - torch.cos(_periodic_arg(p, t, c))


def _periodic_vjp(p, t, c):
    return (_div(torch.sin(_periodic_arg(p, t, c)), c[0]) * _pi(p)) * 2.0


def _quantile(p, t, c):
    d = t - p
    return torch.where(d >= 0, c[0] * d, c[1] * d)


def _quantile_vjp(p, t, c):
    d = t - p
    return -torch.where(d >= 0, torch.full_like(d, c[0]),
                        torch.full_like(d, c[1]))


def _zero_one(p, t, c):
    return torch.where(t * p >= 0, 0.0, 1.0).to(p.dtype)


def _zero_one_vjp(p, t, c):
    return torch.zeros_like(p)


def _perceptron(p, t, c):
    return _max(-t * p, 0.0)


def _perceptron_vjp(p, t, c):
    a = -t * p
    return -t * _max_share(a, _max(a, 0.0), 0.0)


def _l1_hinge(p, t, c):
    return _max(1.0 - t * p, 0.0)


def _l1_hinge_vjp(p, t, c):
    a = 1.0 - t * p
    return t * -_max_share(a, _max(a, 0.0), 0.0)


def _l2_hinge(p, t, c):
    h = _max(1.0 - t * p, 0.0)
    return h * h


def _l2_hinge_vjp(p, t, c):
    a = 1.0 - t * p
    h = _max(a, 0.0)
    return t * -((2.0 * h) * _max_share(a, h, 0.0))


def _smoothed_l1_hinge(p, t, c):
    a = t * p
    h = _max(1.0 - a, 0.0)
    return torch.where(a >= c[0], (c[1] * h) * h, c[2] - a)


def _smoothed_l1_hinge_vjp(p, t, c):
    a = t * p
    b = 1.0 - a
    h = _max(b, 0.0)
    cq, cl = _taken(a >= c[0])
    q = (c[1] * h) * cq
    return t * (-cl - (q + q) * _max_share(b, h, 0.0))


def _modified_huber(p, t, c):
    a = t * p
    h = _max(1.0 - a, 0.0)
    return torch.where(a >= -1.0, h * h, -4.0 * a)


def _modified_huber_vjp(p, t, c):
    a = t * p
    b = 1.0 - a
    h = _max(b, 0.0)
    cq, cl = _taken(a >= -1.0)
    q = h * cq
    return t * (-4.0 * cl - (q + q) * _max_share(b, h, 0.0))


def _l2_margin(p, t, c):
    d = 1.0 - t * p
    return d * d


def _l2_margin_vjp(p, t, c):
    return t * -(2.0 * (1.0 - t * p))


def _exp(p, t, c):
    return torch.exp(-t * p)


def _exp_vjp(p, t, c):
    return -t * torch.exp(-t * p)


def _sigmoid_loss(p, t, c):
    return 1.0 - torch.tanh(t * p)


def _sigmoid_loss_vjp(p, t, c):
    th = torch.tanh(t * p)
    return t * ((-1.0 - th) * (1.0 - th))


def _dwd_margin(p, t, c):
    a = t * p
    return torch.where(a <= c[0], 1.0 - a, _div(c[1], _pow(_max(a, c[0]), c[2])))


def _dwd_margin_vjp(p, t, c):
    a = t * p
    m = _max(a, c[0])
    P = _pow(m, c[2])
    cl, cb = _taken(a <= c[0])
    P_bar = -((cb * (1.0 / (P * P))) * c[1])
    m_bar = P_bar * (c[2] * _pow(m, _rnd(c[2] - 1.0, a)))
    return t * (-cl + m_bar * _max_share(a, m, c[0]))


def _logit_margin(p, t, c):
    return torch.log1p(torch.exp(-t * p))


def _logit_margin_vjp(p, t, c):
    e = torch.exp(-t * p)
    return -t * ((1.0 / (e + 1.0)) * e)


def _log_cosh(p, t, c):
    d = torch.abs(p - t)
    return (d + torch.log1p(torch.exp(-2.0 * d))) - _ln2(d)


def _log_cosh_vjp(p, t, c):
    r = p - t
    e = torch.exp(-2.0 * torch.abs(r))
    return _abs_vjp(r, 1.0 + -2.0 * ((1.0 / (e + 1.0)) * e))


LOSS_ELEM = (_l2, _l1, _lp, _logit_dist, _huber, _l1_eps, _l2_eps, _periodic,
             _quantile, _zero_one, _perceptron, _l1_hinge, _l2_hinge,
             _smoothed_l1_hinge, _modified_huber, _l2_margin, _exp,
             _sigmoid_loss, _dwd_margin, _logit_margin, _log_cosh)
LOSS_VJP = (_l2_vjp, _l1_vjp, _lp_vjp, _logit_dist_vjp, _huber_vjp,
            _l1_eps_vjp, _l2_eps_vjp, _periodic_vjp, _quantile_vjp,
            _zero_one_vjp, _perceptron_vjp, _l1_hinge_vjp, _l2_hinge_vjp,
            _smoothed_l1_hinge_vjp, _modified_huber_vjp, _l2_margin_vjp,
            _exp_vjp, _sigmoid_loss_vjp, _dwd_margin_vjp, _logit_margin_vjp,
            _log_cosh_vjp)
# transcendental functions (exp, log, tanh, cos, pow) in the forward or the
# seed: the kernels agree with these functions within a tolerance, the
# others bit for bit
TRANSCENDENTAL = frozenset((LP, LOGIT_DIST, PERIODIC, EXP, SIGMOID,
                            DWD_MARGIN, LOGIT_MARGIN, LOG_COSH))


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------

l2_dist_loss = ElementwiseLoss(L2)
l1_dist_loss = ElementwiseLoss(L1)
logit_dist_loss = ElementwiseLoss(LOGIT_DIST)
zero_one_loss = ElementwiseLoss(ZERO_ONE)
perceptron_loss = ElementwiseLoss(PERCEPTRON)
l1_hinge_loss = ElementwiseLoss(L1_HINGE)
l2_hinge_loss = ElementwiseLoss(L2_HINGE)
modified_huber_loss = ElementwiseLoss(MODIFIED_HUBER)
l2_margin_loss = ElementwiseLoss(L2_MARGIN)
exp_loss = ElementwiseLoss(EXP)
sigmoid_loss = ElementwiseLoss(SIGMOID)
logit_margin_loss = ElementwiseLoss(LOGIT_MARGIN)
log_cosh_loss = ElementwiseLoss(LOG_COSH)


def lp_dist_loss(p: float) -> ElementwiseLoss:
    return ElementwiseLoss(LP, (float(p),))


def huber_loss(delta: float = 1.0) -> ElementwiseLoss:
    return ElementwiseLoss(HUBER, (float(delta),))


def l1_epsilon_ins_loss(eps: float = 1.0) -> ElementwiseLoss:
    return ElementwiseLoss(L1_EPS, (float(eps),))


def l2_epsilon_ins_loss(eps: float = 1.0) -> ElementwiseLoss:
    return ElementwiseLoss(L2_EPS, (float(eps),))


def periodic_loss(c: float = 1.0) -> ElementwiseLoss:
    return ElementwiseLoss(PERIODIC, (float(c),))


def quantile_loss(tau: float = 0.5) -> ElementwiseLoss:
    return ElementwiseLoss(QUANTILE, (float(tau),))


def smoothed_l1_hinge_loss(gamma: float = 1.0) -> ElementwiseLoss:
    return ElementwiseLoss(SMOOTHED_L1_HINGE, (float(gamma),))


def dwd_margin_loss(q: float = 1.0) -> ElementwiseLoss:
    return ElementwiseLoss(DWD_MARGIN, (float(q),))


LOSS_REGISTRY = {
    "L2DistLoss": l2_dist_loss,
    "mse": l2_dist_loss,
    "L1DistLoss": l1_dist_loss,
    "mae": l1_dist_loss,
    "LogitDistLoss": logit_dist_loss,
    "HuberLoss": huber_loss(1.0),
    "L1EpsilonInsLoss": l1_epsilon_ins_loss(1.0),
    "EpsilonInsLoss": l1_epsilon_ins_loss(1.0),
    "L2EpsilonInsLoss": l2_epsilon_ins_loss(1.0),
    "PeriodicLoss": periodic_loss(1.0),
    "QuantileLoss": quantile_loss(0.5),
    "PinballLoss": quantile_loss(0.5),
    "ZeroOneLoss": zero_one_loss,
    "PerceptronLoss": perceptron_loss,
    "L1HingeLoss": l1_hinge_loss,
    "HingeLoss": l1_hinge_loss,
    "L2HingeLoss": l2_hinge_loss,
    "SmoothedL1HingeLoss": smoothed_l1_hinge_loss(1.0),
    "ModifiedHuberLoss": modified_huber_loss,
    "L2MarginLoss": l2_margin_loss,
    "ExpLoss": exp_loss,
    "SigmoidLoss": sigmoid_loss,
    "DWDMarginLoss": dwd_margin_loss(1.0),
    "LogitMarginLoss": logit_margin_loss,
    "LogCoshLoss": log_cosh_loss,
    "LPDistLoss": lp_dist_loss(2.0),
}


def resolve_loss(loss) -> Callable:
    """A name of ``LOSS_REGISTRY`` -> its ``ElementwiseLoss``; an
    ``ElementwiseLoss`` or any other callable (pred, target) -> elem as it
    is."""
    if callable(loss):
        return loss
    if loss in LOSS_REGISTRY:
        return LOSS_REGISTRY[loss]
    raise ValueError(f"Unknown loss {loss!r}")


def contain_nonfinite(value: torch.Tensor, ok=None,
                      ref: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``value`` where ``ref`` (default: ``value``) is finite and ``ok``
    holds, else ``+inf`` — the scoring epilogue's containment rule."""
    ref = value if ref is None else ref
    fin = torch.isfinite(ref)
    if ok is not None:
        fin = fin & ok
    return torch.where(fin, value, torch.full_like(value, float("inf")))


def pairwise_sum(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Fixed-order pairwise-tree sum along ``axis``: adjacent pairs are
    added, then adjacent pair sums, log2(n) levels of elementwise adds
    (zero-padded to the next power of two; ``x + 0`` is exact). The order
    is fixed by the code, so the JAX package's ``pairwise_sum`` gives the
    same bits, and the error grows as log n, not n."""
    x = torch.movedim(x, axis, -1)
    n = x.shape[-1]
    if n == 0:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    size = 1
    while size < n:
        size *= 2
    if size != n:
        x = torch.nn.functional.pad(x, (0, size - n))
    while size > 1:
        x = x.reshape(x.shape[:-1] + (size // 2, 2))
        x = x[..., 0] + x[..., 1]
        size //= 2
    return x[..., 0]


def weight_sum(weights: torch.Tensor) -> torch.Tensor:
    """Sum of the weights (..., nrows) over the rows: ``pairwise_sum`` in
    float32 at least, rounded once to the weights' dtype (as ``torch.sum``
    rounds a half-precision sum). Its adds are elementwise, so a dataset's
    sum has the same bits whether it is summed alone or beside other
    datasets (a tenant-batched search's, or per-island minibatches), on
    the card as on the CPU, in one launch per tree level."""
    acc = torch.promote_types(weights.dtype, torch.float32)
    return pairwise_sum(weights.to(acc), -1).to(weights.dtype)


def _tiled_row_sum(elem: torch.Tensor, tile_rows: int) -> torch.Tensor:
    """Row sum along the last axis in tiles: zero-pad to a multiple of
    ``tile_rows``, sum each (tile_rows // 128, 128) block, then add the
    tiles' partial sums left to right (the JAX package's tiled order)."""
    n = elem.shape[-1]
    padded = -(-n // tile_rows) * tile_rows
    if padded != n:
        elem = torch.nn.functional.pad(elem, (0, padded - n))
    tiles = elem.reshape(elem.shape[:-1]
                         + (padded // tile_rows, tile_rows // 128, 128))
    partials = tiles.sum(dim=(-2, -1))
    acc = partials[..., 0]
    for t in range(1, partials.shape[-1]):
        acc = acc + partials[..., t]
    return acc


def aggregate_loss(elem: torch.Tensor, weights: Optional[torch.Tensor] = None,
                   axis: int = -1, deterministic: bool = False,
                   tile_rows: int = 0) -> torch.Tensor:
    """Mean / weighted mean over ``axis``. ``deterministic`` reduces by
    ``pairwise_sum``; ``tile_rows`` (a positive multiple of 128,
    unweighted, ``axis=-1``) by ``_tiled_row_sum``, then divides by the
    row count."""
    if tile_rows:
        if weights is not None or deterministic or axis != -1:
            raise ValueError(
                "tile_rows applies to the unweighted non-deterministic "
                "axis=-1 aggregation only")
        if tile_rows < 128 or tile_rows % 128:
            raise ValueError(
                f"tile_rows must be a positive multiple of 128, got "
                f"{tile_rows}")
        return _div(_tiled_row_sum(elem, tile_rows), float(elem.shape[-1]))
    if deterministic:
        if weights is None:
            return _div(pairwise_sum(elem, axis), float(elem.shape[axis]))
        return pairwise_sum(elem * weights, axis) / pairwise_sum(weights, axis)
    if weights is None:
        return torch.mean(elem, dim=axis)
    return torch.sum(elem * weights, dim=axis) / torch.sum(weights, dim=axis)
