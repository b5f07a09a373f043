"""Elementwise loss library + weighted aggregation, on torch tensors.

Counterpart of ``symbolicregression_jl_tpu/ops/losses.py``: distance
losses take (pred, target) and act on the residual; margin losses act on
the agreement target*pred. ``aggregate_loss`` is the (weighted) mean over
rows and ``contain_nonfinite`` the one containment rule every scoring path
ends in.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch


def l2_dist_loss(pred, target):
    d = pred - target
    return d * d


def l2_dist_loss_grad(pred, target):
    """d l2_dist_loss / d pred: the seed of the constant-gradient kernel's
    adjoint sweep."""
    return 2.0 * (pred - target)


def l1_dist_loss(pred, target):
    return torch.abs(pred - target)


def lp_dist_loss(p: float):
    def loss(pred, target):
        return torch.abs(pred - target) ** p

    return loss


def logit_dist_loss(pred, target):
    d = pred - target
    return -torch.log(4.0 * torch.sigmoid(d) * torch.sigmoid(-d))


def huber_loss(delta: float = 1.0):
    def loss(pred, target):
        d = torch.abs(pred - target)
        return torch.where(d <= delta, 0.5 * d * d, delta * (d - 0.5 * delta))

    return loss


def l1_epsilon_ins_loss(eps: float = 1.0):
    def loss(pred, target):
        return torch.clamp_min(torch.abs(pred - target) - eps, 0.0)

    return loss


def l2_epsilon_ins_loss(eps: float = 1.0):
    def loss(pred, target):
        e = torch.clamp_min(torch.abs(pred - target) - eps, 0.0)
        return e * e

    return loss


def periodic_loss(c: float = 1.0):
    def loss(pred, target):
        return 1.0 - torch.cos((pred - target) * 2.0 * math.pi / c)

    return loss


def quantile_loss(tau: float = 0.5):
    def loss(pred, target):
        d = target - pred
        return torch.where(d >= 0, tau * d, (tau - 1.0) * d)

    return loss


def zero_one_loss(pred, target):
    return (~(target * pred >= 0)).to(pred.dtype)


def perceptron_loss(pred, target):
    return torch.clamp_min(-target * pred, 0.0)


def l1_hinge_loss(pred, target):
    return torch.clamp_min(1.0 - target * pred, 0.0)


def l2_hinge_loss(pred, target):
    h = torch.clamp_min(1.0 - target * pred, 0.0)
    return h * h


def smoothed_l1_hinge_loss(gamma: float = 1.0):
    def loss(pred, target):
        a = target * pred
        h = torch.clamp_min(1.0 - a, 0.0)
        return torch.where(a >= 1.0 - gamma, 0.5 / gamma * h * h,
                           1.0 - gamma / 2.0 - a)

    return loss


def modified_huber_loss(pred, target):
    a = target * pred
    h = torch.clamp_min(1.0 - a, 0.0)
    return torch.where(a >= -1.0, h * h, -4.0 * a)


def l2_margin_loss(pred, target):
    d = 1.0 - target * pred
    return d * d


def exp_loss(pred, target):
    return torch.exp(-target * pred)


def sigmoid_loss(pred, target):
    return 1.0 - torch.tanh(target * pred)


def dwd_margin_loss(q: float = 1.0):
    def loss(pred, target):
        a = target * pred
        thresh = q / (q + 1.0)
        big = (q ** q) / ((q + 1.0) ** (q + 1.0)) / torch.clamp_min(a, thresh) ** q
        return torch.where(a <= thresh, 1.0 - a, big)

    return loss


def logit_margin_loss(pred, target):
    return torch.log1p(torch.exp(-target * pred))


def log_cosh_loss(pred, target):
    d = torch.abs(pred - target)
    return d + torch.log1p(torch.exp(-2.0 * d)) - math.log(2.0)


LOSS_REGISTRY: Dict[str, Callable] = {
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


def aggregate_loss(elem: torch.Tensor, weights: Optional[torch.Tensor] = None,
                   dim: int = -1) -> torch.Tensor:
    """Mean / weighted mean over ``dim``."""
    if weights is None:
        return torch.mean(elem, dim=dim)
    return torch.sum(elem * weights, dim=dim) / torch.sum(weights, dim=dim)
