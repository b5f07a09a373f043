"""Batched constant optimisation (counterpart of
``symbolicregression_jl_tpu/models/constant_opt.py``, BFGS path).

Members are selected with probability ``optimizer_probability`` (a fixed
K = round(npop * p) per island), their constants fitted by BFGS with a
parallel backtracking line search from the member's own constants and
``optimizer_nrestarts`` perturbed restarts, and written back only where
improved. Every (island x restart x member) instance runs in one batch:
one launch of the gradient kernel per BFGS step and one launch of the
loss-only kernel over all ``_LS_STEPS`` line-search candidates
(``ops/kernel_grad.py``).

The random part (which members, which restarts) is ``_select_and_starts``
and draws through ``utils/rng.py``; ``optimize_selected`` is the
deterministic rest and takes the selection as tensors. Nelder-Mead and
Newton are not ported yet: ``Options`` refuses them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.kernel_grad import make_loss_kernel
from ..ops.losses import contain_nonfinite, resolve_loss
from ..utils import rng
from .complexity import compute_complexity
from .fitness import loss_to_score
from .options import Options
from .population import Population, gather_trees
from .trees import CONST, TreeBatch

_LS_STEPS = 8  # candidate step sizes per line search: 2^0 .. 2^-7


def evals_per_member(n_iters: int) -> int:
    """Loss evaluations one BFGS instance is charged: the start, then per
    iteration the line search and the gradient at the new point."""
    return 1 + n_iters * (_LS_STEPS + 1)


def _bfgs_batched(trees_flat: TreeBatch, x0: torch.Tensor, cmask: torch.Tensor,
                  X: torch.Tensor, y: torch.Tensor,
                  weights: Optional[torch.Tensor], options: Options,
                  n_iters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """BFGS over M instances (trees_flat (M, L), starts x0 (M, L), cmask
    (M, L) marking CONST slots): descent safeguard, parallel backtracking
    over ``_LS_STEPS`` step sizes, curvature-gated inverse-Hessian update,
    non-finite steps rejected. Returns (x (M, L), f (M,)); an instance that
    never reached a finite objective hands back its start.

    Everything runs in the working dtype, x0's (X's): the constants, the
    inverse Hessian H, the step sizes and the update, as the JAX package's
    ``_bfgs_single`` runs at bfloat16 and float16; the kernels hand back
    loss and gradient in it. The ``V H V^T`` update is a batched matrix
    product left to PyTorch (as the JAX package leaves it to XLA); at
    float32 it runs in full float32 because PyTorch keeps TF32 off for
    matrix products by default."""
    M, L = x0.shape
    ops = options.operators
    loss = resolve_loss(options.loss)
    grad_fn = make_loss_kernel(trees_flat, X, y, weights, ops, with_grad=True,
                               loss=loss)
    ls_fn = make_loss_kernel(trees_flat, X, y, weights, ops, with_grad=False,
                             reps=_LS_STEPS, loss=loss)

    def loss_grad(x):
        loss, grad, ok = grad_fn(x)
        # a non-finite gradient component is zeroed: the direction is
        # rejected, the instance kept
        g = torch.where(torch.isfinite(grad), grad, 0.0) * cmask
        return contain_nonfinite(loss, ok), g

    def loss_batch(xs):  # (M, _LS_STEPS, L) -> (M, _LS_STEPS)
        loss, _, ok = ls_fn(xs)
        return contain_nonfinite(loss, ok)

    eye = torch.eye(L, dtype=x0.dtype, device=x0.device)
    ts = 2.0 ** -torch.arange(_LS_STEPS, dtype=x0.dtype, device=x0.device)
    x = x0
    f, g = loss_grad(x0)
    H = eye.expand(M, L, L)
    for _ in range(n_iters):
        d = -torch.einsum("mij,mj->mi", H, g)
        descent = (d * g).sum(-1) < 0
        d = torch.where(descent.unsqueeze(-1), d, -g)
        fs = loss_batch(x.unsqueeze(1) + ts[:, None] * d.unsqueeze(1))
        k = torch.argmin(fs, dim=1)
        f_new = fs.gather(1, k.unsqueeze(1)).squeeze(1)
        improved = (f_new < f) & torch.isfinite(f_new)
        # select, don't scale: 0 * inf would poison x with NaN
        x_new = torch.where(improved.unsqueeze(-1),
                            x + ts[k].unsqueeze(-1) * d, x)
        _, g_cand = loss_grad(x_new)
        g_new = torch.where(improved.unsqueeze(-1), g_cand, g)
        s = x_new - x
        yv = g_new - g
        sy = (s * yv).sum(-1)
        ok_sy = sy.abs() > 1e-10
        rho = torch.where(ok_sy, 1.0 / torch.where(ok_sy, sy, 1.0), 0.0)
        V = eye - rho[:, None, None] * s.unsqueeze(-1) * yv.unsqueeze(-2)
        H_new = (torch.einsum("mij,mjk,mlk->mil", V, H, V)
                 + rho[:, None, None] * s.unsqueeze(-1) * s.unsqueeze(-2))
        ok_H = improved & (rho > 0) & torch.isfinite(H_new).all(-1).all(-1)
        H = torch.where(ok_H[:, None, None], H_new, H)
        f = torch.where(improved, f_new, f)
        x, g = x_new, g_new
    return torch.where(torch.isfinite(f).unsqueeze(-1), x, x0), f


def _static_shapes(npop: int, max_len: int, options: Options,
                   probability: Optional[float]) -> Tuple[int, int, int]:
    """(K, n_starts, L): members optimised per island, starts per member,
    slots."""
    if probability is None:
        probability = options.optimizer_probability
    K = max(1, int(round(npop * probability)))
    return K, 1 + options.optimizer_nrestarts, max_len


def _const_slots(trees: TreeBatch) -> torch.Tensor:
    """(..., L) bool: the live CONST slots."""
    idx = torch.arange(trees.max_len, device=trees.kind.device)
    return (trees.kind == CONST) & (idx < trees.length.unsqueeze(-1))


def _select_and_starts(gen, pops: Population, K: int, n_starts: int):
    """The random part, for every island at once (pops fields (I, npop,
    ...)): K members per island by uniform priority, members with
    constants first (top-k), and their starts: the member's constants,
    then ``n_starts - 1`` restarts ``c * (1 + 0.5 * N(0, 1))``. Returns
    (sel_idx (I, K), starts (I, n_starts, K, L))."""
    I, npop = pops.losses.shape
    dev = pops.losses.device
    L = pops.trees.max_len
    has_consts = _const_slots(pops.trees).any(-1)
    priority = rng.uniform(gen, (I, npop), dev) + has_consts.float()
    sel_idx = torch.topk(priority, K, dim=-1).indices
    cval = gather_trees(pops.trees, sel_idx).cval
    eps = rng.normal(gen, (I, n_starts, K, L), dev).to(cval.dtype)
    scale = torch.full((n_starts, 1, 1), 0.5, dtype=cval.dtype, device=dev)
    scale[0] = 0.0
    return sel_idx, cval.unsqueeze(1) * (1.0 + scale * eps)


def _flatten_island_instances(sub_trees: TreeBatch, starts, cmask):
    """(I, K, ...) members + (I, n_starts, K, L) starts -> restart-major
    flat instances of length n_starts * I * K."""
    I, n_starts, K, L = starts.shape
    flat_sub = sub_trees.map(lambda a: a.reshape((I * K,) + a.shape[2:]))
    tiled = flat_sub.map(
        lambda a: a.repeat((n_starts,) + (1,) * (a.dim() - 1)))
    starts_flat = starts.movedim(1, 0).reshape(n_starts * I * K, L)
    cmask_flat = cmask.reshape(I * K, L).repeat(n_starts, 1)
    return tiled, starts_flat, cmask_flat


def _write_back(pops: Population, sel_idx, sub_trees: TreeBatch, sub_losses,
                eligible, xs, fs, baseline: float, options: Options):
    """Fold the best restart of each selected member back where it
    improved the loss (xs (I, n_starts, K, L), fs (I, n_starts, K)).
    Never writes a non-finite constant, even behind a finite loss.
    Returns (Population, n_evals (I,), n_attempted (I,))."""
    n_starts = xs.shape[1]
    best_r = torch.argmin(fs, dim=1)  # (I, K)
    x_best = xs.gather(1, best_r[:, None, :, None].expand(
        -1, 1, -1, xs.shape[-1])).squeeze(1)
    f_best = fs.gather(1, best_r.unsqueeze(1)).squeeze(1)
    improved = (eligible & (f_best < sub_losses) & torch.isfinite(f_best)
                & torch.isfinite(x_best).all(-1))
    new_sub_cval = torch.where(improved.unsqueeze(-1), x_best, sub_trees.cval)
    complexity = compute_complexity(sub_trees._replace(cval=new_sub_cval),
                                    options)
    new_sub_losses = torch.where(improved, f_best, sub_losses)
    new_sub_scores = torch.where(
        improved, loss_to_score(new_sub_losses, baseline, complexity, options),
        pops.scores.gather(1, sel_idx))
    ix = sel_idx.unsqueeze(-1).expand_as(new_sub_cval)
    trees = pops.trees._replace(cval=pops.trees.cval.scatter(1, ix, new_sub_cval))
    n_attempted = eligible.sum(-1)
    n_evals = (n_attempted.to(torch.float32) * n_starts
               * evals_per_member(options.optimizer_iterations))
    return (Population(trees=trees,
                       scores=pops.scores.scatter(1, sel_idx, new_sub_scores),
                       losses=pops.losses.scatter(1, sel_idx, new_sub_losses),
                       birth=pops.birth),
            n_evals, n_attempted)


def optimize_selected(pops: Population, sel_idx: torch.Tensor,
                      starts: torch.Tensor, X, y, weights, baseline: float,
                      options: Options):
    """The deterministic part of one pass: BFGS from ``starts`` (I,
    n_starts, K, L) for the members ``sel_idx`` (I, K) of every island in
    one batch, then the write-back. Returns (Population, n_evals (I,),
    n_attempted (I,))."""
    I, n_starts, K, L = starts.shape
    sub_trees = gather_trees(pops.trees, sel_idx)
    const = _const_slots(sub_trees)
    tiled, starts_flat, cmask_flat = _flatten_island_instances(
        sub_trees, starts, const.to(starts.dtype))
    x_flat, f_flat = _bfgs_batched(tiled, starts_flat, cmask_flat, X, y,
                                   weights, options,
                                   options.optimizer_iterations)
    xs = x_flat.reshape(n_starts, I, K, L).movedim(0, 1)
    fs = f_flat.reshape(n_starts, I, K).movedim(0, 1)
    return _write_back(pops, sel_idx, sub_trees, pops.losses.gather(1, sel_idx),
                       const.any(-1), xs, fs, baseline, options)


def optimize_constants_islands(gen, pops: Population, X, y, weights,
                               baseline: float, options: Options,
                               probability: Optional[float] = None):
    """One pass over every island (pops fields (I, npop, ...)), members
    selected with ``probability`` (default ``optimizer_probability``).
    Returns (Population, n_evals (I,), n_attempted (I,))."""
    K, n_starts, _ = _static_shapes(pops.losses.shape[-1], pops.trees.max_len,
                                    options, probability)
    sel_idx, starts = _select_and_starts(gen, pops, K, n_starts)
    return optimize_selected(pops, sel_idx, starts, X, y, weights, baseline,
                             options)


def optimize_constants_population(gen, pop: Population, X, y, weights,
                                  baseline: float, options: Options,
                                  probability: Optional[float] = None):
    """The one-island form: (Population, n_evals, n_attempted)."""
    pops = Population(pop.trees.map(lambda f: f.unsqueeze(0)),
                      pop.scores.unsqueeze(0), pop.losses.unsqueeze(0),
                      pop.birth.unsqueeze(0))
    out, n_evals, n_attempted = optimize_constants_islands(
        gen, pops, X, y, weights, baseline, options, probability)
    return (Population(out.trees.map(lambda f: f[0]), out.scores[0],
                       out.losses[0], out.birth[0]),
            n_evals[0], n_attempted[0])
