"""Batched constant optimisation (counterpart of
``symbolicregression_jl_tpu/models/constant_opt.py``).

Members are selected with probability ``optimizer_probability`` (a fixed
K = round(npop * p) per island), their constants fitted by
``optimizer_algorithm`` from the member's own constants and
``optimizer_nrestarts`` perturbed restarts, and written back only where
improved. Every (island x restart x member) instance runs in one batch,
in lockstep for a fixed number of iterations, on the kernels of
``ops/kernel_grad.py``:

* BFGS (``_bfgs_batched``): one launch of the gradient kernel (B3) per
  step and one of the loss-only kernel (B4) over all ``_LS_STEPS``
  line-search candidates;
* Nelder-Mead (``_nelder_mead_batched``, the JAX package's
  ``_nelder_mead_single`` for every instance at once): losses only, one B4
  launch over the first simplex's L + 1 vertices, then one over the four
  candidates of each of its ``3 * n_iters`` steps;
* Newton (``_newton_batched``, ``_newton_single``): the gradient from B3,
  the diagonal of the Hessian from ``torch.func`` forward mode through the
  lockstep interpreter (``hessian_diagonal``, the port's form of the JAX
  package's ``jax.jacfwd`` of the masked gradient), the line search of
  ``_LS_STEPS`` on B4.

None of the three loops reads the card from the host inside its
iterations (Newton reads which slots hold constants once, before them:
``hessian_plan``). The loss is the search's: any registry loss or a callable the
tracer lowers (``ops/user_ops.py``), or a custom full-tree objective
(``Options.loss_function``), whose closures ``_objective_kernel`` makes
in place of the kernels' (the JAX package's ``_member_loss_fn``): the
gradient ``vmap(grad(objective))`` over the instances (one value-mode
launch, B1, and one of the gradient kernel's cotangent-seeded mode, B3,
through ``ops/interpreter.py``'s ``eval_tree``), the line search
``vmap(objective)`` (one B1 launch), and Newton's Hessian diagonal
forward over forward through the lockstep interpreter
(``interpreter.plain_eval_tree``). In float64 every one of them runs on
the float64 builds.

The random part (which members, which restarts) is ``_select_and_starts``
and draws through ``utils/rng.py``; ``optimize_selected`` is the
deterministic rest and takes the selection as tensors.

In a tenant-batched search (X (T, nfeat, nrows), the islands T tenant-
major blocks) the instances are ordered tenant-major, so one B3 / B4
launch per step serves every tenant through the kernels' per-set form;
each instance's arithmetic is its own, so each tenant's pass is its solo
pass.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops import interpreter
from ..ops.kernel_grad import make_loss_kernel
from ..ops.losses import aggregate_loss, contain_nonfinite, resolve_loss
from ..utils import rng
from .complexity import compute_complexity
from .fitness import loss_to_score
from .options import Options
from .population import Population, gather_trees
from .trees import CONST, TreeBatch

_LS_STEPS = 8  # candidate step sizes per line search: 2^0 .. 2^-7


def evals_per_member(n_iters: int, max_len: int = 0,
                     algorithm: str = "BFGS") -> int:
    """Loss evaluations one instance is charged (the JAX package's
    ``_OPTIMIZERS``): BFGS the start, then per iteration the line search
    and the gradient at the new point; Nelder-Mead the first simplex's
    ``max_len + 1`` vertices, then four candidates per step, three steps
    per iteration; Newton the start, then per iteration the line search,
    the gradient and the Hessian's diagonal."""
    if algorithm == "NelderMead":
        return (max_len + 1) + 3 * n_iters * 4
    if algorithm == "Newton":
        return 1 + n_iters * (_LS_STEPS + 2)
    return 1 + n_iters * (_LS_STEPS + 1)


def _objective_kernel(trees_flat: TreeBatch, X: torch.Tensor, y: torch.Tensor,
                      weights: Optional[torch.Tensor], options: Options,
                      with_grad: bool, reps: int):
    """``make_loss_kernel``'s ``fn(cval) -> (loss, grad | None, ok)`` for
    the custom objective: each of the ``reps`` constant vectors per tree
    is an instance, the objective ``torch.func.vmap``-ed over all of them
    (with ``grad_and_value`` for the gradient), contained; ``ok`` is all
    True (the containment is in the loss)."""
    T, L = trees_flat.kind.shape
    inst = trees_flat if reps == 1 else trees_flat.map(
        lambda f: f.repeat_interleave(reps, dim=0))
    objective = options.loss_function

    def f(tree, c):
        return contain_nonfinite(objective(tree._replace(cval=c), X, y,
                                           weights, options))

    value_grad = torch.func.vmap(torch.func.grad_and_value(f, argnums=1))
    value = torch.func.vmap(f)

    def fn(cval: torch.Tensor):
        lead = cval.shape[:-1]
        cv = cval.reshape(T * reps, L).to(X.dtype)
        if with_grad:
            grad, loss = value_grad(inst, cv)
            grad = grad.reshape(cval.shape)
        else:
            loss, grad = value(inst, cv), None
        loss = loss.to(X.dtype).reshape(lead)
        return loss, grad, torch.ones_like(loss, dtype=torch.bool)

    return fn


def _loss_closure(trees_flat: TreeBatch, X: torch.Tensor, y: torch.Tensor,
                  weights: Optional[torch.Tensor], options: Options,
                  with_grad: bool = True, reps: int = 1):
    """The optimisers' ``fn(cval) -> (loss, grad | None, ok)``: the
    kernels' (``make_loss_kernel`` under the search's loss), or the custom
    objective's (``_objective_kernel``)."""
    if options.loss_function is not None:
        return _objective_kernel(trees_flat, X, y, weights, options,
                                 with_grad, reps)
    return make_loss_kernel(trees_flat, X, y, weights, options.operators,
                            with_grad=with_grad, reps=reps,
                            loss=resolve_loss(options.loss))


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
    matrix products by default; in a tenant-batched search one product
    per tenant on the card (``_instance_einsum``), so a tenant's bits are
    its solo search's."""
    M, L = x0.shape
    sets = X.shape[0] if X.dim() == 3 else 1  # tenants
    grad_fn = _loss_closure(trees_flat, X, y, weights, options)
    ls_fn = _loss_closure(trees_flat, X, y, weights, options,
                          with_grad=False, reps=_LS_STEPS)

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
        d = -_instance_einsum("mij,mj->mi", sets, H, g)
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
        H_new = (_instance_einsum("mij,mjk,mlk->mil", sets, V, H, V)
                 + rho[:, None, None] * s.unsqueeze(-1) * s.unsqueeze(-2))
        ok_H = improved & (rho > 0) & torch.isfinite(H_new).all(-1).all(-1)
        H = torch.where(ok_H[:, None, None], H_new, H)
        f = torch.where(improved, f_new, f)
        x, g = x_new, g_new
    return torch.where(torch.isfinite(f).unsqueeze(-1), x, x0), f


def _instance_einsum(eq: str, sets: int,
                     *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, *ops)`` over operands whose leading axis is the
    instances, ``sets`` set-major blocks of them (a tenant-batched
    search's tenants). cuBLAS picks its batched kernel by the batch count
    and the operands' alignment, and its kernels round differently, so on
    the card each block is its own product, at its solo search's instance
    count and from a 256-byte-aligned address (a block that does not start
    at one is copied), and a tenant's steps are its solo search's bits. A
    solo search, and the CPU, make the one product."""
    if sets == 1 or not ops[0].is_cuda:
        return torch.einsum(eq, *ops)
    m = ops[0].shape[0] // sets
    out = []
    for s in range(sets):
        block = [o[s * m:(s + 1) * m] for o in ops]
        out.append(torch.einsum(eq, *(b if b.data_ptr() % 256 == 0
                                      else b.clone() for b in block)))
    return torch.cat(out)


def _losses(fn, xs):
    """Contained losses of a B4 closure's candidates."""
    loss, _, ok = fn(xs)
    return contain_nonfinite(loss, ok)


def _nelder_mead_batched(trees_flat: TreeBatch, x0: torch.Tensor,
                         cmask: torch.Tensor, X: torch.Tensor, y: torch.Tensor,
                         weights: Optional[torch.Tensor], options: Options,
                         n_iters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's ``_nelder_mead_single`` over M instances at once
    (trees_flat (M, L), starts x0 (M, L), cmask (M, L)): a simplex of L + 1
    vertices, x0 and x0 + offsets on the CONST slots (``0.05 x0 + 0.5``
    on the diagonal, the ``(i * 31 + j * 17) % 7`` pattern on the rows of
    inactive slots), then ``3 * n_iters`` steps of reflection, expansion,
    contraction and a pull of the worst vertex halfway to the best (in
    place of a shrink), the standard acceptance, non-finite candidates
    rejected. Returns (x (M, L), f (M,)); an instance whose best vertex is
    not finite hands back its start. Every loss is a B4 launch: the
    simplex at reps L + 1, each step's four candidates at reps 4."""
    M, L = x0.shape
    init_fn = _loss_closure(trees_flat, X, y, weights, options,
                            with_grad=False, reps=L + 1)
    step_fn = _loss_closure(trees_flat, X, y, weights, options,
                            with_grad=False, reps=4)
    dev, dt = x0.device, x0.dtype
    i = torch.arange(L, device=dev)
    pattern = (((i[:, None] * 31 + i[None, :] * 17) % 7) - 3).to(dt) / 3.0
    base = (0.05 * x0 + 0.5).unsqueeze(1)  # (M, 1, L)
    eye = torch.eye(L, dtype=torch.bool, device=dev)
    offs = torch.where(eye, base, pattern * base) * cmask.unsqueeze(1)
    verts = torch.cat([x0.unsqueeze(1), x0.unsqueeze(1) + offs], 1)
    fs = _losses(init_fn, verts)  # (M, L + 1)
    for _ in range(n_iters * 3):
        order = torch.argsort(fs, dim=1, stable=True)
        verts = verts.gather(1, order.unsqueeze(-1).expand_as(verts))
        fs = fs.gather(1, order)
        best, worst = verts[:, 0], verts[:, -1]
        f_best, f_second, f_worst = fs[:, 0], fs[:, -2], fs[:, -1]
        centroid = verts[:, :-1].mean(1)
        xr = centroid + (centroid - worst)
        xe = centroid + 2.0 * (centroid - worst)
        xc = centroid + 0.5 * (worst - centroid)
        xs = best + 0.5 * (worst - best)
        fr, fe, fc, fsh = _losses(step_fn, torch.stack([xr, xe, xc, xs],
                                                       1)).unbind(1)
        expand = (fr < f_best) & (fe < fr)
        reflect = fr < f_second
        contract = fc < f_worst
        new_x = torch.where(expand[:, None], xe, torch.where(
            reflect[:, None], xr, torch.where(contract[:, None], xc, xs)))
        new_f = torch.where(expand, fe, torch.where(
            reflect, fr, torch.where(contract, fc, fsh)))
        accept = (new_f < f_worst) & torch.isfinite(new_f)
        verts = torch.cat([verts[:, :-1], torch.where(
            accept[:, None], new_x, worst).unsqueeze(1)], 1)
        fs = torch.cat([fs[:, :-1], torch.where(accept, new_f,
                                                f_worst).unsqueeze(1)], 1)
    k = torch.argmin(fs, dim=1)
    f = fs.gather(1, k.unsqueeze(1)).squeeze(1)
    x = verts.gather(1, k[:, None, None].expand(-1, 1, L)).squeeze(1)
    return torch.where(torch.isfinite(f).unsqueeze(-1), x, x0), f


def hessian_plan(trees_flat: TreeBatch, cmask: torch.Tensor, chunk: int = 0,
                 nrows: int = 1):
    """Where ``hessian_diagonal`` works, fixed for a whole Newton pass and
    read from the card once, before its iterations: every (instance,
    slot) pair whose slot holds a constant, in chunks of ``chunk`` pairs
    (0: as many as keep a chunk's values near 2^28 at ``nrows`` rows),
    each chunk as (instance indices, slots, the instances' trees). Every
    other entry of the diagonal is 0 (its masked gradient is 0 whatever
    the constants)."""
    M, L = cmask.shape
    chunk = chunk or max(1, (1 << 28) // max(1, nrows * L))
    pairs = torch.nonzero(cmask.cpu() != 0)  # the one read: the structure
    plan = []
    for k in range(0, len(pairs), chunk):
        inst, slot = (v.to(cmask.device) for v in pairs[k:k + chunk].unbind(1))
        plan.append((inst, slot, trees_flat.map(lambda f: f[inst])))
    return plan


def hessian_diagonal(trees_flat: TreeBatch, x: torch.Tensor,
                     cmask: torch.Tensor, X: torch.Tensor, y: torch.Tensor,
                     weights: Optional[torch.Tensor], options: Options,
                     chunk: int = 0, plan=None) -> torch.Tensor:
    """diag(jacfwd(masked_grad))(x) of every instance (M, L), as the JAX
    package's ``_newton_single`` takes it (non-finite entries 0): the
    masked gradient ``g = d loss / d c * cmask`` (0 where not finite) of
    the lockstep interpreter's loss (``interpreter.eval_trees``, the
    loss and ``aggregate_loss``, contained), and its derivative along
    each slot's own direction, by ``torch.func`` forward mode over forward
    mode: d g_s / d c_s is the s-th diagonal entry, the s-th column of
    ``jax.jacfwd``'s Jacobian read at row s. Each (instance, slot) pair of
    ``hessian_plan`` (computed here unless given) is one row of a batch
    whose tangent is that slot's direction, so every slot of every
    instance goes through the interpreter together. Under a custom
    objective the loss is the objective vmapped over the pairs, whose
    ``eval_tree`` calls run the lockstep interpreter
    (``interpreter.plain_eval_tree``, counted in ``PLAIN_CALLS``)."""
    ops = options.operators
    loss_fn = resolve_loss(options.loss)
    objective = options.loss_function
    if plan is None:
        plan = hessian_plan(trees_flat, cmask, chunk, X.shape[-1])
    h = torch.zeros_like(x)
    for inst, slot, t in plan:
        c0 = x[inst]
        e = torch.nn.functional.one_hot(slot, x.shape[1]).to(x.dtype)
        cm = cmask[inst, slot]

        def loss(c, t=t):
            if objective is not None:
                return torch.func.vmap(lambda tc: contain_nonfinite(
                    objective(tc, X, y, weights, options)))(t._replace(cval=c))
            y_pred, ok = interpreter.eval_trees(t._replace(cval=c), X, ops)
            return contain_nonfinite(aggregate_loss(loss_fn(y_pred, y),
                                                    weights), ok)

        def grad_s(c, e=e, cm=cm, loss=loss):
            g = torch.func.jvp(loss, (c,), (e,))[1] * cm
            return torch.where(torch.isfinite(g), g, 0.0)

        with interpreter.plain_eval_tree():
            col = torch.func.jvp(grad_s, (c0,), (e,))[1]
        h[inst, slot] = torch.where(torch.isfinite(col), col, 0.0).to(h.dtype)
    return h


def _newton_batched(trees_flat: TreeBatch, x0: torch.Tensor,
                    cmask: torch.Tensor, X: torch.Tensor, y: torch.Tensor,
                    weights: Optional[torch.Tensor], options: Options,
                    n_iters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's ``_newton_single`` over M instances at once:
    steps along ``g / |diag H|`` (``g`` where ``|diag H| <= 1e-8``) with a
    backtracking line search over ``_LS_STEPS`` step sizes, non-finite
    steps rejected; with one active constant that is the Newton step, with
    several a Jacobi-preconditioned gradient step. The gradient is B3's
    (masked, non-finite components 0), the line search B4's, the Hessian's
    diagonal ``hessian_diagonal``'s. Returns (x (M, L), f (M,)); an
    instance that never reached a finite objective hands back its start."""
    grad_fn = _loss_closure(trees_flat, X, y, weights, options)
    ls_fn = _loss_closure(trees_flat, X, y, weights, options,
                          with_grad=False, reps=_LS_STEPS)
    ts = 2.0 ** -torch.arange(_LS_STEPS, dtype=x0.dtype, device=x0.device)
    plan = hessian_plan(trees_flat, cmask, nrows=X.shape[-1])
    f0, grad, ok0 = grad_fn(x0)
    x, f = x0, contain_nonfinite(f0, ok0)
    for it in range(n_iters):
        if it:
            _, grad, _ = grad_fn(x)
        g = grad * cmask
        g = torch.where(torch.isfinite(g), g, 0.0)
        h = hessian_diagonal(trees_flat, x, cmask, X, y, weights, options,
                             plan=plan)
        step = torch.where(h.abs() > 1e-8, g / h.abs(), g)
        cand = x.unsqueeze(1) - ts[:, None] * step.unsqueeze(1)
        fs = _losses(ls_fn, cand)
        k = torch.argmin(fs, dim=1)
        f_new = fs.gather(1, k.unsqueeze(1)).squeeze(1)
        improved = (f_new < f) & torch.isfinite(f_new)
        x = torch.where(improved.unsqueeze(-1),
                        cand.gather(1, k[:, None, None].expand(
                            -1, 1, x.shape[1])).squeeze(1), x)
        f = torch.where(improved, f_new, f)
    return torch.where(torch.isfinite(f).unsqueeze(-1), x, x0), f


_OPTIMIZERS = {"BFGS": _bfgs_batched, "NelderMead": _nelder_mead_batched,
               "Newton": _newton_batched}


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


def _select_and_starts(keys, pops: Population, K: int, n_starts: int):
    """The random part, for every island at once (pops fields (I, npop,
    ...), ``keys`` (I, 2) split in two as the reference splits each
    island's key): K members per island by uniform priority, members with
    constants first (the reference's top-k, lower index first among
    ties), and their starts: the member's constants, then ``n_starts - 1``
    restarts ``c * (1 + 0.5 * N(0, 1))`` drawn in the working dtype.
    Returns (sel_idx (I, K), starts (I, n_starts, K, L))."""
    npop = pops.losses.shape[-1]
    dev = pops.losses.device
    L = pops.trees.max_len
    k = rng.split(keys, 2)
    has_consts = _const_slots(pops.trees).any(-1)
    priority = rng.uniform(k[:, 0], (npop,), rng.draw_dtype(
        pops.trees.cval.dtype)) + has_consts.float()
    sel_idx = rng.top_k_indices(priority, K)
    cval = gather_trees(pops.trees, sel_idx).cval
    eps = rng.normal(k[:, 1], (n_starts, K, L), cval.dtype)
    scale = torch.full((n_starts, 1, 1), 0.5, dtype=cval.dtype, device=dev)
    scale[0] = 0.0
    return sel_idx, cval.unsqueeze(1) * (1.0 + scale * eps)


def _flatten_island_instances(sub_trees: TreeBatch, starts, cmask,
                              sets: int = 1):
    """(I, K, ...) members + (I, n_starts, K, L) starts -> flat instances
    of length n_starts * I * K, restart-major within each of ``sets``
    blocks of I / sets islands (the tenants of a batched search), the
    blocks set-major."""
    I, n_starts, K, L = starts.shape
    per = I // sets

    def tile(a):  # (I, K, ...) -> (sets, n_starts, per * K, ...) flat
        a = a.reshape((sets, 1, per * K) + a.shape[2:])
        return a.expand((sets, n_starts) + a.shape[2:]).reshape(
            (-1,) + a.shape[3:])

    starts_flat = starts.reshape(sets, per, n_starts, K, L).movedim(
        2, 1).reshape(-1, L)
    return sub_trees.map(tile), starts_flat, tile(cmask)


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
               * evals_per_member(options.optimizer_iterations,
                                  xs.shape[-1], options.optimizer_algorithm))
    return (Population(trees=trees,
                       scores=pops.scores.scatter(1, sel_idx, new_sub_scores),
                       losses=pops.losses.scatter(1, sel_idx, new_sub_losses),
                       birth=pops.birth),
            n_evals, n_attempted)


def optimize_selected(pops: Population, sel_idx: torch.Tensor,
                      starts: torch.Tensor, X, y, weights, baseline: float,
                      options: Options):
    """The deterministic part of one pass: ``optimizer_algorithm`` from
    ``starts`` (I, n_starts, K, L) for the members ``sel_idx`` (I, K) of
    every island in one batch, then the write-back. Returns (Population,
    n_evals (I,), n_attempted (I,))."""
    I, n_starts, K, L = starts.shape
    sets = X.shape[0] if X.dim() == 3 else 1  # tenants
    sub_trees = gather_trees(pops.trees, sel_idx)
    const = _const_slots(sub_trees)
    tiled, starts_flat, cmask_flat = _flatten_island_instances(
        sub_trees, starts, const.to(starts.dtype), sets)
    x_flat, f_flat = _OPTIMIZERS[options.optimizer_algorithm](
        tiled, starts_flat, cmask_flat, X, y, weights, options,
        options.optimizer_iterations)
    per = I // sets
    xs = x_flat.reshape(sets, n_starts, per, K, L).movedim(1, 2).reshape(
        I, n_starts, K, L)
    fs = f_flat.reshape(sets, n_starts, per, K).movedim(1, 2).reshape(
        I, n_starts, K)
    return _write_back(pops, sel_idx, sub_trees, pops.losses.gather(1, sel_idx),
                       const.any(-1), xs, fs, baseline, options)


def optimize_constants_islands(keys, pops: Population, X, y, weights,
                               baseline: float, options: Options,
                               probability: Optional[float] = None):
    """One pass over every island (pops fields (I, npop, ...)), members
    selected with ``probability`` (default ``optimizer_probability``).
    Returns (Population, n_evals (I,), n_attempted (I,))."""
    K, n_starts, _ = _static_shapes(pops.losses.shape[-1], pops.trees.max_len,
                                    options, probability)
    sel_idx, starts = _select_and_starts(keys, pops, K, n_starts)
    return optimize_selected(pops, sel_idx, starts, X, y, weights, baseline,
                             options)


def optimize_constants_population(key, pop: Population, X, y, weights,
                                  baseline: float, options: Options,
                                  probability: Optional[float] = None):
    """The one-island form: (Population, n_evals, n_attempted)."""
    pops = Population(pop.trees.map(lambda f: f.unsqueeze(0)),
                      pop.scores.unsqueeze(0), pop.losses.unsqueeze(0),
                      pop.birth.unsqueeze(0))
    out, n_evals, n_attempted = optimize_constants_islands(
        key.unsqueeze(0), pops, X, y, weights, baseline, options, probability)
    return (Population(out.trees.map(lambda f: f[0]), out.scores[0],
                       out.losses[0], out.birth[0]),
            n_evals[0], n_attempted[0])
