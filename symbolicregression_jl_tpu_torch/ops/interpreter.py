"""Lockstep postfix stack machine, in plain PyTorch.

Counterpart of ``symbolicregression_jl_tpu/ops/interpreter.py``: all trees
advance slot by slot together; at each slot every operator is applied to
the current stack tops and the result is selected by opcode (the
``_slot_step`` semantics). Any non-finite value produced at a non-PAD slot
marks the tree incomplete (``ok=False``).

This is the portable oracle for the kernel's plain version
(``ops/kernel_eval.py``), which evaluates through the operand schedule
instead of a stack, and the function the derivatives differentiate:
``eval_grad_constants`` and ``eval_diff_tree`` in forward mode
(``torch.func.jvp``), ``eval_grad_variables`` in reverse mode
(``torch.autograd``). ``eval_loss_trees_fused`` evaluates through the
kernels (``models/fitness.py``'s routes), not through this interpreter.

``eval_tree``, the function a custom objective (``Options.loss_function``)
calls on its one tree, is an ``autograd.Function`` (``EvalTree``) with a
``vmap`` rule: under ``torch.func.vmap`` over a population it evaluates
the whole batch in one call, on a CUDA tensor one launch of the scoring
kernel's value mode (B1, ``kernel_eval.eval_trees``), on the CPU the
lockstep interpreter; its backward (the derivative with respect to the
constants) is ``EvalTreeVJP``, itself with a ``vmap`` rule: one launch of
the gradient kernel's cotangent-seeded mode
(``kernel_grad.eval_vjp_constants``) on the card, the lockstep
interpreter's VJP on the CPU. So ``vmap(grad(objective))`` over a population is one B1 and one B3
launch. Inside ``plain_eval_tree()`` it is the lockstep interpreter
written without in-place updates instead (``eval_tree_plain``), which
``torch.func`` differentiates in any mode and order: Newton's Hessian
diagonal under a custom objective (``models/constant_opt.py``), the one
path on the card that runs it; each such call counts in ``PLAIN_CALLS``.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

import torch

from ..models.trees import ARITY, BIN, CONST, PAD, UNA, VAR, TreeBatch
from ..utils.device import table
from .operators import OperatorSet

# calls of eval_tree that ran the lockstep interpreter (plain_eval_tree)
PLAIN_CALLS = {"eval_tree": 0}
_plain = threading.local()


def _slot_step(stack, sp, bad, k, o, f, c, X, operators: OperatorSet):
    """One step for a flat batch: stack (D, T, R), sp (T,), bad (T, R);
    node fields k/o/f/c are (T,)."""
    D, T, R = stack.shape
    ar = table(tuple(ARITY.tolist()), k.device)[k]
    ti = torch.arange(T, device=k.device)
    a = stack[torch.clamp_min(sp - 1, 0), ti]  # top: unary / right operand
    b = stack[torch.clamp_min(sp - 2, 0), ti]  # second: left operand
    leaf = torch.where((k == CONST).unsqueeze(-1), c.unsqueeze(-1).expand(T, R),
                       X[f])
    v = leaf
    for j, fn in enumerate(operators.unary_fns):
        v = torch.where(((k == UNA) & (o == j)).unsqueeze(-1), fn(a), v)
    for j, fn in enumerate(operators.binary_fns):
        v = torch.where(((k == BIN) & (o == j)).unsqueeze(-1), fn(b, a), v)
    is_pad = k == PAD
    new_sp = torch.where(is_pad, sp, sp - ar + 1)
    write = torch.clamp_min(new_sp - 1, 0)
    v = torch.where(is_pad.unsqueeze(-1), stack[write, ti], v)
    stack[write, ti] = v
    bad = bad | ((~is_pad).unsqueeze(-1) & ~torch.isfinite(v))
    return stack, new_sp, bad


def eval_trees(trees: TreeBatch, X: torch.Tensor,
               operators: OperatorSet) -> Tuple[torch.Tensor, torch.Tensor]:
    """trees batch shape (...,); X (nfeat, nrows) -> (y (..., nrows),
    ok (...,))."""
    batch_shape = trees.length.shape
    flat = trees.map(lambda x: x.reshape((-1,) + x.shape[len(batch_shape):]))
    T, L = flat.kind.shape
    R = X.shape[1]
    stack = torch.zeros((L // 2 + 2, T, R), dtype=X.dtype, device=X.device)
    sp = torch.zeros(T, dtype=torch.int64, device=X.device)
    bad = torch.zeros((T, R), dtype=torch.bool, device=X.device)
    for s in range(L):
        stack, sp, bad = _slot_step(
            stack, sp, bad, flat.kind[:, s], flat.op[:, s], flat.feat[:, s],
            flat.cval[:, s].to(X.dtype), X, operators,
        )
    y = stack[0]
    ok = ~bad.any(dim=-1) & (flat.length > 0)
    return y.reshape(batch_shape + (R,)), ok.reshape(batch_shape)


def _eval_single(tree: TreeBatch, X: torch.Tensor,
                 operators: OperatorSet) -> Tuple[torch.Tensor, torch.Tensor]:
    """``eval_trees`` on a single tree (batch shape ())."""
    y, ok = eval_trees(tree.map(lambda x: x.unsqueeze(0)), X, operators)
    return y[0], ok[0]


def _to_front(x: torch.Tensor, dim: Optional[int], size: int) -> torch.Tensor:
    """A vmap rule's argument with its batch dimension first (expanded
    where it has none)."""
    return x.movedim(dim, 0) if dim is not None else x.expand(size, *x.shape)


def _check_unbatched_x(in_dims) -> None:
    if in_dims[5] is not None:
        raise NotImplementedError(
            "eval_tree is vmapped over the trees of a population; a vmap "
            "over X is not supported")


class EvalTree(torch.autograd.Function):
    """(y, ok) of the trees (kind, op, feat, cval, length) of any batch
    shape over X; the derivative with respect to ``cval`` only."""

    generate_vmap_rule = False

    @staticmethod
    def forward(kind, op, feat, cval, length, X, operators):
        trees = TreeBatch(kind, op, feat, cval, length)
        if X.is_cuda:
            from . import kernel_eval

            return kernel_eval.eval_trees(trees, X, operators)
        return eval_trees(trees, X, operators)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:6])
        ctx.operators = inputs[6]
        ctx.mark_non_differentiable(output[1])

    @staticmethod
    def backward(ctx, gy, _gok):
        kind, op, feat, cval, length, X = ctx.saved_tensors
        if ctx.needs_input_grad[5]:
            raise NotImplementedError(
                "eval_tree differentiates with respect to the constants; "
                "use eval_grad_variables for the derivative in X")
        g = EvalTreeVJP.apply(kind, op, feat, cval, length, X, gy,
                              ctx.operators)
        return None, None, None, g, None, None, None

    @staticmethod
    def vmap(info, in_dims, kind, op, feat, cval, length, X, operators):
        _check_unbatched_x(in_dims)
        fields = [_to_front(x, d, info.batch_size)
                  for x, d in zip((kind, op, feat, cval, length), in_dims)]
        return EvalTree.apply(*fields, X, operators), (0, 0)


class EvalTreeVJP(torch.autograd.Function):
    """d (sum_r gy[..., r] * y[..., r]) / d cval of ``EvalTree``'s trees:
    the gradient kernel's cotangent-seeded mode on the card, the lockstep
    interpreter's VJP on the CPU. Not differentiable again."""

    generate_vmap_rule = False

    @staticmethod
    def forward(kind, op, feat, cval, length, X, gy, operators):
        trees = TreeBatch(kind, op, feat, cval, length)
        if X.is_cuda:
            from . import kernel_grad

            return kernel_grad.eval_vjp_constants(
                trees, X, gy, operators)[0].to(cval.dtype)
        _, pull = torch.func.vjp(
            lambda c: eval_trees(trees._replace(cval=c), X, operators)[0],
            cval.to(X.dtype))
        return pull(gy.to(X.dtype))[0].to(cval.dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, _g):
        raise NotImplementedError(
            "eval_tree has no second derivative on the kernels; Newton's "
            "Hessian runs inside interpreter.plain_eval_tree()")

    @staticmethod
    def vmap(info, in_dims, kind, op, feat, cval, length, X, gy, operators):
        _check_unbatched_x(in_dims)
        args = [_to_front(x, d, info.batch_size) for x, d in
                zip((kind, op, feat, cval, length), in_dims)]
        gy = _to_front(gy, in_dims[6], info.batch_size)
        return EvalTreeVJP.apply(*args, X, gy, operators), 0


@contextlib.contextmanager
def plain_eval_tree():
    """Inside: ``eval_tree`` is ``eval_tree_plain`` (counted in
    ``PLAIN_CALLS``), which ``torch.func`` differentiates in any mode."""
    depth = getattr(_plain, "depth", 0)
    _plain.depth = depth + 1
    try:
        yield
    finally:
        _plain.depth = depth


def eval_tree(tree: TreeBatch, X: torch.Tensor,
              operators: OperatorSet) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single tree (batch shape ()) -> (y (nrows,), ok): the function a
    custom objective calls (``EvalTree``; ``eval_tree_plain`` inside
    ``plain_eval_tree()``)."""
    if getattr(_plain, "depth", 0):
        PLAIN_CALLS["eval_tree"] += 1
        return eval_tree_plain(tree, X, operators)
    return EvalTree.apply(*tree, X, operators)


def eval_tree_plain(tree: TreeBatch, X: torch.Tensor,
                    operators: OperatorSet
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The lockstep interpreter on a single tree (batch shape ()), with no
    in-place update, so that ``torch.func`` transforms (vmap, jvp, grad,
    in any nesting) go through it: (y (nrows,), ok)."""
    L = tree.kind.shape[-1]
    nfeat, R = X.shape
    depth = torch.arange(L // 2 + 2, device=X.device).unsqueeze(-1)
    cval = tree.cval.to(X.dtype)
    stack = torch.zeros((L // 2 + 2, R), dtype=X.dtype, device=X.device)
    sp = torch.zeros((), dtype=torch.int64, device=X.device)
    bad = torch.zeros(R, dtype=torch.bool, device=X.device)

    def entry(i):
        return stack.gather(0, i.reshape(1, 1).expand(1, R))[0]

    for s in range(L):
        k, o, c = tree.kind[s], tree.op[s], cval[s]
        f = tree.feat[s].clamp(0, nfeat - 1)
        a = entry(torch.clamp_min(sp - 1, 0))  # top: unary / right operand
        b = entry(torch.clamp_min(sp - 2, 0))  # second: left operand
        v = torch.where(k == CONST, c, X.gather(0, f.reshape(1, 1).expand(
            1, R))[0])
        for j, fn in enumerate(operators.unary_fns):
            v = torch.where((k == UNA) & (o == j), fn(a), v)
        for j, fn in enumerate(operators.binary_fns):
            v = torch.where((k == BIN) & (o == j), fn(b, a), v)
        is_pad = k == PAD
        arity = (k == UNA).long() + 2 * (k == BIN).long()  # ARITY[k]
        sp_new = torch.where(is_pad, sp, sp - arity + 1)
        write = torch.clamp_min(sp_new - 1, 0)
        v = torch.where(is_pad, entry(write), v)
        stack = torch.where(depth == write, v, stack)
        bad = bad | (~is_pad & ~torch.isfinite(v))
        sp = sp_new
    return stack[0], ~bad.any() & (tree.length > 0)


def eval_loss_trees_fused(trees: TreeBatch, X: torch.Tensor, y: torch.Tensor,
                          weights: Optional[torch.Tensor],
                          operators: OperatorSet, loss_fn,
                          rows_per_tile: int = 0,
                          deterministic: bool = False) -> torch.Tensor:
    """Per-tree aggregated loss (+inf where the evaluation left the finite
    domain): trees batch shape (...,); X (nfeat, nrows); y (nrows,) ->
    (...,).

    With ``rows_per_tile`` 0 (or at least nrows) and ``deterministic``
    off this is the search's scoring call (``fitness.eval_loss_trees``):
    on the card at float32, unweighted under a registry loss, the scoring
    kernel's fused mode, else its value mode followed by the loss. With
    ``deterministic`` the rows reduce by ``pairwise_sum``. With
    ``rows_per_tile`` the rows go through the value mode in tiles of that
    width, the (weighted) loss sums and weight sums accumulating tile by
    tile: the peak memory per tree is a tile's, and the sum's order is
    not the untiled one's."""
    from ..models.fitness import eval_loss_trees
    from . import kernel_eval
    from .losses import aggregate_loss, contain_nonfinite, pairwise_sum

    nrows = X.shape[1]
    tiled = 0 < rows_per_tile < nrows
    if not (tiled or deterministic):
        return eval_loss_trees(trees, X, y, weights, operators, loss_fn)
    if not tiled:
        y_pred, ok = kernel_eval.eval_trees(trees, X, operators)
        loss = aggregate_loss(loss_fn(y_pred, y), weights,
                              deterministic=True)
        return contain_nonfinite(loss, ok)
    rowsum = pairwise_sum if deterministic else (lambda v: v.sum(-1))
    num = den = None
    ok = torch.ones(trees.length.shape, dtype=torch.bool, device=X.device)
    for r0 in range(0, nrows, rows_per_tile):
        rows = slice(r0, min(r0 + rows_per_tile, nrows))
        y_pred, ok_t = kernel_eval.eval_trees(trees, X[:, rows], operators)
        elem = loss_fn(y_pred, y[rows])
        w = (torch.ones_like(y[rows]) if weights is None
             else weights[rows])
        n_t, d_t = rowsum(elem * w), rowsum(w)
        num = n_t if num is None else num + n_t
        den = d_t if den is None else den + d_t
        ok = ok & ok_t
    return contain_nonfinite(num / den, ok)


def eval_grad_constants(trees: TreeBatch, X: torch.Tensor,
                        operators: OperatorSet):
    """Each tree's values and their derivative with respect to each
    constant slot: (y (..., nrows), ok (...,), dy_dc (..., L, nrows)),
    one forward-mode pass per slot (zero for slots that hold no
    constant)."""
    L = trees.max_len
    cval = trees.cval.to(X.dtype)
    y, ok = eval_trees(trees._replace(cval=cval), X, operators)
    dy = []
    for s in range(L):
        tangent = torch.zeros_like(cval)
        tangent[..., s] = 1.0
        _, d = torch.func.jvp(
            lambda c: eval_trees(trees._replace(cval=c), X, operators)[0],
            (cval,), (tangent,))
        dy.append(d)
    return y, ok, torch.stack(dy, dim=-2)


def eval_grad_variables(tree: TreeBatch, X: torch.Tensor,
                        operators: OperatorSet):
    """A single tree's values and the gradient of their sum with respect
    to X: (y (nrows,), dy_dX (nfeat, nrows))."""
    Xv = X.detach().requires_grad_(True)
    with torch.enable_grad():
        y, _ = _eval_single(tree, Xv, operators)
        (g,) = torch.autograd.grad(y.sum(), Xv)
    return y.detach(), g


def eval_diff_tree(tree: TreeBatch, X: torch.Tensor, operators: OperatorSet,
                   direction: int):
    """Forward-mode derivative of a single tree's values with respect to
    feature ``direction``: (y (nrows,), dy_dx (nrows,), ok)."""
    tangent = torch.zeros_like(X)
    tangent[direction] = 1.0
    y, dy, ok = torch.func.jvp(lambda Xv: _eval_single(tree, Xv, operators),
                               (X,), (tangent,), has_aux=True)
    return y, dy, ok
