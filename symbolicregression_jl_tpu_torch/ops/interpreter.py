"""Lockstep postfix stack machine, in plain PyTorch.

Counterpart of ``symbolicregression_jl_tpu/ops/interpreter.py``: all trees
advance slot by slot together; at each slot every operator is applied to
the current stack tops and the result is selected by opcode (the
``_slot_step`` semantics). Any non-finite value produced at a non-PAD slot
marks the tree incomplete (``ok=False``).

This is the portable oracle for the kernel's plain version
(``ops/kernel_eval.py``), which evaluates through the operand schedule
instead of a stack.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..models.trees import ARITY, BIN, CONST, PAD, UNA, VAR, TreeBatch
from .operators import OperatorSet


def _slot_step(stack, sp, bad, k, o, f, c, X, operators: OperatorSet):
    """One step for a flat batch: stack (D, T, R), sp (T,), bad (T, R);
    node fields k/o/f/c are (T,)."""
    D, T, R = stack.shape
    ar = torch.as_tensor(ARITY, device=k.device)[k]
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


def eval_tree(tree: TreeBatch, X: torch.Tensor,
              operators: OperatorSet) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single tree (batch shape ()) -> (y (nrows,), ok)."""
    y, ok = eval_trees(tree.map(lambda x: x.unsqueeze(0)), X, operators)
    return y[0], ok[0]
