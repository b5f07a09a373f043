"""Scoring: loss evaluation + baseline-normalised, parsimony-penalised score
(counterpart of ``symbolicregression_jl_tpu/models/fitness.py``).

Routing is by device, with no work gate: the kernel wrapper runs the CUDA
kernel for CUDA tensors and its plain version for CPU tensors. The program
is ``Options.kernel_program``: ``"auto"`` is ``"postfix"``, where
unweighted scoring under any loss of the registry (an ``ElementwiseLoss``)
takes the fused-loss epilogue, and weighted scoring and a user's own
callable take value mode followed by the loss and ``aggregate_loss``, as
the JAX package routes them; ``"instr"`` / ``"instr_packed"`` always take
the instruction program's value mode followed by the loss and
``aggregate_loss`` (it has no fused loss). The working dtype is X's: the
fused epilogue runs at float32 only, as in the JAX package; at bfloat16
and float16 scoring takes the value mode of that dtype's build, then the
loss and ``aggregate_loss`` in the working dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops import kernel_eval, kernel_instr
from ..ops.losses import (
    ElementwiseLoss, aggregate_loss, contain_nonfinite, resolve_loss,
)
from ..ops.operators import OperatorSet
from ..utils import rng
from .complexity import compute_complexity
from .options import Options, scalar_tensor
from .trees import TreeBatch


def dispatch_eval(trees: TreeBatch, X: torch.Tensor, operators: OperatorSet,
                  program: str = "auto"):
    """Value mode of the chosen program: (y (..., nrows), ok (...,))."""
    if program in ("instr", "instr_packed"):
        return kernel_instr.eval_trees_instr(trees, X, operators,
                                             packed=program == "instr_packed")
    return kernel_eval.eval_trees(trees, X, operators)


def eval_loss_trees(trees: TreeBatch, X: torch.Tensor, y: torch.Tensor,
                    weights: Optional[torch.Tensor], operators: OperatorSet,
                    loss, row_idx: Optional[torch.Tensor] = None,
                    program: str = "auto") -> torch.Tensor:
    """Per-tree aggregated loss over all rows (or the ``row_idx``
    minibatch); +inf where the evaluation left the finite domain."""
    if row_idx is not None:
        X = X[:, row_idx]
        y = y[row_idx]
        weights = None if weights is None else weights[row_idx]
    loss_fn = resolve_loss(loss)
    if (program in ("auto", "postfix") and weights is None
            and X.dtype == torch.float32
            and isinstance(loss_fn, ElementwiseLoss)):
        return kernel_eval.eval_loss_trees(trees, X, y, operators, loss_fn)
    y_pred, ok = dispatch_eval(trees, X, operators, program)
    elem = loss_fn(y_pred, y)
    return contain_nonfinite(aggregate_loss(elem, weights), ok)


def loss_to_score(loss: torch.Tensor, baseline,
                  complexity: torch.Tensor, options: Options) -> torch.Tensor:
    """score = loss/baseline + complexity*parsimony, in the loss's dtype:
    parsimony is a float32 scalar (a Python number is filled in) cast to
    it on the device, as the JAX package casts its traced parsimony.
    ``baseline`` is a Python number or a 0-dim device tensor."""
    parsimony = scalar_tensor(options.parsimony, loss.device).to(loss.dtype)
    # the quotient in float32, rounded once to the loss's dtype, whether
    # the baseline is a Python number or a float32 device scalar
    normalized = (loss.to(torch.float32) / baseline).to(loss.dtype)
    return normalized + complexity.to(loss.dtype) * parsimony


def score_trees(trees: TreeBatch, X: torch.Tensor, y: torch.Tensor,
                weights: Optional[torch.Tensor], baseline,
                options: Options, row_idx: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(score, loss) per tree."""
    loss = eval_loss_trees(trees, X, y, weights, options.operators,
                           options.loss, row_idx, options.kernel_program)
    score = loss_to_score(loss, baseline, compute_complexity(trees, options),
                          options)
    return contain_nonfinite(score, ref=loss), loss


def sample_batch_idx(gen: torch.Generator, n_rows: int, batch_size: int,
                     device) -> torch.Tensor:
    """Minibatch rows sampled with replacement."""
    return rng.randint(gen, (batch_size,), 0, n_rows, device)
