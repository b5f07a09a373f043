"""Scoring: loss evaluation + baseline-normalised, parsimony-penalised score
(counterpart of ``symbolicregression_jl_tpu/models/fitness.py``).

Routing is by device, with no work gate: the kernel wrapper runs the CUDA
kernel for CUDA tensors and its plain version for CPU tensors. The program
is ``Options.kernel_program``: ``"auto"`` is ``"postfix"``, where
unweighted scoring under any loss of the registry (an ``ElementwiseLoss``)
or a callable of the user's own that the tracer lowers (a ``UserLoss``,
``ops/user_ops.py``) takes the fused-loss epilogue, as the JAX package
fuses any ``loss_fn``, and weighted scoring and a callable the tracer
cannot lower take value mode followed by the loss and ``aggregate_loss``; ``"instr"`` / ``"instr_packed"`` always take
the instruction program's value mode followed by the loss and
``aggregate_loss`` (it has no fused loss). The working dtype is X's: the
fused epilogue runs at float32 only, as in the JAX package; at bfloat16,
float16 and float64 scoring takes the value mode of that dtype's build,
then the loss and ``aggregate_loss`` in the working dtype.

A custom full-tree objective (``Options.loss_function``) replaces all of
that: ``_custom_loss_trees`` vmaps it over the flattened population, so
each scoring call is one ``eval_tree`` batch (one value-mode launch on the
card, ``ops/interpreter.py``). With per-island minibatches (``row_idx``
of shape (islands, batch)) ``score_trees_islands`` gathers each island's
rows on the device and makes one scoring call per island.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from ..ops import kernel_eval, kernel_instr
from ..ops.losses import aggregate_loss, contain_nonfinite, resolve_loss
from ..ops.user_ops import kernel_loss
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
    fused = kernel_loss(loss_fn)  # None for a callable that does not trace
    if (program in ("auto", "postfix") and weights is None
            and X.dtype == torch.float32 and fused is not None):
        return kernel_eval.eval_loss_trees(trees, X, y, operators, fused)
    y_pred, ok = dispatch_eval(trees, X, operators, program)
    elem = loss_fn(y_pred, y)
    return contain_nonfinite(aggregate_loss(elem, weights), ok)


def score_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of the score's quotient and of the baseline's device
    scalar for the working dtype ``dtype``: float64 at float64, else
    float32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def loss_to_score(loss: torch.Tensor, baseline,
                  complexity: torch.Tensor, options: Options) -> torch.Tensor:
    """score = loss/baseline + complexity*parsimony, in the loss's dtype:
    parsimony is a float32 scalar (a Python number is filled in) cast to
    it on the device, as the JAX package casts its traced parsimony.
    ``baseline`` is a Python number or a 0-dim device tensor (float64 at
    float64)."""
    parsimony = scalar_tensor(options.parsimony, loss.device).to(loss.dtype)
    # the quotient in float32 (float64 at float64), rounded once to the
    # loss's dtype, whether the baseline is a Python number or a device
    # scalar
    normalized = (loss.to(score_dtype(loss.dtype)) / baseline).to(loss.dtype)
    return normalized + complexity.to(loss.dtype) * parsimony


def _custom_loss_trees(trees: TreeBatch, X: torch.Tensor, y: torch.Tensor,
                       weights: Optional[torch.Tensor], options: Options,
                       row_idx: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """The custom full-tree objective ``options.loss_function(tree, X, y,
    weights, options)`` of every tree, ``torch.func.vmap``-ed over the
    flattened population (the JAX package's ``_custom_loss_trees``), on
    the ``row_idx`` minibatch when given; +inf where it is not finite. In
    X's dtype."""
    if row_idx is not None:
        X = X[:, row_idx]
        y = y[row_idx]
        weights = None if weights is None else weights[row_idx]
    batch_shape = trees.length.shape
    flat = trees.map(lambda x: x.reshape((-1,) + x.shape[len(batch_shape):]))
    loss = torch.func.vmap(
        lambda t: options.loss_function(t, X, y, weights, options))(flat)
    return contain_nonfinite(loss.to(X.dtype)).reshape(batch_shape)


def score_trees(trees: TreeBatch, X: torch.Tensor, y: torch.Tensor,
                weights: Optional[torch.Tensor], baseline,
                options: Options, row_idx: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(score, loss) per tree: the custom objective's loss when
    ``options.loss_function`` is set, else the elementwise loss's."""
    if options.loss_function is not None:
        loss = _custom_loss_trees(trees, X, y, weights, options, row_idx)
    else:
        loss = eval_loss_trees(trees, X, y, weights, options.operators,
                               options.loss, row_idx, options.kernel_program)
    score = loss_to_score(loss, baseline, compute_complexity(trees, options),
                          options)
    return contain_nonfinite(score, ref=loss), loss


def score_trees_islands(trees: TreeBatch, X: torch.Tensor, y: torch.Tensor,
                        weights: Optional[torch.Tensor], baseline,
                        options: Options, row_idx: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(score, loss) (I, B) of each island's B trees (fields (I, B, ...))
    on its own minibatch ``row_idx`` (I, batch): the rows gathered on the
    device into (I, nfeat, batch), then one ``score_trees`` call per
    island (the JAX package vmaps ``score_trees`` over the islands). On
    the card each call is one launch: the fused mode at float32
    unweighted, else the value mode and the loss."""
    Xi = X[:, row_idx].movedim(1, 0).contiguous()
    yi = y[row_idx]
    wi = None if weights is None else weights[row_idx]
    out = [score_trees(trees.map(lambda f: f[i]), Xi[i], yi[i],
                       None if wi is None else wi[i], baseline, options)
           for i in range(row_idx.shape[0])]
    return (torch.stack([s for s, _ in out]),
            torch.stack([l for _, l in out]))


def sample_batch_idx(keys: torch.Tensor, n_rows: int, batch_size: int
                     ) -> torch.Tensor:
    """Minibatch rows sampled with replacement, the reference's
    ``randint(key, (batch_size,), 0, n_rows)`` of each key: (batch_size,)
    for one key, (n_islands, batch_size) for a key per island, in one
    draw."""
    return rng.randint(keys, (batch_size,), 0, n_rows)


@functools.lru_cache(maxsize=None)
def minibatch_plan(n_rows: int, batch_size: int, n_islands: int
                   ) -> rng.DrawPlan:
    """The minibatch chain's step from its key: ``split(key, 2)``, the
    second half kept as the chain's next key, the rows drawn from the
    first (or from its split per island when ``n_islands``), their
    elements spread over the last axis (rng.SPREAD)."""
    axes = (n_islands, rng.SPREAD) if n_islands else (rng.SPREAD,)
    p = rng.DrawPlan("minibatch", axes=axes)
    k = p.split(p.root, 2)
    p.keep("next", k[1])
    kb = p.fan(k[0], 1) if n_islands else k[0]
    p.randint("rows", kb, (batch_size,), 0, n_rows, axis=len(axes))
    return p


def next_minibatch(bkey: torch.Tensor, n_rows: int, batch_size: int,
                   n_islands: int = 0):
    """One step of the minibatch chain in one plan: (rows, the chain's
    next key); rows (batch_size,), or (n_islands, batch_size) with one
    minibatch per island. The rows are ``sample_batch_idx`` of the first
    half of ``split(bkey)`` (or of its split per island)."""
    d = minibatch_plan(n_rows, batch_size, n_islands).run(bkey)
    return d["rows"], d["next"]
