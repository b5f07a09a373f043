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
card, ``ops/interpreter.py``).

Several datasets of one shape are scored in one call: X (S, nfeat,
nrows), y and weights (S, nrows), the trees' flat order set-major (the
kernels' per-set form; a tenant-batched search's tenants, or each island's
minibatch). Each set's losses are those of a call on that set alone, bit
for bit: the weighted mean divides by each set's own weight sum, a fixed-
order sum (``ops/losses.py`` ``weight_sum``) that a solo call takes too. The baseline may be a per-tenant vector (T,), read by
each of the T tenant-major blocks of trees. With per-island minibatches
(``row_idx`` of shape (islands, batch)) ``score_trees_islands`` gathers
each island's rows on the device into one such call. The instruction
programs and a custom objective have no per-set form: they make one call
per set.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from ..ops import kernel_eval, kernel_instr
from ..ops.losses import (aggregate_loss, contain_nonfinite, resolve_loss,
                          weight_sum)
from ..ops.user_ops import kernel_loss
from ..ops.operators import OperatorSet
from ..utils import rng
from .complexity import compute_complexity
from .options import Options, scalar_tensor
from .trees import TreeBatch


def _per_set(fn, trees: TreeBatch, X: torch.Tensor, *rows):
    """``fn(trees_s, X_s, *rows_s)`` on each set of a set-major batch (X
    (S, nfeat, nrows), each of ``rows`` (S, nrows) or None), the results
    concatenated in the trees' batch shape: the path for what has no per-
    set form."""
    flat = kernel_eval._flatten(trees)
    S = X.shape[0]
    per = flat.length.shape[0] // S
    outs = [fn(flat.map(lambda f: f[s * per:(s + 1) * per]), X[s],
               *(None if r is None else r[s] for r in rows))
            for s in range(S)]
    shape = trees.length.shape
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(o).reshape(shape + o[0].shape[1:])
                     for o in zip(*outs))
    return torch.cat(outs).reshape(shape + outs[0].shape[1:])


def take_rows(X: torch.Tensor, y: torch.Tensor,
              weights: Optional[torch.Tensor], row_idx: torch.Tensor):
    """The rows ``row_idx`` of a dataset on the device: (X, y, weights).
    For X (nfeat, nrows), ``row_idx`` (batch,) gives the same shapes and
    (sets, batch) the per-set form, one minibatch per set; for X (T,
    nfeat, nrows) of T datasets, ``row_idx`` (T, batch) takes each
    dataset's own rows and (T, I, batch) I minibatches of each, as T * I
    sets in that order."""
    if X.dim() == 2:
        Xb = X[:, row_idx]
        if row_idx.dim() == 2:
            Xb = Xb.movedim(1, 0).contiguous()
        return (Xb, y[row_idx],
                None if weights is None else weights[row_idx])
    T, nfeat, _ = X.shape
    idx = row_idx.reshape(T, -1)
    Xb = torch.gather(X, 2, idx.unsqueeze(1).expand(T, nfeat, idx.shape[1]))
    yb = torch.gather(y, 1, idx)
    wb = None if weights is None else torch.gather(weights, 1, idx)
    if row_idx.dim() == 3:  # (T, I, batch) -> T * I sets
        I, batch = row_idx.shape[1:]
        Xb = Xb.reshape(T, nfeat, I, batch).movedim(2, 1).reshape(
            T * I, nfeat, batch)
        yb = yb.reshape(T * I, batch)
        wb = None if wb is None else wb.reshape(T * I, batch)
    return Xb.contiguous(), yb, wb


def dispatch_eval(trees: TreeBatch, X: torch.Tensor, operators: OperatorSet,
                  program: str = "auto"):
    """Value mode of the chosen program: (y (..., nrows), ok (...,)). X
    (S, nfeat, nrows): the postfix kernel's per-set launch; the
    instruction programs one call per set."""
    if program in ("instr", "instr_packed"):
        if X.dim() == 3:
            return _per_set(lambda t, x: dispatch_eval(t, x, operators,
                                                       program), trees, X)
        return kernel_instr.eval_trees_instr(trees, X, operators,
                                             packed=program == "instr_packed")
    return kernel_eval.eval_trees(trees, X, operators)


def aggregate_sets(elem: torch.Tensor, weights: Optional[torch.Tensor],
                   X: torch.Tensor) -> torch.Tensor:
    """``aggregate_loss`` over the last axis of ``elem`` (..., nrows), the
    trees of ``elem``'s flattened leading axes set-major over X's sets
    when X is (S, nfeat, nrows). A weighted mean divides by its set's
    ``weight_sum``, whose bits do not depend on the number of sets, so a
    set's losses are those of a call on that set alone; all sets' sums
    take one pass of elementwise adds."""
    if weights is None:
        return aggregate_loss(elem, None)
    if X.dim() == 2:
        return torch.sum(elem * weights, dim=-1) / weight_sum(weights)
    flat = elem.reshape(-1, elem.shape[-1])
    sid = kernel_eval.set_index(flat.shape[0], X)
    return (torch.sum(flat * weights[sid], dim=-1)
            / weight_sum(weights)[sid]).reshape(elem.shape[:-1])


def eval_loss_trees(trees: TreeBatch, X: torch.Tensor, y: torch.Tensor,
                    weights: Optional[torch.Tensor], operators: OperatorSet,
                    loss, row_idx: Optional[torch.Tensor] = None,
                    program: str = "auto") -> torch.Tensor:
    """Per-tree aggregated loss over all rows (or the ``row_idx``
    minibatch, ``take_rows``); +inf where the evaluation left the finite
    domain. X (S, nfeat, nrows) with y and weights (S, nrows): S datasets,
    the trees' flat order set-major."""
    if row_idx is not None:
        X, y, weights = take_rows(X, y, weights, row_idx)
    loss_fn = resolve_loss(loss)
    fused = kernel_loss(loss_fn)  # None for a callable that does not trace
    if (program in ("auto", "postfix") and weights is None
            and X.dtype == torch.float32 and fused is not None):
        return kernel_eval.eval_loss_trees(trees, X, y, operators, fused)
    y_pred, ok = dispatch_eval(trees, X, operators, program)
    if X.dim() == 3:
        sid = kernel_eval.set_index(ok.numel(), X)
        y = y[sid].reshape(y_pred.shape)
    elem = loss_fn(y_pred, y)
    return contain_nonfinite(aggregate_sets(elem, weights, X), ok)


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
    ``baseline`` is a Python number, a 0-dim device tensor (float64 at
    float64), or a (T,) device tensor of T tenants' baselines, the losses
    T tenant-major blocks."""
    parsimony = scalar_tensor(options.parsimony, loss.device).to(loss.dtype)
    # a Python number as a device scalar: CUDA divides by a host scalar as
    # a multiplication by its reciprocal, which rounds differently
    baseline = scalar_tensor(baseline, loss.device, score_dtype(loss.dtype))
    if baseline.dim() == 1:
        # one per tenant, each read by its block of tenant-major losses
        baseline = baseline.repeat_interleave(
            loss.numel() // baseline.shape[0]).reshape(loss.shape)
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
    X's dtype. X (S, nfeat, nrows): one call per set."""
    if row_idx is not None:
        X, y, weights = take_rows(X, y, weights, row_idx)
    if X.dim() == 3:
        return _per_set(lambda t, x, yy, w: _custom_loss_trees(
            t, x, yy, w, options), trees, X, y, weights)
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
    on its own minibatch ``row_idx`` (I, batch), or of a tenant-batched
    search's T * I islands on ``row_idx`` (T, I, batch) over X (T, nfeat,
    nrows): the rows gathered on the device into one set per island
    (``take_rows``), then one ``score_trees`` call over the sets (the JAX
    package vmaps ``score_trees`` over the islands). On the card that is
    one launch of the per-set form: the fused mode at float32 unweighted,
    else the value mode and the loss."""
    Xs, ys, ws = take_rows(X, y, weights, row_idx)
    s, l = score_trees(kernel_eval._flatten(trees), Xs, ys, ws, baseline,
                       options)
    shape = trees.length.shape
    return s.reshape(shape), l.reshape(shape)


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
