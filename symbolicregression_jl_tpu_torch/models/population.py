"""Population & HallOfFame state, tournament selection, hall-of-fame merge
and the Pareto frontier (counterpart of
``symbolicregression_jl_tpu/models/population.py``).

State is a NamedTuple of tensors; every function is batched over any
leading (island) dims, which replaces the JAX package's vmap.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ..utils import rng
from .complexity import compute_complexity
from .fitness import score_trees
from .mutate_device import gen_random_tree_fixed_size
from .options import Options, scalar_tensor
from .parsimony import normalize
from .trees import TreeBatch, empty_trees, where_trees


class Population(NamedTuple):
    trees: TreeBatch  # fields (..., npop, L)
    scores: torch.Tensor  # (..., npop)
    losses: torch.Tensor  # (..., npop)
    birth: torch.Tensor  # (..., npop) int64

    @property
    def npop(self) -> int:
        return self.scores.shape[-1]


class HallOfFame(NamedTuple):
    """One slot per complexity 1..actual_maxsize."""

    trees: TreeBatch  # fields (..., S, L)
    scores: torch.Tensor  # (..., S)
    losses: torch.Tensor  # (..., S)
    exists: torch.Tensor  # (..., S) bool


def gather_trees(trees: TreeBatch, idx: torch.Tensor) -> TreeBatch:
    """Per-batch-row gather along the member axis: trees fields
    (B, M, L) / (B, M), idx (B, K) -> (B, K, L) / (B, K)."""
    L = trees.max_len
    ix = idx.unsqueeze(-1).expand(idx.shape + (L,))
    return TreeBatch(
        torch.gather(trees.kind, -2, ix), torch.gather(trees.op, -2, ix),
        torch.gather(trees.feat, -2, ix), torch.gather(trees.cval, -2, ix),
        torch.gather(trees.length, -1, idx),
    )


def init_hall_of_fame(options: Options, batch_shape=(), device="cuda") -> HallOfFame:
    """Empty halls of fame, losses, scores and constants in the working
    dtype."""
    S = options.actual_maxsize
    shape = tuple(batch_shape) + (S,)
    inf = torch.full(shape, float("inf"), dtype=options.dtype, device=device)
    return HallOfFame(
        trees=empty_trees(shape, options.max_len, device, options.dtype),
        scores=inf, losses=inf.clone(),
        exists=torch.zeros(shape, dtype=torch.bool, device=device),
    )


def init_population(keys: torch.Tensor, options: Options, nfeatures: int,
                    X, y, weights, baseline: float, nlength: int = 3
                    ) -> Population:
    """Random initial populations of small trees, one per island key
    (``keys`` (I, 2)): each member grows from ``split(key, npop)`` as in
    the reference; all islands scored in one call; constants, losses and
    scores in the working dtype."""
    dev = X.device
    n_islands = keys.shape[0]
    n = n_islands * options.npop
    member_keys = rng.split(keys, options.npop).reshape(n, 2)
    trees = gen_random_tree_fixed_size(
        member_keys, torch.full((n,), nlength, dtype=torch.int64, device=dev),
        nfeatures, options.operators, options.max_len, options.dtype)
    scores, losses = score_trees(trees, X, y, weights, baseline, options)
    shape = (n_islands, options.npop)
    return Population(
        trees=trees.map(lambda x: x.reshape(shape + x.shape[1:])),
        scores=scores.reshape(shape), losses=losses.reshape(shape),
        birth=torch.arange(options.npop, device=dev).expand(shape).clone(),
    )


def tournament_logits(options: Options, device) -> torch.Tensor:
    """(n,) float32 log-probabilities p(1-p)^k of picking the k-th best of
    a tournament: ``k * log1p(-p) + log(p)``."""
    n = options.tournament_selection_n
    # a traced scalar: float32 tensor math on the card, as in the JAX package
    p = torch.clamp_max(scalar_tensor(options.tournament_selection_p, device),
                        1 - 1e-6)
    ranks = torch.arange(n, device=device, dtype=torch.float32)
    return ranks * torch.log1p(-p) + torch.log(p)


def tournament_draws(p: rng.DrawPlan, node: int, tag: tuple, npop: int,
                     n: int, axis: int = 0) -> None:
    """A tournament's draws from ``node``'s key: the permutation's 32-bit
    draws and the pick's gumbels (their elements spread over ``axis``)."""
    k = p.split(node, 2)
    rng.permutation_draws(p, k[0], tag + ("perm",), npop, axis)
    p.gumbel(tag + ("pick",), k[1], (n,), torch.float32, axis)


@functools.lru_cache(maxsize=None)
def tournament_plan(npop: int, n: int) -> rng.DrawPlan:
    p = rng.DrawPlan("tournament", axes=(rng.SPREAD,))
    tournament_draws(p, p.root, ("tour",), npop, n, 1)
    return p


def tournament_winner(keys: torch.Tensor, pop: Population,
                      stats_frequencies: torch.Tensor, options: Options,
                      complexity: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """One tournament per key (``keys`` (I, B, 2)) on every island: sample
    tournament_selection_n members without replacement, reweight scores by
    the adaptive-parsimony frequency, pick the k-th best with probability
    p(1-p)^k. pop fields (I, npop); returns winner indices (I, B)."""
    d = tournament_plan(pop.npop, options.tournament_selection_n).run(keys)
    return tournament_from(d, ("tour",), pop, stats_frequencies, options,
                           complexity)


def tournament_from(d: rng.Drawn, tag: tuple, pop: Population,
                    stats_frequencies: torch.Tensor, options: Options,
                    complexity: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """``tournament_winner`` from the draws ``tournament_draws`` made, one
    tournament per key: (I, B)."""
    I, npop = pop.scores.shape
    dev = pop.scores.device
    n = options.tournament_selection_n
    idx = rng.permutation_of(d, tag + ("perm",), npop)[..., :n]
    n_tournaments = idx.shape[1]
    flat_idx = idx.reshape(I, -1)
    scores = torch.gather(pop.scores, -1, flat_idx).reshape(I, n_tournaments, n)
    if options.use_frequency_in_tournament:
        if complexity is None:
            complexity = compute_complexity(pop.trees, options)
        c = torch.gather(complexity, -1, flat_idx).reshape(I, n_tournaments, n)
        S = stats_frequencies.shape[-1]
        norm = normalize(stats_frequencies)  # (I, S)
        freq = torch.gather(norm, -1, (c - 1).clamp(0, S - 1).reshape(I, -1))
        freq = freq.reshape(I, n_tournaments, n)
        in_range = (c > 0) & (c <= options.maxsize)
        freq = torch.where(in_range, freq, 0.0)
        scores = scores * torch.exp(options.adaptive_parsimony_scaling * freq)
    order = torch.argsort(scores, dim=-1, stable=True)
    pick = torch.argmax(d[tag + ("pick",)] + tournament_logits(options, dev),
                        dim=-1)
    winner_pos = torch.gather(order, -1, pick.unsqueeze(-1))
    return torch.gather(idx, -1, winner_pos).squeeze(-1)


def best_sub_pop(pop: Population, topn: int
                 ) -> Tuple[TreeBatch, torch.Tensor, torch.Tensor]:
    """Top-n members by score, per island: fields (..., topn, ...)."""
    order = torch.argsort(pop.scores, dim=-1, stable=True)[..., :topn]
    if order.dim() == 1:
        return pop.trees[order], pop.scores[order], pop.losses[order]
    return (gather_trees(pop.trees, order),
            torch.gather(pop.scores, -1, order),
            torch.gather(pop.losses, -1, order))


def update_hall_of_fame(hof: HallOfFame, trees: TreeBatch, scores, losses,
                        options: Options) -> HallOfFame:
    """Merge candidates (..., B) into the per-complexity best table
    (..., S): each slot keeps the lowest-loss candidate of its complexity
    when it beats the incumbent."""
    S = options.actual_maxsize
    complexity = compute_complexity(trees, options)  # (..., B)
    slot = (complexity - 1).clamp(0, S - 1)
    in_range = (complexity >= 1) & (complexity <= S) & torch.isfinite(losses)
    slots = torch.arange(S, device=losses.device).unsqueeze(-1)  # (S, 1)
    masked = torch.where(in_range.unsqueeze(-2) & (slot.unsqueeze(-2) == slots),
                         losses.unsqueeze(-2), float("inf"))  # (..., S, B)
    best_idx = torch.argmin(masked, dim=-1)  # (..., S)
    best_loss = torch.gather(masked, -1, best_idx.unsqueeze(-1)).squeeze(-1)
    better = best_loss < hof.losses
    lead = best_idx.shape[:-1]
    if not lead:
        cand = trees[best_idx]
        cand_scores = scores[best_idx]
    else:
        flat_trees = trees.map(lambda x: x.reshape((-1,) + x.shape[len(lead):]))
        cand = gather_trees(flat_trees, best_idx.reshape(-1, S))
        cand = cand.map(lambda x: x.reshape(lead + x.shape[1:]))
        cand_scores = torch.gather(scores, -1, best_idx)
    return HallOfFame(
        trees=where_trees(better, cand, hof.trees),
        scores=torch.where(better, cand_scores, hof.scores),
        losses=torch.where(better, best_loss, hof.losses),
        exists=hof.exists | better,
    )


def merge_halls_of_fame(a: HallOfFame, b: HallOfFame) -> HallOfFame:
    """Per-slot min-loss merge."""
    better = torch.where(b.exists & ~a.exists, True, b.losses < a.losses)
    return HallOfFame(
        trees=where_trees(better, b.trees, a.trees),
        scores=torch.where(better, b.scores, a.scores),
        losses=torch.where(better, b.losses, a.losses),
        exists=a.exists | b.exists,
    )


def calculate_pareto_frontier(hof: HallOfFame) -> torch.Tensor:
    """Slots whose loss is strictly better than every smaller-complexity
    slot."""
    losses = torch.where(hof.exists, hof.losses, float("inf"))
    best_so_far = torch.cummin(losses, dim=-1).values
    prev = torch.cat([torch.full_like(best_so_far[..., :1], float("inf")),
                      best_so_far[..., :-1]], dim=-1)
    return hof.exists & (losses < prev)
