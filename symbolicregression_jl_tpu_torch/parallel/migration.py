"""Inter-island migration and the cross-island hall-of-fame merge on one
device (counterpart of the single-device parts of
``symbolicregression_jl_tpu/parallel/migration.py``)."""

from __future__ import annotations

import torch

from ..models.evolve import IslandState
from ..models.options import Options
from ..models.population import (
    HallOfFame,
    Population,
    best_sub_pop,
    calculate_pareto_frontier,
)
from ..models.trees import TreeBatch
from ..utils import rng


def migrate(key: torch.Tensor, states: IslandState, global_hof: HallOfFame,
            options: Options) -> IslandState:
    """Replace random members of every island with members of the pooled
    top-n of all islands (probability fraction_replaced each) or with
    Pareto-front hall-of-fame members (fraction_replaced_hof), drawn from
    ``key`` (2,) split in four as the reference does."""
    if not options.migration:
        return states
    I, npop = states.pop.scores.shape
    dev = states.pop.scores.device
    topn = min(options.topn, npop)
    pool_trees, pool_scores, pool_losses = best_sub_pop(states.pop, topn)
    flat = lambda x: x.reshape((-1,) + x.shape[2:])
    pool_trees = pool_trees.map(flat)
    pool_scores, pool_losses = flat(pool_scores), flat(pool_losses)

    k = rng.split(key, 4)
    # the two fractions are traced scalars: float32 draws, as the
    # reference's bound Options give
    replace_pool = rng.bernoulli(k[0], options.fraction_replaced, (I, npop),
                                 torch.float32)
    choice_pool = rng.randint(k[1], (I, npop), 0, I * topn)
    front = calculate_pareto_frontier(global_hof)
    logits = torch.where(front, 0.0, -1e9).to(rng.draw_dtype(options.dtype))
    choice_hof = rng.categorical(k[2], logits.unsqueeze(0), (I, npop))
    replace_hof = (rng.bernoulli(k[3], options.fraction_replaced_hof,
                                 (I, npop), torch.float32)
                   & front.any() & options.hof_migration)

    def blend(member, pool, hof):
        extra = (1,) * (member.dim() - 2)
        rp = replace_pool.reshape(replace_pool.shape + extra)
        rh = replace_hof.reshape(replace_hof.shape + extra)
        return torch.where(rh, hof[choice_hof],
                           torch.where(rp, pool[choice_pool], member))

    migrated = replace_pool | replace_hof
    new_birth = torch.where(
        migrated,
        states.birth_counter.unsqueeze(-1) + torch.arange(npop, device=dev),
        states.pop.birth)
    return states._replace(
        pop=Population(
            trees=TreeBatch(*(blend(m, p, h) for m, p, h in
                              zip(states.pop.trees, pool_trees, global_hof.trees))),
            scores=blend(states.pop.scores, pool_scores, global_hof.scores),
            losses=blend(states.pop.losses, pool_losses, global_hof.losses),
            birth=new_birth,
        ),
        birth_counter=states.birth_counter + npop,
    )


def merge_hofs_across_islands(hofs: HallOfFame) -> HallOfFame:
    """Per-slot argmin-loss across the leading islands axis."""
    masked = torch.where(hofs.exists, hofs.losses, float("inf"))  # (I, S)
    best_i = torch.argmin(masked, dim=0)  # (S,)

    def pick(x):
        ix = best_i.reshape((1, -1) + (1,) * (x.dim() - 2)).expand(
            (1,) + x.shape[1:])
        return torch.gather(x, 0, ix)[0]

    return HallOfFame(
        trees=hofs.trees.map(pick),
        scores=pick(hofs.scores),
        losses=pick(hofs.losses),
        exists=hofs.exists.any(dim=0),
    )
