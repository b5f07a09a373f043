"""Inter-island migration and the cross-island hall-of-fame merge on one
device (counterpart of the single-device parts of
``symbolicregression_jl_tpu/parallel/migration.py``).

A tenant-batched search (``serving/batched.py``) holds T tenants' islands
tenant-major on one island axis; both act within each tenant's islands,
from each tenant's own key, as its solo search does (the reference vmaps
them over the tenants)."""

from __future__ import annotations

import torch

from ..models.evolve import IslandState, _map_tensors
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
    ``key`` (2,) split in four as the reference does. With ``key`` (T, 2)
    and ``global_hof`` (T, ...), the islands are T tenants' blocks: each
    tenant's pool, hall of fame and draws are its own."""
    if not options.migration:
        return states
    solo = key.dim() == 1
    keys = key.unsqueeze(0) if solo else key
    if solo:
        global_hof = _map_tensors(lambda x: x.unsqueeze(0), global_hof)
    T = keys.shape[0]
    TI, npop = states.pop.scores.shape
    I = TI // T
    S = global_hof.losses.shape[-1]
    dev = states.pop.scores.device
    topn = min(options.topn, npop)
    pool_trees, pool_scores, pool_losses = best_sub_pop(states.pop, topn)
    flat = lambda x: x.reshape((-1,) + x.shape[2:])  # every tenant's pool
    pool_trees = pool_trees.map(flat)
    pool_scores, pool_losses = flat(pool_scores), flat(pool_losses)
    hof = _map_tensors(flat, global_hof)

    k = rng.split(keys, 4)
    # the two fractions are traced scalars: float32 draws, as the
    # reference's bound Options give
    replace_pool = rng.bernoulli(k[:, 0], options.fraction_replaced,
                                 (I, npop), torch.float32)
    choice_pool = rng.randint(k[:, 1], (I, npop), 0, I * topn)
    front = calculate_pareto_frontier(global_hof)  # (T, S)
    logits = torch.where(front, 0.0, -1e9).to(rng.draw_dtype(options.dtype))
    choice_hof = rng.categorical(k[:, 2], logits[:, None, None, :], (I, npop))
    replace_hof = (rng.bernoulli(k[:, 3], options.fraction_replaced_hof,
                                 (I, npop), torch.float32)
                   & front.any(-1)[:, None, None] & options.hof_migration)
    # each tenant's choices into the pooled rows of every tenant
    first = torch.arange(T, device=dev)[:, None, None]
    choice_pool = (choice_pool + first * (I * topn)).reshape(TI, npop)
    choice_hof = (choice_hof + first * S).reshape(TI, npop)
    replace_pool = replace_pool.reshape(TI, npop)
    replace_hof = replace_hof.reshape(TI, npop)

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
                              zip(states.pop.trees, pool_trees, hof.trees))),
            scores=blend(states.pop.scores, pool_scores, hof.scores),
            losses=blend(states.pop.losses, pool_losses, hof.losses),
            birth=new_birth,
        ),
        birth_counter=states.birth_counter + npop,
    )


def merge_hofs_across_islands(hofs: HallOfFame, tenants: int = 0
                              ) -> HallOfFame:
    """Per-slot argmin-loss across the leading islands axis; with
    ``tenants`` T > 0, across each tenant's block of islands: (T, S)."""
    if tenants:
        hofs = _map_tensors(
            lambda x: x.reshape((tenants, -1) + x.shape[1:]), hofs)
    axis = 1 if tenants else 0
    masked = torch.where(hofs.exists, hofs.losses, float("inf"))  # (I, S)
    best_i = torch.argmin(masked, dim=axis, keepdim=True)  # (1, S)

    def pick(x):
        ix = best_i.reshape(best_i.shape + (1,) * (x.dim() - best_i.dim()))
        ix = ix.expand(x.shape[:axis] + (1,) + x.shape[axis + 1:])
        return torch.gather(x, axis, ix).squeeze(axis)

    return HallOfFame(
        trees=hofs.trees.map(pick),
        scores=pick(hofs.scores),
        losses=pick(hofs.losses),
        exists=hofs.exists.any(dim=axis),
    )
