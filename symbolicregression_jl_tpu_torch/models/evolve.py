"""The evolution engine: batched regularized evolution across islands
(counterpart of ``symbolicregression_jl_tpu/models/evolve.py``).

Each cycle runs B = n_parallel_tournaments (rounded up to even)
tournaments on every island at once, mutates or crosses the winners with
up to 10 constraint retries each, scores ALL islands' children in one
kernel call, applies annealing / adaptive-parsimony acceptance, and
replaces the B oldest members of each island. The island axis is the
leading dimension of every tensor (the JAX package's vmap over islands).

The cycle step is tensor ops that never synchronise with the host: every
decision that depends on data is a ``torch.where``, every table is built
once per device, and the temperature, ``curmaxsize``, the baseline and the
Options' traced scalars are device scalars. So one step can be captured as
a CUDA graph and replayed (``models/cycle_graph.py``, the counterpart of
the JAX package's ``lax.scan`` over the schedule); ``s_r_cycle_islands``
runs the same step eagerly.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from ..utils import rng
from ..utils.device import table
from .complexity import compute_complexity
from .constant_opt import optimize_constants_islands
from .constraints import check_constraints
from .fitness import sample_batch_idx, score_trees
from .mutate_device import (
    append_random_op,
    combine_operators,
    crossover_trees,
    delete_random_op,
    gen_random_tree_fixed_size,
    insert_random_op,
    mutate_constant,
    mutate_operator,
    simplify_tree,
)
from .options import (
    ADD_NODE,
    DELETE_NODE,
    DO_NOTHING,
    INSERT_NODE,
    MUTATE_CONSTANT,
    MUTATE_OPERATOR,
    N_MUTATIONS,
    OPTIMIZE,
    RANDOMIZE,
    SIMPLIFY,
    TRACED_SCALAR_FIELDS,
    Options,
    scalar_tensor,
)
from .parsimony import (
    RunningSearchStatistics,
    init_search_statistics,
    move_window,
    normalize,
    update_frequencies,
)
from .population import (
    HallOfFame,
    Population,
    gather_trees,
    init_hall_of_fame,
    init_population,
    tournament_winner,
    update_hall_of_fame,
)
from .trees import TreeBatch, count_constants, tree_depth, where_trees

MUTATION_NAMES = (
    "mutate_constant", "mutate_operator", "add_node", "insert_node",
    "delete_node", "simplify", "randomize", "do_nothing", "optimize",
    "crossover",
)

N_RETRIES = 10


class IslandState(NamedTuple):
    """Every island's state, stacked on a leading (I,) axis. The random
    stream is a ``torch.Generator`` held by the caller, not a field."""

    pop: Population
    stats: RunningSearchStatistics
    hof: HallOfFame
    birth_counter: torch.Tensor  # (I,) int64
    num_evals: torch.Tensor  # (I,) float32
    mut_counts: torch.Tensor  # (I, len(MUTATION_NAMES), 2) proposed/accepted


def _map_tensors(fn, x):
    """``fn`` on every tensor of a nest of NamedTuples."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple):
        return type(x)(*(_map_tensors(fn, f) for f in x))
    return x


def _flat(trees: TreeBatch, nb: int = 2) -> TreeBatch:
    return trees.map(lambda x: x.reshape((-1,) + x.shape[nb:]))


def _unflat(trees: TreeBatch, shape) -> TreeBatch:
    return trees.map(lambda x: x.reshape(tuple(shape) + x.shape[1:]))


# ---------------------------------------------------------------------------
# Mutation of the tournament winners
# ---------------------------------------------------------------------------


def _adjusted_mutation_logits(trees: TreeBatch, curmaxsize,
                              options: Options) -> torch.Tensor:
    """(N, N_MUTATIONS) log-weights: mutate_constant scaled by
    min(8, #constants)/8, mutate_operator impossible without operators,
    add/insert impossible at the size or depth cap."""
    dev = trees.kind.device
    w = table(options.mutation_weights.as_tuple(), dev, torch.float32
              ).expand(trees.kind.shape[0], N_MUTATIONS)
    idx = torch.arange(trees.max_len, device=dev)
    n_const = count_constants(trees)
    n_ops = ((trees.kind >= 3) & (idx < trees.length.unsqueeze(-1))).sum(-1)
    at_cap = ((compute_complexity(trees, options) >= curmaxsize)
              | (tree_depth(trees.kind, trees.length) >= options.maxdepth))
    sel = torch.arange(N_MUTATIONS, device=dev)
    const_scale = torch.clamp_max(n_const, 8).to(torch.float32) / 8.0
    w = torch.where(sel == MUTATE_CONSTANT, w * const_scale.unsqueeze(-1), w)
    w = torch.where((sel == MUTATE_OPERATOR) & (n_ops == 0).unsqueeze(-1), 0.0, w)
    cap = at_cap.unsqueeze(-1)
    w = torch.where(((sel == ADD_NODE) | (sel == INSERT_NODE)) & cap, 0.0, w)
    return torch.where(w > 0, torch.log(torch.clamp_min(w, 1e-30)),
                       float("-inf"))


def _first_success(ok: torch.Tensor, cands: TreeBatch, fallback: TreeBatch):
    """ok (N, R) over candidates flattened (N*R); the first successful
    retry of each member, or the fallback when none succeeded."""
    N, R = ok.shape
    first = torch.argmax(ok.to(torch.int32), dim=-1)
    success = ok.any(dim=-1)
    picked = cands[torch.arange(N, device=ok.device) * R + first]
    return where_trees(success, picked, fallback), success


def _mutate_members(gen, trees: TreeBatch, temperature, curmaxsize,
                    nfeatures: int, options: Options):
    """Sample a mutation kind per member and apply it with up to
    N_RETRIES i.i.d. attempts, all attempts of all members in one batch;
    the first attempt that passes the constraints wins (the parent is kept
    when none does). Returns (tree', was_mutated, always_accept, kind)."""
    N = trees.kind.shape[0]
    dev = trees.kind.device
    ops = options.operators
    L = trees.max_len
    kind = rng.categorical(gen, _adjusted_mutation_logits(trees, curmaxsize,
                                                          options))
    rep = trees.map(lambda x: x.repeat_interleave(N_RETRIES, dim=0))
    NR = N * N_RETRIES
    true_ = torch.ones(NR, dtype=torch.bool, device=dev)
    simp, _ = simplify_tree(trees, ops)  # deterministic: once per member
    hi = torch.clamp(scalar_tensor(curmaxsize, dev, torch.int64), 1, L) + 1
    size = rng.randint_below(gen, (NR,), 1, hi, dev)
    branches = {
        MUTATE_CONSTANT: mutate_constant(
            gen, rep, temperature, options.perturbation_factor,
            options.probability_negate_constant),
        MUTATE_OPERATOR: mutate_operator(gen, rep, ops),
        ADD_NODE: append_random_op(gen, rep, nfeatures, ops),
        INSERT_NODE: insert_random_op(
            gen, rep, nfeatures, ops,
            at_root=rng.bernoulli(gen, 0.5, (NR,), dev)),
        DELETE_NODE: delete_random_op(gen, rep, nfeatures, ops),
        SIMPLIFY: (simp.map(lambda x: x.repeat_interleave(N_RETRIES, dim=0)),
                   true_),
        RANDOMIZE: (gen_random_tree_fixed_size(gen, size, nfeatures, ops, L,
                                               dev, trees.cval.dtype), true_),
    }
    kind_r = kind.repeat_interleave(N_RETRIES)
    cand, ok = rep, true_
    for k, (t, k_ok) in branches.items():
        sel = kind_r == k
        cand = where_trees(sel, t, cand)
        ok = torch.where(sel, k_ok, ok)
    ok = ok & check_constraints(cand, options, curmaxsize)
    result, success = _first_success(ok.reshape(N, N_RETRIES), cand, trees)
    was_mutated = success & (kind != DO_NOTHING) & (kind != OPTIMIZE)
    always_accept = (kind == SIMPLIFY) & success
    return result, was_mutated, always_accept, kind


def _crossover_pairs(gen, a: TreeBatch, b: TreeBatch, curmaxsize,
                     options: Options):
    """Crossover of paired trees with up to N_RETRIES attempts each."""
    P = a.kind.shape[0]
    rep = lambda t: t.map(lambda x: x.repeat_interleave(N_RETRIES, dim=0))
    ca, cb, ok = crossover_trees(gen, rep(a), rep(b))
    ok = (ok & check_constraints(ca, options, curmaxsize)
          & check_constraints(cb, options, curmaxsize))
    ok = ok.reshape(P, N_RETRIES)
    ra, success = _first_success(ok, ca, a)
    rb, _ = _first_success(ok, cb, b)
    return ra, rb, success


class _Proposed(NamedTuple):
    children: TreeBatch  # (I, B, ...)
    parents: TreeBatch  # (I, B, ...)
    parent_idx: torch.Tensor  # (I, B)
    parent_scores: torch.Tensor  # (I, B)
    was_mutated: torch.Tensor  # (I, B)
    always_accept: torch.Tensor  # (I, B)
    use_cross: torch.Tensor  # (I, B)
    kind: torch.Tensor  # (I, B)


def _propose_children(gen, states: IslandState, temperature, curmaxsize,
                      nfeatures: int, options: Options) -> _Proposed:
    """Tournaments + mutation/crossover on every island."""
    pop = states.pop
    I = pop.scores.shape[0]
    dev = pop.scores.device
    B = options.n_parallel_tournaments
    B += B % 2
    parent_idx = tournament_winner(gen, pop, states.stats.frequencies, B,
                                   options)
    parents = gather_trees(pop.trees, parent_idx)
    parent_scores = torch.gather(pop.scores, -1, parent_idx)

    mut, was_mutated, always_accept, kinds = _mutate_members(
        gen, _flat(parents), temperature, curmaxsize, nfeatures, options)
    mut = _unflat(mut, (I, B))

    ca, cb, cross_ok = _crossover_pairs(
        gen, _flat(parents[:, 0::2]), _flat(parents[:, 1::2]), curmaxsize,
        options)
    cross = TreeBatch(*(
        torch.stack([fa.reshape((I, B // 2) + fa.shape[1:]),
                     fb.reshape((I, B // 2) + fb.shape[1:])], dim=2
                    ).reshape((I, B) + fa.shape[1:])
        for fa, fb in zip(ca, cb)))
    use_cross_pair = (rng.bernoulli(gen, options.crossover_probability,
                                    (I, B // 2), dev)
                      & cross_ok.reshape(I, B // 2))
    use_cross = use_cross_pair.repeat_interleave(2, dim=-1)
    return _Proposed(
        children=where_trees(use_cross, cross, mut),
        parents=parents,
        parent_idx=parent_idx,
        parent_scores=parent_scores,
        was_mutated=was_mutated.reshape(I, B),
        always_accept=always_accept.reshape(I, B),
        use_cross=use_cross,
        kind=kinds.reshape(I, B),
    )


def _accept_mutation(gen, prop: _Proposed, child_scores, temperature,
                     frequencies, options: Options) -> torch.Tensor:
    """Annealing x adaptive-parsimony acceptance, (I, B) bool."""
    dev = child_scores.device
    prob = torch.ones_like(child_scores)
    if options.annealing:
        delta = child_scores - prop.parent_scores
        temp = torch.clamp_min(scalar_tensor(temperature, dev), 1e-6)
        prob = prob * torch.exp(-delta / (options.alpha * temp))
    if options.use_frequency:
        S = frequencies.shape[-1]
        norm = normalize(frequencies)

        def f_at(trees):
            c = compute_complexity(trees, options)
            raw = torch.gather(norm, -1, (c - 1).clamp(0, S - 1))
            in_range = (c > 0) & (c <= options.maxsize)
            return torch.where(in_range, torch.clamp_min(raw, 1e-30), 1e-6)

        prob = prob * f_at(prop.parents) / f_at(prop.children)
    accept = rng.uniform(gen, child_scores.shape, dev) < prob
    return accept & torch.isfinite(child_scores)


def _scatter_members(field: torch.Tensor, idx: torch.Tensor,
                     values: torch.Tensor) -> torch.Tensor:
    """field (I, M, ...) with rows idx (I, B) replaced by values (I, B, ...)."""
    ix = idx.reshape(idx.shape + (1,) * (field.dim() - 2)).expand_as(values)
    return field.scatter(1, ix, values)


def _integrate_children(gen, states: IslandState, prop: _Proposed,
                        child_scores, child_losses, temperature, n_rows: int,
                        options: Options) -> IslandState:
    """Acceptance + replace-oldest + statistics on every island."""
    pop, stats = states.pop, states.stats
    I, B = child_scores.shape
    accept = _accept_mutation(gen, prop, child_scores, temperature,
                              stats.frequencies, options)
    accept = accept | prop.use_cross | (prop.always_accept & ~prop.use_cross)
    accept = accept & (prop.was_mutated | prop.use_cross)

    final = where_trees(accept, prop.children, prop.parents)
    final_scores = torch.where(accept, child_scores, prop.parent_scores)
    final_losses = torch.where(accept, child_losses,
                               torch.gather(pop.losses, -1, prop.parent_idx))

    oldest = torch.argsort(pop.birth, dim=-1, stable=True)[:, :B]
    new_trees = TreeBatch(*(_scatter_members(f, oldest, v)
                            for f, v in zip(pop.trees, final)))
    dev = child_scores.device
    new_birth = pop.birth.scatter(
        1, oldest, states.birth_counter.unsqueeze(-1) + torch.arange(B, device=dev))
    new_pop = Population(
        trees=new_trees,
        scores=pop.scores.scatter(1, oldest, final_scores),
        losses=pop.losses.scatter(1, oldest, final_losses),
        birth=new_birth,
    )
    new_stats = update_frequencies(stats, compute_complexity(final, options))
    new_hof = update_hall_of_fame(states.hof, final, final_scores,
                                  final_losses, options)
    eval_fraction = options.batch_size / n_rows if options.batching else 1.0

    n_kinds = len(MUTATION_NAMES)
    row = torch.where(prop.use_cross, n_kinds - 1, prop.kind)
    noop = ~prop.use_cross & (prop.kind == DO_NOTHING)
    is_opt = ~prop.use_cross & (prop.kind == OPTIMIZE)
    zeros = torch.zeros((I, n_kinds), dtype=torch.int64, device=dev)
    proposed = zeros.scatter_add(1, row, (~is_opt).to(torch.int64))
    accepted = zeros.scatter_add(1, row, ((accept | noop) & ~is_opt).to(torch.int64))
    return IslandState(
        pop=new_pop,
        stats=new_stats,
        hof=new_hof,
        birth_counter=states.birth_counter + B,
        num_evals=states.num_evals + B * eval_fraction,
        mut_counts=states.mut_counts + torch.stack([proposed, accepted], -1),
    )


def reg_evol_cycle_islands(gen, states: IslandState, temperature, curmaxsize,
                           X, y, weights, baseline, options: Options,
                           row_idx: Optional[torch.Tensor] = None) -> IslandState:
    """One cycle on every island; all islands' children are scored in ONE
    flat call (full data, or the shared ``row_idx`` minibatch)."""
    nfeatures = X.shape[0]
    prop = _propose_children(gen, states, temperature, curmaxsize, nfeatures,
                             options)
    I, B = prop.parent_scores.shape
    s, l = score_trees(_flat(prop.children), X, y, weights, baseline, options,
                       row_idx)
    return _integrate_children(gen, states, prop, s.reshape(I, B),
                               l.reshape(I, B), temperature, X.shape[1],
                               options)


def cycle_step(gen, states: IslandState, temperature, curmaxsize, X, y,
               weights, baseline, options: Options) -> IslandState:
    """One step of the cycle loop: with batching, a fresh minibatch shared
    by all islands, then ``reg_evol_cycle_islands``. The step that
    ``s_r_cycle_islands`` runs eagerly and ``cycle_graph`` captures."""
    row_idx = (sample_batch_idx(gen, X.shape[1], options.batch_size, X.device)
               if options.batching else None)
    return reg_evol_cycle_islands(gen, states, temperature, curmaxsize, X, y,
                                  weights, baseline, options, row_idx)


@functools.lru_cache(maxsize=64)
def temperature_schedule(ncycles: int, annealing: bool,
                         device: torch.device) -> torch.Tensor:
    """The annealing schedule LinRange(1, 0, ncycles) as float32 on the
    device, built once (the JAX package's ``jnp.linspace(1, 0, n,
    float32)``); all ones without annealing or with one cycle."""
    if annealing and ncycles > 1:
        return torch.linspace(1.0, 0.0, ncycles, dtype=torch.float32,
                              device=device)
    return torch.ones(ncycles, dtype=torch.float32, device=device)


def bind_device_scalars(options: Options, device) -> Options:
    """``options`` with its traced scalars as float32 device scalars (each
    a fill, no copy from the host); unchanged when they already are."""
    if all(isinstance(getattr(options, f), torch.Tensor)
           for f in TRACED_SCALAR_FIELDS):
        return options
    return options.bind_scalars(options.traced_scalars(device))


def s_r_cycle_islands(gen, states: IslandState, curmaxsize, X, y, weights,
                      baseline, options: Options,
                      ncycles: Optional[int] = None) -> IslandState:
    """ncycles evolution cycles over the annealing schedule LinRange(1, 0),
    then the once-per-iteration adaptive-parsimony window decay, run
    eagerly. The temperature, ``curmaxsize``, ``baseline`` and the traced
    scalars go to every step as device scalars, as ``cycle_graph`` gives
    them to its captured step, so both compute the same bits."""
    ncycles = ncycles or options.ncycles_per_iteration
    dev = X.device
    temps = temperature_schedule(ncycles, options.annealing, dev)
    options = bind_device_scalars(options, dev)
    cm = scalar_tensor(curmaxsize, dev, torch.int64)
    base = scalar_tensor(baseline, dev)
    for c in range(ncycles):
        states = cycle_step(gen, states, temps[c], cm, X, y, weights, base,
                            options)
    return states._replace(stats=move_window(states.stats))


def simplify_population_islands(states: IslandState, curmaxsize, X, y,
                                weights, baseline: float,
                                options: Options) -> IslandState:
    """Simplify every member of every island, rescore on the full data in
    one call, and fold the results into each island's hall of fame."""
    I, npop = states.pop.scores.shape
    flat = _flat(states.pop.trees)
    flat, _ = simplify_tree(flat, options.operators)
    flat, _ = combine_operators(flat, options.operators)
    s, l = score_trees(flat, X, y, weights, baseline, options)
    trees = _unflat(flat, (I, npop))
    scores, losses = s.reshape(I, npop), l.reshape(I, npop)
    return states._replace(
        pop=states.pop._replace(trees=trees, scores=scores, losses=losses),
        hof=update_hall_of_fame(states.hof, trees, scores, losses, options),
        num_evals=states.num_evals + npop,
    )


def optimize_islands_constants(gen, states: IslandState, X, y, weights,
                               baseline: float, options: Options,
                               probability: Optional[float] = None,
                               count_optimize_telemetry: bool = False
                               ) -> IslandState:
    """Constant-optimise every island's population in one batch and fold
    the improved members into each island's hall of fame. With
    ``count_optimize_telemetry`` (the ``optimize``-mutation pass) the
    attempted / improved counts land in the OPTIMIZE row of
    ``mut_counts``."""
    pops, n_evals, n_attempted = optimize_constants_islands(
        gen, states.pop, X, y, weights, baseline, options, probability)
    return fold_optimized(states, pops, n_evals, n_attempted, options,
                          count_optimize_telemetry)


def fold_optimized(states: IslandState, pops: Population, n_evals,
                   n_attempted, options: Options,
                   count_optimize_telemetry: bool = False) -> IslandState:
    """The islands' state after an optimisation pass returned ``pops``."""
    counts = states.mut_counts
    if count_optimize_telemetry:
        n_improved = (pops.losses < states.pop.losses).sum(-1)
        counts = counts.clone()
        counts[:, OPTIMIZE, 0] += n_attempted
        counts[:, OPTIMIZE, 1] += n_improved
    return states._replace(
        pop=pops,
        hof=update_hall_of_fame(states.hof, pops.trees, pops.scores,
                                pops.losses, options),
        num_evals=states.num_evals + n_evals,
        mut_counts=counts,
    )


def optimize_island_constants(gen, state: IslandState, X, y, weights,
                              baseline: float, options: Options,
                              probability: Optional[float] = None,
                              count_optimize_telemetry: bool = False
                              ) -> IslandState:
    """The one-island form of ``optimize_islands_constants``."""
    out = optimize_islands_constants(
        gen, _map_tensors(lambda x: x.unsqueeze(0), state), X, y, weights,
        baseline, options, probability, count_optimize_telemetry)
    return _map_tensors(lambda x: x[0], out)


def expected_optimize_count(options: Options) -> float:
    """Expected ``optimize`` mutation events per island per iteration:
    cycles x mutation slots x P(kind == optimize), crossover slots
    excluded. One iteration-level optimisation pass is sized to it."""
    w = options.mutation_weights.as_tuple()
    total = sum(w)
    if total <= 0 or w[OPTIMIZE] <= 0:
        return 0.0
    B = options.n_parallel_tournaments
    B += B % 2
    return (options.ncycles_per_iteration * B
            * (1.0 - options.crossover_probability) * w[OPTIMIZE] / total)


def init_island_state(gen, options: Options, nfeatures: int, X, y, weights,
                      baseline: float, n_islands: int) -> IslandState:
    dev = X.device
    pop = init_population(gen, options, nfeatures, X, y, weights, baseline,
                          n_islands)
    return IslandState(
        pop=pop,
        stats=init_search_statistics(options.actual_maxsize, (n_islands,), dev),
        hof=init_hall_of_fame(options, (n_islands,), dev),
        birth_counter=torch.full((n_islands,), options.npop, dtype=torch.int64,
                                 device=dev),
        num_evals=torch.full((n_islands,), float(options.npop), device=dev),
        mut_counts=torch.zeros((n_islands, len(MUTATION_NAMES), 2),
                               dtype=torch.int64, device=dev),
    )
