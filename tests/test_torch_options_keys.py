"""The port's Options compile-identity contract against the JAX package's:
every field in exactly one of GRAPH_FIELDS / TRACED_SCALAR_FIELDS /
ORCHESTRATION_FIELDS, each shared field in the class the reference gives
it, ``_graph_key`` reading the graph fields and nothing else, and
``bind_scalars`` with device tensors leaving every cycle use site
working."""

import dataclasses

import numpy as np
import pytest
import torch

from symbolicregression_jl_tpu.models import options as jopts
import symbolicregression_jl_tpu_torch as sr
from symbolicregression_jl_tpu_torch.models import evolve as tevolve
from symbolicregression_jl_tpu_torch.models.cycle_graph import _leaves
from symbolicregression_jl_tpu_torch.models import options as topts
from symbolicregression_jl_tpu_torch.models.fitness import loss_to_score
from symbolicregression_jl_tpu_torch.models.population import tournament_winner
from symbolicregression_jl_tpu_torch.parallel.migration import (
    merge_hofs_across_islands, migrate,
)
from symbolicregression_jl_tpu_torch.utils.rng import make_generator

CLASSES = ("GRAPH_FIELDS", "TRACED_SCALAR_FIELDS", "ORCHESTRATION_FIELDS")
CFG = dict(binary_operators=["+", "*"], unary_operators=["cos"], npop=16,
           npopulations=2, tournament_selection_n=6, maxsize=10,
           should_optimize_constants=False, verbosity=0)


def test_registry_complete_and_disjoint():
    actual = {f.name for f in dataclasses.fields(topts.Options)}
    declared = [set(getattr(topts, c)) for c in CLASSES]
    assert set().union(*declared) == actual
    for i in range(3):
        for j in range(i + 1, 3):
            assert not declared[i] & declared[j], (CLASSES[i], CLASSES[j])
    assert len(topts.TRACED_SCALAR_FIELDS) == len(
        sr.make_options(verbosity=0).traced_scalars("cpu"))


@pytest.mark.parametrize("cls", CLASSES)
def test_shared_fields_have_the_reference_class(cls):
    ref = set(getattr(jopts, cls))
    port = set(getattr(topts, cls))
    ref_fields = {f.name for f in dataclasses.fields(jopts.Options)}
    # every port field is a reference field, in the same class
    assert port <= ref_fields
    assert port == ref & {f.name for f in dataclasses.fields(topts.Options)}
    assert port <= ref


# a value of each field that differs from the default and that the port
# accepts; the traced scalars and orchestration fields must keep the key
ALT = dict(
    binary_operators=("+", "-"), unary_operators=("sin",), npopulations=3,
    npop=20, ncycles_per_iteration=7, tournament_selection_n=5, topn=4,
    maxsize=12, maxdepth=6, max_len=24, loss="L1DistLoss", annealing=True,
    use_frequency=False, use_frequency_in_tournament=False,
    mutation_weights=topts.MutationWeights(mutate_constant=1.0),
    crossover_probability=0.2, migration=False, hof_migration=False,
    should_optimize_constants=True, optimizer_probability=0.3,
    optimizer_nrestarts=1, optimizer_iterations=4, batching=True,
    batch_size=10, constraints={"*": (-1, 3)},
    nested_constraints={"cos": {"cos": 0}},
    complexity_of_operators={"cos": 2}, complexity_of_constants=2,
    complexity_of_variables=2, n_parallel_tournaments=4,
    kernel_program="instr", precision="bfloat16",
    parsimony=0.01, alpha=0.5, perturbation_factor=0.3,
    probability_negate_constant=0.1, adaptive_parsimony_scaling=5.0,
    tournament_selection_p=0.5, fraction_replaced=0.1,
    fraction_replaced_hof=0.2, warmup_maxsize_by=0.5,
    early_stop_condition=1e-3, timeout_in_seconds=10.0, max_evals=100,
    seed=4, verbosity=1,
)
# fields whose only accepted value is the default (the port raises for
# the others): their class is still checked above
FIXED = {"loss_function", "optimizer_algorithm", "optimizer_backend",
         "independent_island_batches", "recorder", "cache_fitness",
         "row_shards", "tenants", "telemetry", "telemetry_dir",
         "snapshot_path", "snapshot_every_dispatches"}


def test_every_field_perturbed_or_fixed():
    fields = {f.name for f in dataclasses.fields(topts.Options)}
    assert set(ALT) | FIXED == fields and not set(ALT) & FIXED


@pytest.mark.parametrize("field", sorted(ALT))
def test_key_moves_with_graph_fields_only(field):
    base = dict(CFG, npop=16, maxsize=10)
    a = sr.make_options(**base)
    b = sr.make_options(**{**base, field: ALT[field]})
    if field in topts.GRAPH_FIELDS:
        assert a._graph_key() != b._graph_key() and a != b
    else:
        assert a._graph_key() == b._graph_key()
        assert a == b and hash(a) == hash(b)


def test_traced_scalars_and_bind_scalars():
    o = sr.make_options(**CFG, alpha=0.25, parsimony=0.01)
    sc = o.traced_scalars("cpu")
    assert all(t.dtype == torch.float32 and t.dim() == 0 for t in sc)
    assert [float(t) for t in sc] == [
        float(np.float32(getattr(o, f))) for f in topts.TRACED_SCALAR_FIELDS]
    bound = o.bind_scalars(sc)
    assert bound.alpha is sc[1] and o.alpha == 0.25  # a copy, o unchanged
    assert bound == o and bound.operators is o.operators


def test_callable_loss_keyed_by_token():
    f = lambda p, t: (p - t) ** 2
    a = sr.make_options(**CFG, loss=f)
    b = sr.make_options(**CFG, loss=f)
    c = sr.make_options(**CFG, loss=lambda p, t: (p - t) ** 2)
    assert a == b and a != c


def test_bound_scalars_reach_every_cycle_use_site():
    """With every traced scalar a device tensor, one cycle (tournament,
    mutate_constant, annealing acceptance, scoring), migration and the
    score all run, and give the bits of the same step with the Python
    numbers bound by ``s_r_cycle_islands`` itself."""
    rng = np.random.default_rng(0)
    X = torch.tensor((rng.standard_normal((2, 30)) * 2).astype("f4"))
    y = X[0] * X[0]
    o = sr.make_options(**CFG, annealing=True, alpha=0.3, parsimony=0.02,
                        tournament_selection_p=0.7, fraction_replaced=0.3,
                        fraction_replaced_hof=0.3)
    bound = o.bind_scalars(o.traced_scalars("cpu"))
    gen = make_generator(1, "cpu")
    st = tevolve.init_island_state(gen, o, 2, X, y, None, 1.5, 2)
    a = tevolve.s_r_cycle_islands(make_generator(2, "cpu"), st, 8, X, y,
                                  None, 1.5, o, ncycles=3)
    b = tevolve.s_r_cycle_islands(make_generator(2, "cpu"), st,
                                  torch.tensor(8), X, y, None,
                                  torch.tensor(1.5), bound, ncycles=3)
    for x, z in zip(_leaves(a), _leaves(b), strict=True):
        assert torch.equal(x, z)
    ghof = merge_hofs_across_islands(b.hof)
    m = migrate(make_generator(3, "cpu"), b, ghof, bound)
    assert torch.isfinite(m.pop.scores).any()
    winners = tournament_winner(make_generator(4, "cpu"), b.pop,
                                b.stats.frequencies, 4, bound)
    assert winners.shape == (2, 4)
    s = loss_to_score(torch.tensor([1.0, 2.0]), torch.tensor(2.0),
                      torch.tensor([1, 3]), bound)
    torch.testing.assert_close(s, torch.tensor([0.5 + 0.02, 1.0 + 0.06]),
                               rtol=0, atol=1e-7)
