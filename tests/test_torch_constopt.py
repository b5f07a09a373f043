"""PyTorch port vs the JAX package, constant optimisation: the batched BFGS
on the plain kernels against the JAX package's ``_bfgs_batched`` on its
Pallas kernels in interpret mode from the same starts, the write-back
rules, one optimisation pass on a carried search state fed JAX's own
selection, the invariants of the port's random selection, the Options
that constant optimisation lifts or still refuses, and a search that fits
constants on the CPU."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu.models.constant_opt as jco
import symbolicregression_jl_tpu.models.trees as jtrees
import symbolicregression_jl_tpu.ops.pallas_grad as jpg
from symbolicregression_jl_tpu.models import evolve as jevolve
from symbolicregression_jl_tpu.models.options import make_options as jmake
import symbolicregression_jl_tpu_torch as sr
from symbolicregression_jl_tpu_torch import convert
from symbolicregression_jl_tpu_torch.models import constant_opt as tco
from symbolicregression_jl_tpu_torch.models import evolve as tevolve
from symbolicregression_jl_tpu_torch.ops import kernel_grad as tkg
from torch_port_helpers import island_keys, make_generator, random_trees

from torch_port_helpers import port_trees, to_numpy

OPT = dict(binary_operators=["+", "-", "*"], unary_operators=["cos"],
           maxsize=10)
MEMBERS = ["1.0 * cos(x0) + 0.0", "-0.5 * cos(x0) + 1.5",
           "3.0 * cos(x0 * 0.8) - 1.0", "(0.2 + x0) * 0.3", "x0 - x0 * 2.0",
           "cos(x0)"]  # the last has no constant


@pytest.fixture(scope="module")
def fit():
    """Members of a convex-in-constants family, their data, and three starts
    each (the member's constants and two fixed perturbations)."""
    jo = jmake(**OPT)
    rng = np.random.default_rng(3)
    X = rng.uniform(-2, 2, (1, 150)).astype(np.float32)
    y = (2.0 * np.cos(X[0]) + 0.5 + 0.1 * rng.standard_normal(150)).astype(
        np.float32)
    w = rng.uniform(0.5, 1.5, 150).astype(np.float32)
    jt = jtrees.stack_trees([
        jtrees.encode_tree(jtrees.parse_expression(s, jo.operators), jo.max_len)
        for s in MEMBERS])
    cmask = (np.asarray(jt.kind) == jtrees.CONST).astype(np.float32)
    cval = np.asarray(jt.cval)
    noise = rng.standard_normal((2,) + cval.shape).astype(np.float32)
    starts = np.concatenate([cval[None], cval[None] * (1 + 0.5 * noise)])
    M = 3 * len(MEMBERS)
    tile = lambda a: np.tile(a, (3,) + (1,) * (a.ndim - 1))
    flat = {k: tile(v) for k, v in to_numpy(jt).items()}
    return (jo, sr.make_options(**OPT), flat, starts.reshape(M, -1),
            tile(cmask), X, y, w)


def _bfgs_both(fit, weighted, n_iters, monkeypatch):
    """JAX's _bfgs_batched on its Pallas kernels in interpret mode (one
    tree per kernel loop step: the same values, a quarter of the compile
    time) and the port's on the plain kernels."""
    jo, to, flat, x0, cmask, X, y, w = fit
    monkeypatch.setattr(jco, "_FORCE_INTERPRET", True)
    monkeypatch.setattr(jpg, "make_loss_kernel",
                        functools.partial(jpg.make_loss_kernel, tree_unroll=1))
    jt = jtrees.TreeBatch(**{k: jnp.asarray(v) for k, v in flat.items()})
    wj = jnp.asarray(w) if weighted else None
    xj, fj = jco._bfgs_batched(jt, jnp.asarray(x0), jnp.asarray(cmask),
                               jnp.asarray(X), jnp.asarray(y), wj, jo, n_iters)
    xt, ft = tco._bfgs_batched(
        convert.trees_from_numpy(flat, "cpu"), torch.tensor(x0),
        torch.tensor(cmask), torch.tensor(X), torch.tensor(y),
        torch.tensor(w) if weighted else None, to, n_iters)
    return np.asarray(xj), np.asarray(fj), xt.numpy(), ft.numpy()


def test_bfgs_first_step_matches_jax(fit, monkeypatch):
    """One BFGS step, unweighted: the chosen line-search loss at rtol 1e-5
    (losses sum rows in other orders) and the step's constants at rtol
    1e-4 (the gradient that sets the direction is held at rtol 1e-4)."""
    xj, fj, xt, ft = _bfgs_both(fit, False, 1, monkeypatch)
    np.testing.assert_allclose(ft, fj, rtol=1e-5)
    np.testing.assert_allclose(xt, xj, rtol=1e-4, atol=1e-6)


def test_bfgs_converges_with_jax(fit, monkeypatch):
    """Eight steps, weighted: final losses and constants at rtol 1e-3
    (rounding differences compound through the line search and the H
    update; the fixtures are convex in their constants, so both land
    together)."""
    xj, fj, xt, ft = _bfgs_both(fit, True, 8, monkeypatch)
    np.testing.assert_allclose(ft, fj, rtol=1e-3)
    np.testing.assert_allclose(xt, xj, rtol=1e-3, atol=1e-4)
    assert (ft[[0, 1, 6, 7]] < 0.02).all()  # the c0 cos(x0) + c1 members fit


def test_write_back_matches_jax_exactly():
    """Given the same xs / fs: which members improve, the new losses,
    constants and scores, and the eval count, exactly; a finite loss behind
    a non-finite constant is never adopted, an ineligible member never
    changes."""
    jo = jmake(**OPT)
    to = sr.make_options(**OPT)
    rng = np.random.default_rng(8)
    exprs = ["1.5 * cos(x0)", "x0 + 0.5", "cos(x0)", "x0 * 2.0 - 1.0",
             "0.3 - x0", "cos(x0 * 3.0)"]
    jt = jtrees.stack_trees([jtrees.encode_tree(
        jtrees.parse_expression(s, jo.operators), jo.max_len) for s in exprs])
    pop = jevolve.Population(
        trees=jax.tree_util.tree_map(jnp.asarray, jt),
        scores=jnp.asarray(rng.uniform(1, 2, 6), jnp.float32),
        losses=jnp.asarray([1.0, 1.0, 1.0, 1.0, 1.0, 1.0], jnp.float32),
        birth=jnp.arange(6, dtype=jnp.int32))
    sel = np.array([0, 1, 2, 3, 5])
    L = jo.max_len
    xs = (np.asarray(jt.cval)[sel][None] + rng.standard_normal((3, 5, L))
          ).astype(np.float32)
    xs[1, 4, 3] = np.inf  # member 5's best restart carries an inf constant
    fs = np.array([[0.5, 2.0, 0.1, 1.0, 3.0],
                   [0.7, 0.9, 0.2, 1.0, 0.01],
                   [np.inf, 1.5, 0.3, 1.0, 0.5]], np.float32)
    sub = jax.tree_util.tree_map(lambda a: a[sel], pop.trees)
    eligible = jnp.asarray([True, True, False, True, True])
    jp, jn, ja = jco._write_back(
        pop, jnp.asarray(sel), sub, pop.losses[sel], eligible, jnp.asarray(xs),
        jnp.asarray(fs), 2.0, jo, 3,
        lambda L_, it: 1 + it * (jco._LS_STEPS + 1))
    tp = tevolve.Population(
        trees=port_trees(jt).map(lambda a: a[None]),
        scores=torch.tensor(np.asarray(pop.scores))[None],
        losses=torch.tensor(np.asarray(pop.losses))[None],
        birth=torch.arange(6)[None])
    sel_t = torch.tensor(sel)[None]
    tp2, tn, ta = tco._write_back(
        tp, sel_t, port_trees(sub).map(lambda a: a[None]),
        tp.losses.gather(1, sel_t), torch.tensor(np.asarray(eligible))[None],
        torch.tensor(xs)[None], torch.tensor(fs)[None], 2.0, to)
    for f in ("losses", "scores"):
        np.testing.assert_array_equal(getattr(tp2, f)[0].numpy(),
                                      np.asarray(getattr(jp, f)))
    np.testing.assert_array_equal(tp2.trees.cval[0].numpy(),
                                  np.asarray(jp.trees.cval))
    assert float(tn[0]) == float(jn) and int(ta[0]) == int(ja) == 4
    assert np.isfinite(tp2.trees.cval.numpy()).all()
    # improved: members 0 and 1 only (2 ineligible, 3 no better, 5's best
    # restart has an inf constant)
    np.testing.assert_array_equal(
        tp2.losses[0].numpy(), np.float32([0.5, 0.9, 1.0, 1.0, 1.0, 1.0]))


@pytest.fixture(scope="module")
def carried():
    """A JAX init_island_state (2 islands of 24) carried to the port."""
    cfg = dict(binary_operators=["+", "-", "*", "/"],
               unary_operators=["cos", "exp"], npopulations=2, npop=24,
               maxsize=20)
    rng = np.random.default_rng(4)
    X = rng.uniform(-2, 2, (3, 64)).astype(np.float32)
    y = (np.cos(X[0]) * X[1] - X[2]).astype(np.float32)
    baseline = float(np.mean((y - y.mean()) ** 2))
    jo = jmake(**cfg)
    init = jax.jit(jax.vmap(lambda k: jevolve.init_island_state(
        k, jo, 3, jnp.asarray(X), jnp.asarray(y), None, baseline)))
    jstates = init(jax.random.split(jax.random.PRNGKey(3), 2))
    tstates = convert.island_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstates)._asdict(), "cpu")
    return X, y, baseline, jo, sr.make_options(**cfg), jstates, tstates


def test_optimize_pass_on_carried_state_matches_jax(carried):
    """One optimize pass, the port fed JAX's own members and starts: the
    population, hall of fame, eval count and OPTIMIZE counters against the
    JAX package's pass (its portable BFGS on the CPU) at rtol 1e-3."""
    X, y, baseline, jo, to, jstates, tstates = carried
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    K, n_starts, _ = jco._static_shapes(
        jax.tree_util.tree_map(lambda a: a[0], jstates.pop), jo, None)
    sel_idx, _, _, _, starts, _ = jax.vmap(
        lambda k, p: jco._select_and_starts(k, p, jo, K, n_starts))(
            keys, jstates.pop)
    js = jax.jit(lambda k, s: jevolve.optimize_islands_constants(
        k, s, jnp.asarray(X), jnp.asarray(y), None, baseline, jo,
        count_optimize_telemetry=True))(keys, jstates)
    Xt, yt = torch.tensor(X), torch.tensor(y)
    pops, n_ev, n_att = tco.optimize_selected(
        tstates.pop, torch.tensor(np.asarray(sel_idx)),
        torch.tensor(np.asarray(starts)), Xt, yt, None, baseline, to)
    ts = tevolve.fold_optimized(tstates, pops, n_ev, n_att, to, True)
    jl = np.asarray(js.pop.losses)
    assert (jl < np.asarray(jstates.pop.losses)).sum() >= 4
    np.testing.assert_allclose(ts.pop.losses.numpy(), jl, rtol=1e-3)
    np.testing.assert_allclose(ts.pop.scores.numpy(), np.asarray(js.pop.scores),
                               rtol=1e-3)
    np.testing.assert_allclose(ts.pop.trees.cval.numpy(),
                               np.asarray(js.pop.trees.cval), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(ts.hof.losses.numpy(), np.asarray(js.hof.losses),
                               rtol=1e-3)
    np.testing.assert_array_equal(ts.num_evals.numpy(), np.asarray(js.num_evals))
    np.testing.assert_array_equal(ts.mut_counts.numpy(),
                                  np.asarray(js.mut_counts))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_select_and_starts_invariants(carried, seed):
    """K distinct members per island, those with constants first; the
    first start is each member's own constants, the restarts scale them by
    1 + 0.5 N(0, 1) (so a zero constant stays zero)."""
    *_, tstates = carried
    pops = tstates.pop
    K, n_starts = 7, 3
    sel, starts = tco._select_and_starts(island_keys(seed, 2), pops, K,
                                         n_starts)
    assert sel.shape == (2, K) and starts.shape == (2, n_starts, K, 24)
    has = tco._const_slots(pops.trees).any(-1)
    for i in range(2):
        assert len(set(sel[i].tolist())) == K
        n_with = int(has[i].sum())
        assert int(has[i][sel[i]].sum()) == min(K, n_with)
        cval = pops.trees.cval[i][sel[i]]
        assert torch.equal(starts[i, 0], cval)
        assert torch.isfinite(starts).all()
        assert (starts[i, 1:][cval.expand(n_starts - 1, -1, -1) == 0] == 0).all()
    assert not torch.equal(starts[:, 1], starts[:, 2])


@pytest.mark.parametrize("kw", [
    dict(), dict(should_optimize_constants=True, optimizer_probability=0.5),
    dict(optimizer_nrestarts=0, optimizer_iterations=3),
    dict(mutation_weights=dict(optimize=0.5)),
    dict(optimizer_algorithm="BFGS", optimizer_backend="auto", loss="mse"),
    dict(should_optimize_constants=False, loss="L1DistLoss"),
    dict(loss="L1DistLoss"), dict(loss="HuberLoss", should_optimize_constants=False,
                                  mutation_weights=dict(optimize=0.1)),
    dict(optimizer_algorithm="NelderMead"), dict(optimizer_algorithm="Newton"),
    # a callable of the user's own that the tracer lowers (ops/user_ops.py)
    dict(loss=lambda p, t: (p - t) * (p - t)),
    dict(loss=lambda p, t: abs(p - t), should_optimize_constants=False,
         mutation_weights=dict(optimize=0.1)),
    # a custom full-tree objective: its closures replace the kernels'
    dict(loss_function=lambda tree, X, y, w, o: 0.0),
])
def test_constant_optimisation_options_accepted(kw):
    o = sr.make_options(**kw)
    ref = jmake(**kw)
    for f in ("should_optimize_constants", "optimizer_probability",
              "optimizer_nrestarts", "optimizer_iterations",
              "optimizer_algorithm"):
        assert getattr(o, f) == getattr(ref, f), f


@pytest.mark.parametrize("kw", [
    dict(loss=lambda p, t: torch.from_numpy(p.numpy() - t.numpy()) ** 2),
    dict(optimizer_backend="jnp"), dict(optimizer_backend="pallas"),
    # a callable of the user's own that the tracer cannot lower has no seed
    # in the kernels
    dict(loss=lambda p, t: (p - t) ** 2 if bool((p > t).all()) else p - t),
    dict(loss=lambda p, t: torch.fft.fft(p - t).real,
         should_optimize_constants=False,
         mutation_weights=dict(optimize=0.1)),
])
def test_constant_optimisation_options_refused(kw):
    with pytest.raises(NotImplementedError):
        sr.make_options(**kw)


@pytest.mark.parametrize("weights", [None, dict(optimize=0.3)])
def test_expected_optimize_count_matches_jax(weights):
    kw = dict(npop=40, tournament_selection_n=8, ncycles_per_iteration=30)
    if weights:
        kw["mutation_weights"] = weights
    assert tevolve.expected_optimize_count(sr.make_options(**kw)) == \
        jevolve.expected_optimize_count(jmake(**kw))


def test_equation_search_fits_constants_on_cpu():
    """Default constant optimisation (BFGS, probability 0.14, 2 restarts, 8
    iterations) with the optimize mutation on too: the search recovers
    2.5 cos(x0) + 0.7 to a loss below 1e-4, and both passes ran."""
    rng = np.random.default_rng(1)
    X = rng.uniform(-3, 3, (2, 120)).astype(np.float32)
    y = (2.5 * np.cos(X[0]) + 0.7).astype(np.float32)
    calls = []
    res = sr.equation_search(
        X, y, device="cpu", binary_operators=["+", "*"],
        unary_operators=["cos"], npopulations=4, npop=40, maxsize=8,
        ncycles_per_iteration=20, niterations=10, seed=0,
        mutation_weights=dict(optimize=0.05), early_stop_condition=1e-4,
        verbosity=0, return_state=True,
        on_iteration=lambda j, it, c: calls.append(it))
    assert res.best_loss().loss < 1e-4, res
    counts = res.state[0].island_states.mut_counts
    assert int(counts[:, tevolve.MUTATION_NAMES.index("optimize"), 0].sum()) > 0
    assert tkg.LAUNCHES == {"loss_grad": 0, "loss": 0}  # CPU: plain versions


def test_one_island_forms_equal_the_islands_form(carried):
    """optimize_constants_population and optimize_island_constants are
    the islands forms at I = 1: same draws, same result."""
    X, y, baseline, _, to, _, tstates = carried
    Xt, yt = torch.tensor(X), torch.tensor(y)
    one = tevolve._map_tensors(lambda a: a[1:2], tstates)
    ref = tevolve.optimize_islands_constants(island_keys(9, 1), one, Xt,
                                             yt, None, baseline, to)
    got = tevolve.optimize_island_constants(
        island_keys(9, 1)[0], tevolve._map_tensors(lambda a: a[1], tstates),
        Xt, yt, None, baseline, to)
    pop, n_ev, _ = tco.optimize_constants_population(
        island_keys(9, 1)[0], tevolve._map_tensors(lambda a: a[1], tstates.pop),
        Xt, yt, None, baseline, to)
    for a, b in ((got.pop.losses, ref.pop.losses[0]), (pop.losses, ref.pop.losses[0]),
                 (got.pop.trees.cval, ref.pop.trees.cval[0]),
                 (got.hof.losses, ref.hof.losses[0]), (got.num_evals, ref.num_evals[0])):
        assert torch.equal(a, b)
    assert float(n_ev) == float(ref.num_evals[0] - one.num_evals[0])
