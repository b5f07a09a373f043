"""PyTorch port vs the JAX package: Nelder-Mead and Newton as batched
optimizers (``models/constant_opt.py``) against the JAX package's
``_nelder_mead_single`` / ``_newton_single`` vmapped from the same starts,
the reference's constant-optimisation bodies (tests/test_constant_opt.py
:139, :149, :160, :493) on the port, a loss callable of the user's own
through every optimizer, and the reference's drop-in keywords
(tests/test_api.py :154, :271, :305, :453). CPU, small shapes."""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu.models.constant_opt as jco
import symbolicregression_jl_tpu.models.options as jopts
import symbolicregression_jl_tpu.models.trees as jtrees
from symbolicregression_jl_tpu.models.options import make_options as jmake
import symbolicregression_jl_tpu_torch as sr
from symbolicregression_jl_tpu_torch.models import constant_opt as tco
from symbolicregression_jl_tpu_torch.models import options as topts
from symbolicregression_jl_tpu_torch.models.population import Population
from symbolicregression_jl_tpu_torch.models.trees import Expr
from symbolicregression_jl_tpu_torch.ops import kernel_grad as tkg
from torch_port_helpers import island_keys, make_generator, random_trees

from torch_port_helpers import port_trees

OPT = dict(binary_operators=["+", "*"], unary_operators=["cos"], maxsize=10)


def _affine_cos(ops, c0, c1, L, device="cpu"):
    """c0 * cos(x0) + c1, encoded at max_len L."""
    e = Expr.binary(ops.binary_index("+"), Expr.binary(
        ops.binary_index("*"), Expr.const(c0),
        Expr.unary(ops.unary_index("cos"), Expr.var(0))), Expr.const(c1))
    return sr.encode_tree(e, L, device=device)


@pytest.fixture(scope="module")
def batch():
    """Six members c0 cos(x0) + c1 (c0 cos(x0) - x1 c1 for two of them),
    each from its own start, against 2.5 cos(x0) - 1.3 + 0.1 x1 on 60
    rows; (JAX trees, port trees, X, y, starts, cmask)."""
    rng = np.random.default_rng(5)
    jo = jmake(binary_operators=["+", "*", "-"], unary_operators=["cos"],
               maxsize=10)
    ops = jo.operators
    p, m, s = (ops.binary_index(n) for n in "+*-")
    cos = ops.unary_index("cos")
    E = jtrees.Expr
    exprs = []
    for i in range(6):
        c0, c1 = rng.uniform(0.5, 3.0), rng.uniform(-1, 1)
        lin = E.binary(p, E.binary(m, E.const(c0), E.unary(cos, E.var(0))),
                       E.const(c1))
        if i % 3 == 2:
            lin = E.binary(s, E.binary(m, E.const(c0), E.unary(cos, E.var(0))),
                           E.binary(m, E.var(1), E.const(c1)))
        exprs.append(jtrees.encode_tree(lin, jo.max_len))
    jt = jtrees.stack_trees(exprs)
    X = rng.standard_normal((2, 60)).astype(np.float32)
    y = (2.5 * np.cos(X[0]) - 1.3 + 0.1 * X[1]).astype(np.float32)
    idx = np.arange(jo.max_len)
    cmask = ((np.asarray(jt.kind) == 1)
             & (idx < np.asarray(jt.length)[:, None])).astype(np.float32)
    starts = np.asarray(jt.cval) + cmask * rng.standard_normal(
        cmask.shape).astype(np.float32) * 0.3
    return jo, jt, port_trees(jt), X, y, starts.astype(np.float32), cmask


@pytest.mark.parametrize("algo,n_iters", [("NelderMead", 6), ("Newton", 4)])
def test_batched_optimizers_match_the_jax_single_instance(batch, algo,
                                                          n_iters):
    """The port's batched Nelder-Mead / Newton from the same starts as the
    JAX package's single-instance functions vmapped over the members
    (their loss through the JAX interpreter, ours through B4 / B3's plain
    versions and the lockstep interpreter's Hessian diagonal): the same
    lockstep iterations, so the final objectives agree at rtol 1e-4 and the
    constants at atol 1e-3 (the two sum rows in different orders, a few
    ulps apart, which can only move a simplex's tie breaks)."""
    jo, jt, tt, X, y, starts, cmask = batch
    single = {"NelderMead": jco._nelder_mead_single,
              "Newton": jco._newton_single}[algo]

    def one(tree, x0, cm):
        f = jco._member_loss_fn(tree, jnp.asarray(X), jnp.asarray(y), None, jo)
        return single(f, x0, cm, n_iters)

    xr, fr = jax.jit(jax.vmap(one))(jt, jnp.asarray(starts),
                                    jnp.asarray(cmask))
    to = sr.make_options(binary_operators=["+", "*", "-"],
                         unary_operators=["cos"], maxsize=10,
                         optimizer_algorithm=algo)
    xt, ft = tco._OPTIMIZERS[algo](tt, torch.tensor(starts),
                                   torch.tensor(cmask), torch.tensor(X),
                                   torch.tensor(y), None, to, n_iters)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fr), rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xr), atol=1e-3)
    assert tkg.LAUNCHES == {"loss_grad": 0, "loss": 0}  # CPU: plain versions


def test_hessian_diagonal_matches_jax_jacfwd(batch):
    """``hessian_diagonal`` (forward over forward through the lockstep
    interpreter) against ``diag(jax.jacfwd(masked_grad))`` of the JAX
    package's member loss, chunked or not, at rtol 1e-4."""
    jo, jt, tt, X, y, starts, cmask = batch

    def one(tree, x, cm):
        f = jco._member_loss_fn(tree, jnp.asarray(X), jnp.asarray(y), None, jo)

        def masked_grad(c):
            g = jax.grad(f)(c) * cm
            return jnp.where(jnp.isfinite(g), g, 0.0)

        h = jnp.diagonal(jax.jacfwd(masked_grad)(x))
        return jnp.where(jnp.isfinite(h), h, 0.0)

    ref = np.asarray(jax.vmap(one)(jt, jnp.asarray(starts),
                                   jnp.asarray(cmask)))
    to = sr.make_options(binary_operators=["+", "*", "-"],
                         unary_operators=["cos"], maxsize=10)
    args = (tt, torch.tensor(starts), torch.tensor(cmask), torch.tensor(X),
            torch.tensor(y), None, to)
    h = tco.hessian_diagonal(*args)
    np.testing.assert_allclose(h.numpy(), ref, rtol=1e-4, atol=1e-6)
    assert torch.equal(tco.hessian_diagonal(*args, chunk=4), h)


def _fit_single(algo, n_iters, rng):
    """The reference's ``_fit_single`` on the port: fit c0 cos(x0) + c1
    to 2.5 cos(x0) - 1.3 from (1, 0)."""
    o = sr.make_options(**OPT, optimizer_algorithm=algo)
    tree = _affine_cos(o.operators, 1.0, 0.0, o.max_len).map(
        lambda f: f.unsqueeze(0))
    X = rng.standard_normal((1, 60)).astype(np.float32)
    y = (2.5 * np.cos(X[0]) - 1.3).astype(np.float32)
    cmask = ((tree.kind == 1) & (torch.arange(o.max_len)
                                 < tree.length[:, None])).float()
    x, loss = tco._OPTIMIZERS[algo](tree, tree.cval, cmask, torch.tensor(X),
                                    torch.tensor(y), None, o, n_iters)
    return x[0][cmask[0] > 0].numpy(), float(loss[0])


@pytest.mark.parametrize("algo,n_iters,atol", [("NelderMead", 40, 1e-2),
                                               ("Newton", 30, 3e-2)])
def test_optimizer_recovers_constants(algo, n_iters, atol):
    """The reference's bodies (tests/test_constant_opt.py:139, :149):
    Nelder-Mead in 40 iterations and Newton in 30 fit the constants to a
    loss below 1e-4."""
    consts, loss = _fit_single(algo, n_iters, np.random.default_rng(0))
    assert loss < 1e-4
    np.testing.assert_allclose(sorted(consts), [-1.3, 2.5], atol=atol)


def test_population_optimize_nelder_mead():
    """The reference's body (tests/test_constant_opt.py:160): a
    population pass with Nelder-Mead brings 1.5 cos(x0) + 0.1 to
    2 cos(x0) + 0.5 below 1e-3 and charges its evaluations."""
    o = sr.make_options(**OPT, optimizer_algorithm="NelderMead",
                        optimizer_probability=1.0, optimizer_iterations=30,
                        optimizer_nrestarts=1)
    rng = np.random.default_rng(0)
    X = rng.standard_normal((1, 50)).astype(np.float32)
    y = (2.0 * np.cos(X[0]) + 0.5).astype(np.float32)
    tree = _affine_cos(o.operators, 1.5, 0.1, o.max_len)
    pop = Population(trees=tree.map(lambda f: f.unsqueeze(0).repeat(
        (4,) + (1,) * f.dim())), scores=torch.full((4,), 1e9),
        losses=torch.full((4,), 1e9), birth=torch.zeros(4, dtype=torch.int64))
    pop2, n_evals, _ = tco.optimize_constants_population(
        island_keys(0, 1)[0], pop, torch.tensor(X), torch.tensor(y), None,
        1.0, o)
    assert float(pop2.losses.min()) < 1e-3
    assert float(n_evals) == 4 * 2 * tco.evals_per_member(30, o.max_len,
                                                          "NelderMead")


@pytest.mark.parametrize("algo", ["BFGS", "NelderMead", "Newton"])
def test_nonfinite_initial_objective_restores_constants(algo):
    """The reference's body (tests/test_constant_opt.py:493): a member
    whose objective overflows at its start comes back with its constants
    and losses as they were, for every optimizer."""
    o = sr.make_options(binary_operators=["+", "*"], maxsize=10,
                        optimizer_probability=1.0, optimizer_iterations=4,
                        optimizer_nrestarts=0, optimizer_algorithm=algo)
    ops = o.operators
    e = Expr.binary(ops.binary_index("+"), Expr.binary(
        ops.binary_index("*"), Expr.const(1e30), Expr.var(0)),
        Expr.const(1e30))
    trees = sr.encode_tree(e, o.max_len, device="cpu").map(
        lambda f: f.unsqueeze(0))
    rng = np.random.default_rng(0)
    X = torch.tensor(rng.standard_normal((1, 40)).astype(np.float32))
    y = 2.0 * X[0] + 0.5
    from symbolicregression_jl_tpu_torch.models.fitness import score_trees
    scores, losses = score_trees(trees, X, y, None, 1.0, o)
    assert not torch.isfinite(losses).any()
    pop = Population(trees=trees, scores=scores, losses=losses,
                     birth=torch.zeros(1, dtype=torch.int64))
    pop2, _, _ = tco.optimize_constants_population(
        island_keys(0, 1)[0], pop, X, y, None, 1.0, o)
    assert torch.equal(pop.trees.cval, pop2.trees.cval)
    assert torch.equal(pop.losses, pop2.losses)


@pytest.mark.parametrize("algo", ["BFGS", "NelderMead", "Newton"])
def test_every_optimizer_runs_under_a_user_loss_and_operator(algo):
    """Constant optimisation under a traced loss callable and over a user
    operator: Options accept it, and a short CPU search runs each
    optimizer on the plain versions to a finite loss, with the evaluation
    count of the JAX package's ``_OPTIMIZERS``."""
    from symbolicregression_jl_tpu_torch.ops import operators as tops

    tops.register_unary("twice_cos", lambda x: 2.0 * torch.cos(x))
    try:
        rng = np.random.default_rng(2)
        X = rng.uniform(-3, 3, (1, 50)).astype(np.float32)
        y = (5.0 * np.cos(X[0]) + 0.3).astype(np.float32)
        res = sr.equation_search(
            X, y, device="cpu", binary_operators=["+", "*"],
            unary_operators=["twice_cos"], npopulations=2, npop=20,
            tournament_selection_n=5, ncycles_per_iteration=8, maxsize=8,
            niterations=2, seed=0, verbosity=0, optimizer_algorithm=algo,
            optimizer_iterations=3, loss=lambda p, t: abs(p - t) ** 2)
        assert np.isfinite(res.best_loss().loss)
        assert tco.evals_per_member(8, 16, algo) == \
            jco._OPTIMIZERS[algo][1](16, 8)
    finally:
        tops.UNARY_REGISTRY.pop("twice_cos", None)


# ---------------------------------------------------------------------------
# the reference's drop-in keywords (tests/test_api.py)
# ---------------------------------------------------------------------------

TINY = dict(binary_operators=["+", "-", "*"], unary_operators=["cos"],
            npop=24, npopulations=2, ncycles_per_iteration=30, maxsize=12,
            should_optimize_constants=False, verbosity=0, progress=False,
            device="cpu")


def _data(n=40):
    rng = np.random.default_rng(0)
    X = rng.standard_normal((2, n)).astype(np.float32)
    return X, (X[0] * X[0] + np.cos(X[1])).astype(np.float32)


def test_reference_parallelism_kwargs():
    """The reference's body (tests/test_api.py:271): parallelism
    validates (":serial" spelled as Julia does too), numprocs / procs /
    addprocs_function warn that they have no effect."""
    X, y = _data()
    res = sr.equation_search(X, y, niterations=1, parallelism="multithreading",
                             seed=0, runtests=False, **TINY)
    assert len(res.frontier()) > 0
    with pytest.raises(ValueError, match="parallelism"):
        sr.equation_search(X, y, niterations=1, parallelism="gpu",
                           runtests=False, **TINY)
    with pytest.warns(UserWarning, match="no effect"):
        sr.equation_search(X, y, niterations=1, numprocs=4, seed=0,
                           runtests=False, **TINY)
    with pytest.warns(UserWarning, match="no effect"):
        sr.equation_search(X, y, niterations=1, parallelism=":serial",
                           procs=[1], addprocs_function=print, seed=0, **TINY)


def test_reference_option_kwargs_parity():
    """The reference's body (tests/test_api.py:453) on the port."""
    o = sr.make_options(
        binary_operators=["+", "*", "^"], unary_operators=["cos", "exp"],
        elementwise_loss="L1DistLoss", una_constraints={"exp": 5},
        bin_constraints={"^": (3, 1)}, save_to_file=False, terminal_width=72,
        define_helper_functions=False)
    assert o.loss == "L1DistLoss"
    cons = dict(o.constraints)
    assert cons["exp"] == 5 and tuple(cons["^"]) == (3, 1)
    assert o.save_to_file is False and o.terminal_width == 72
    with pytest.raises(ValueError, match="not both"):
        sr.make_options(binary_operators=["+"], loss="L1DistLoss",
                        elementwise_loss="L2DistLoss")
    with pytest.raises(ValueError, match="constrained in both"):
        sr.make_options(binary_operators=["+"], unary_operators=["exp"],
                        constraints={"exp": 4}, una_constraints={"exp": 5})
    with pytest.raises(ValueError, match="dict"):
        sr.make_options(binary_operators=["+"], bin_constraints=[(3, 1)])


def test_turbo_and_fast_cycle_knobs():
    """The reference's body (tests/test_api.py:154) on the port: turbo=True
    is the default routing (the reference's eval_backend="auto"), fast_cycle
    an accepted no-op; turbo=False would pin the reference's portable
    interpreter, a routing lever the port refuses."""
    o1 = sr.make_options(binary_operators=["+"], turbo=True, fast_cycle=True)
    assert o1 == sr.make_options(binary_operators=["+"])
    assert o1.fast_cycle is True
    assert jmake(binary_operators=["+"], turbo=True).eval_backend == "auto"
    with pytest.raises(NotImplementedError, match="turbo"):
        sr.make_options(binary_operators=["+"], turbo=False)


def test_integer_input_data_is_cast():
    """The reference's body (tests/test_api.py:305) on the port: integer X
    and y are cast to the working float dtype."""
    rng = np.random.default_rng(0)
    X = rng.integers(-5, 5, (2, 40)).astype(np.int64)
    y = (X[0] * X[1]).astype(np.int64)
    res = sr.equation_search(X, y, niterations=2, seed=0, runtests=False,
                             **TINY)
    assert len(res.frontier()) > 0
    assert res.predict(X).dtype == np.float32


NEW_FIELDS = ("fast_cycle", "skip_mutation_failures", "deterministic",
              "define_helper_functions", "recorder_file", "telemetry_every",
              "telemetry_run_id", "telemetry_attempt", "profile_trace_dir")


@pytest.mark.parametrize("field", NEW_FIELDS)
def test_reference_fields_are_classed_as_in_the_reference(field):
    """Each of the nine fields is a field of the port's Options, at the
    reference's default, in exactly one of the three classes, the one it
    has in the JAX package; the five unported ones raise for any other
    value, naming their ROADMAP item."""
    classes = ("TRACED_SCALAR_FIELDS", "GRAPH_FIELDS", "ORCHESTRATION_FIELDS")
    mine = [c for c in classes if field in getattr(topts, c)]
    ref = [c for c in classes if field in getattr(jopts, c)]
    assert mine == ref and len(mine) == 1
    default = {f.name: f.default for f in dataclasses.fields(topts.Options)}
    ref_default = {f.name: f.default for f in dataclasses.fields(jopts.Options)}
    assert default[field] == ref_default[field]
    if field in topts._UNSUPPORTED:
        value = {"recorder_file": "x.json", "telemetry_every": 2}.get(
            field, "x")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            sr.make_options(**{field: value})
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            o = sr.make_options(**{field: not default[field]})
        assert o == sr.make_options()
