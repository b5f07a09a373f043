"""A custom full-tree objective (``Options.loss_function``) on the port
against the JAX package: ``_custom_loss_trees`` (the objective vmapped over
the population, on a minibatch too) at rtol 1e-6 with +inf exactly where
the reference's is +inf; the objective's gradient with respect to the
constants, ``vmap(grad)`` through ``eval_tree``'s autograd rule, against
``jax.vmap(jax.grad)`` at rtol 1e-4 plus 4 x the reference's own distance
from its float64 value (``test_torch_interp_grad.py``'s ill-conditioning
term); the baseline through the objective; ``eval_tree_plain`` (the
lockstep interpreter without in-place updates, which Newton's Hessian
differentiates) against the lockstep interpreter bit for bit; the three
optimisers' closures under the objective; and the reference's
``tests/test_aux.py::test_custom_loss_function_steers_search`` body on
``device="cpu"``. Everything here runs on the CPU, where ``eval_tree``
evaluates through the lockstep interpreter and its VJP."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symbolicregression_jl_tpu.models import dataset as jdataset
from symbolicregression_jl_tpu.models import fitness as jfit
from symbolicregression_jl_tpu.models import trees as jtrees
from symbolicregression_jl_tpu.models.options import make_options as jmake
from symbolicregression_jl_tpu.ops import interpreter as jinterp
import symbolicregression_jl_tpu_torch as sr
from symbolicregression_jl_tpu_torch.models import constant_opt as tco
from symbolicregression_jl_tpu_torch.models import dataset as tdataset
from symbolicregression_jl_tpu_torch.models import fitness as tfit
from symbolicregression_jl_tpu_torch.models.trees import TreeBatch
from symbolicregression_jl_tpu_torch.ops import interpreter as tinterp
from symbolicregression_jl_tpu_torch.ops import kernel_grad as tkg

from torch_port_helpers import jax_trees, port_trees

BIN, UNA = ["+", "-", "*", "/"], ["cos", "exp"]
KW = dict(binary_operators=BIN, unary_operators=UNA, verbosity=0,
          progress=False)


def jax_objective(tree, X, y, weights, options):
    """The reference's objective form (tests/test_aux.py:143-147): the
    mean squared error of the tree's prediction against y."""
    pred, ok = jinterp.eval_tree(tree, X, options.operators)
    mse = jnp.mean((pred - y) ** 2)
    return jnp.where(ok, mse, jnp.inf)


def torch_objective(tree, X, y, weights, options):
    """The same objective on the port: eval_tree and torch.where."""
    pred, ok = sr.eval_tree(tree, X, options.operators)
    mse = torch.mean((pred - y) ** 2)
    return torch.where(ok, mse, torch.inf)


JOPTS = jmake(loss_function=jax_objective, **KW)
TOPTS = sr.make_options(loss_function=torch_objective, **KW)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    poison = [jtrees.parse_expression(s, JOPTS.operators)
              for s in ("x0 / (x1 - x1)", "exp(exp(exp(exp(x0 * 4.0))))")]
    jt = jax_trees(rng, JOPTS.operators, 40, 2, max_size=16, exprs=poison)
    X = rng.uniform(-2, 2, (2, 48)).astype(np.float32)
    y = (X[0] * X[1] + np.cos(X[1])).astype(np.float32)
    return jt, port_trees(jt), X, y


def _jax_losses(jt, X, y, idx=None, x64=False):
    """The JAX package's ``_custom_loss_trees`` (at float64 under
    ``jax.enable_x64``: the conditioning yardstick)."""
    dt = jnp.float64 if x64 else jnp.float32
    t = jax.tree_util.tree_map(jnp.asarray, jt)
    t = t._replace(cval=jnp.asarray(np.asarray(jt.cval), dt))
    return np.asarray(jfit._custom_loss_trees(
        t, jnp.asarray(X, dt), jnp.asarray(y, dt), None, JOPTS,
        None if idx is None else jnp.asarray(idx)))


def _close_to_jax(got, jt, X, y, idx=None):
    """rtol 1e-6 plus 4 x the reference's own distance from its float64
    value (the mean of 48 squared residuals through cos / exp, whose ulps
    differ between XLA's and torch's CPU math); +inf exactly where the
    reference's is +inf."""
    ref = _jax_losses(jt, X, y, idx)
    with jax.enable_x64():
        ref64 = _jax_losses(jt, X, y, idx, x64=True)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    fin = np.isfinite(ref)
    tol = 1e-6 * np.abs(ref) + 4 * np.abs(np.where(fin, ref - ref64, 0.0))
    assert np.all(np.abs(got - ref)[fin] <= tol[fin])
    return ref


def test_custom_loss_trees_matches_jax(case):
    jt, tt, X, y = case
    got = tfit._custom_loss_trees(tt, torch.tensor(X), torch.tensor(y), None,
                                  TOPTS).numpy()
    ref = _close_to_jax(got, jt, X, y)
    assert np.isinf(ref[-2:]).all() and np.isfinite(ref).sum() > 30
    # on a minibatch, and as score_trees routes it
    idx = np.random.default_rng(1).integers(0, 48, 20)
    got_s, got_b = tfit.score_trees(tt, torch.tensor(X), torch.tensor(y), None,
                                    1.0, TOPTS, torch.tensor(idx))
    ref_b = _close_to_jax(got_b.numpy(), jt, X, y, idx)
    assert np.isinf(got_s.numpy()[~np.isfinite(ref_b)]).all()


def test_objective_gradient_matches_jax_vmap_grad(case):
    jt, tt, X, y = case

    def jf(c, t):
        return jax_objective(t._replace(cval=c), jnp.asarray(X),
                             jnp.asarray(y), None, JOPTS)

    ref = np.asarray(jax.vmap(jax.grad(jf))(jt.cval, jt))
    with jax.enable_x64():
        j64 = jax.tree_util.tree_map(jnp.asarray, jt)._replace(
            cval=jnp.asarray(np.asarray(jt.cval), jnp.float64))

        def jf64(c, t):
            return jax_objective(t._replace(cval=c),
                                 jnp.asarray(X, jnp.float64),
                                 jnp.asarray(y, jnp.float64), None, JOPTS)

        ref64 = np.asarray(jax.vmap(jax.grad(jf64))(j64.cval, j64))

    def tf(fields, c):
        return torch_objective(TreeBatch(*fields[:3], c, fields[4]),
                               torch.tensor(X), torch.tensor(y), None, TOPTS)

    got = torch.func.vmap(torch.func.grad(tf, argnums=1))(
        tuple(tt), tt.cval).numpy()
    live = np.isfinite(np.asarray(jfit._custom_loss_trees(
        jt, jnp.asarray(X), jnp.asarray(y), None, JOPTS)))
    got, ref, ref64 = got[live], ref[live], ref64[live]
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref) & np.isfinite(ref64)
    tol = 1e-4 * np.abs(ref) + 1e-6 + 4 * np.abs(np.where(fin, ref - ref64,
                                                          0.0))
    assert np.all(np.abs(got - ref)[fin] <= tol[fin])
    assert np.abs(got[fin]).max() > 0


def test_baseline_goes_through_the_objective():
    rng = np.random.default_rng(2)
    X = rng.uniform(-2, 2, (2, 30)).astype(np.float32)
    y = (X[0] - 0.5 * X[1]).astype(np.float32)
    ref = jdataset.update_baseline_loss(jdataset.make_dataset(X, y), JOPTS)
    got = tdataset.update_baseline_loss(
        tdataset.make_dataset(X, y, device="cpu"), TOPTS)
    np.testing.assert_allclose(got.baseline_loss, ref.baseline_loss, rtol=1e-6)
    # an objective of its own: 2 x the mean squared error
    twice = sr.make_options(loss_function=lambda t, X_, y_, w, o: 2 * (
        torch_objective(t, X_, y_, w, o)), **KW)
    got2 = tdataset.update_baseline_loss(
        tdataset.make_dataset(X, y, device="cpu"), twice)
    np.testing.assert_allclose(got2.baseline_loss, 2 * got.baseline_loss,
                               rtol=1e-6)


def test_eval_tree_plain_matches_the_lockstep_interpreter(case):
    _, tt, X, _ = case
    Xt = torch.tensor(X)
    y, ok = tinterp.eval_trees(tt, Xt, TOPTS.operators)
    calls = tinterp.PLAIN_CALLS["eval_tree"]
    with tinterp.plain_eval_tree():
        yp, okp = torch.func.vmap(
            lambda t: sr.eval_tree(t, Xt, TOPTS.operators))(tt)
    assert tinterp.PLAIN_CALLS["eval_tree"] == calls + 1
    assert torch.equal(okp, ok)
    assert torch.equal(yp[ok], y[ok])
    # outside the context, the autograd rule: the same values
    yf, okf = torch.func.vmap(lambda t: sr.eval_tree(t, Xt, TOPTS.operators))(tt)
    assert torch.equal(okf, ok) and torch.equal(yf[ok], y[ok])


def test_optimisers_take_the_objectives_closures(case):
    """Under the objective, BFGS's closures equal the kernels' plain
    closures under L2 (the objective here is the L2 mean), Nelder-Mead and
    Newton run, and Newton's Hessian goes through the lockstep
    interpreter (counted)."""
    _, tt, X, y = case
    Xt, yt = torch.tensor(X), torch.tensor(y)
    ok = torch.isfinite(tfit._custom_loss_trees(tt, Xt, yt, None, TOPTS))
    sub = tt[ok.nonzero()[:, 0][:12]]
    fn = tco._loss_closure(sub, Xt, yt, None, TOPTS)
    ref = tkg.make_loss_kernel(sub, Xt, yt, None, TOPTS.operators)
    (l1, g1, _), (l2, g2, ok2) = fn(sub.cval), ref(sub.cval)
    torch.testing.assert_close(l1, torch.where(ok2, l2, torch.inf),
                               rtol=1e-5, atol=0)
    cm = (sub.kind == 1).to(g1.dtype)
    torch.testing.assert_close(g1 * cm, g2 * cm, rtol=1e-4, atol=1e-6)
    ls, _, _ = tco._loss_closure(sub, Xt, yt, None, TOPTS, False, 8)(
        sub.cval.repeat_interleave(8, 0).reshape(12, 8, -1))
    assert ls.shape == (12, 8)
    torch.testing.assert_close(ls[:, 0], l1, rtol=1e-6, atol=0)
    start = sub.cval * 1.3
    for algo in ("BFGS", "NelderMead", "Newton"):
        o = sr.make_options(loss_function=torch_objective,
                            optimizer_algorithm=algo, **KW)
        before = tinterp.PLAIN_CALLS["eval_tree"]
        x, f = tco._OPTIMIZERS[algo](sub, start, cm, Xt, yt, None, o, 4)
        f0 = fn(start)[0]
        assert bool((f <= f0).all()) and bool(torch.isfinite(f).all())
        assert (tinterp.PLAIN_CALLS["eval_tree"] > before) == (algo == "Newton")


def test_custom_loss_function_steers_search():
    """The reference's tests/test_aux.py::test_custom_loss_function_steers_
    search body, its objective through eval_tree and torch.where."""

    def loss_fn(tree, X, y, weights, options):
        pred, ok = sr.eval_tree(tree, X, options.operators)
        target = 0.5 * (X[0] + X[1])
        mse = torch.mean((pred - target) ** 2)
        return torch.where(ok, mse, torch.inf)

    options = sr.make_options(
        binary_operators=["+", "*", "/"],
        loss_function=loss_fn,
        npop=24, npopulations=4, ncycles_per_iteration=60,
        maxsize=12, verbosity=0, progress=False, seed=3,
    )
    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, (2, 64)).astype(np.float32)
    y = np.zeros(64, np.float32)  # ignored by the custom objective
    res = sr.equation_search(X, y, options=options, niterations=6,
                             device="cpu")
    assert res.best_loss().loss < 1e-2
