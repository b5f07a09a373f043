"""precision="float64" on the port against the JAX package at float64:
every plain version of the float64 builds (the value mode through the
operand schedule and through the stack machine, the instruction programs
B5 / B6, the constant fold through the slot mode, the gradient kernel's
mirror B3 and the loss-only kernel B4, the cotangent-seeded mode) against
the jnp interpreter under ``jax.enable_x64()`` at rtol 1e-10 on valid
programs over ``+ - * / cos exp``, with equal poison masks (plus 100 x the
reference's own largest change when its X or its constants move by 4 ulps: a random
chain like ``cos(exp(exp(x)))`` turns an ulp of ``exp`` into any value of
``cos``, in any two implementations); the losses'
float64 constants; the user-operator header of the float64 build; the
front door keeping X and y in float64 (a value beyond float32's range is
no cast overflow), ``predict`` and ``to_callable`` at float64, ``convert``
carrying float64 constants; Options accepting the precision without the
reference's interpreter warning; and the reference's
``tests/test_precision.py::test_float64_in_subprocess`` search, in this
process on ``device="cpu"``. The JAX package's ``equation_search`` is never
run here at float64: it flips ``jax_enable_x64`` for the whole process."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symbolicregression_jl_tpu.models import mutate_device as jmut
from symbolicregression_jl_tpu.models import trees as jtrees
from symbolicregression_jl_tpu.ops import interpreter as jinterp
from symbolicregression_jl_tpu.ops import losses as jlosses
from symbolicregression_jl_tpu.ops.operators import (
    make_operator_set as jmake_ops,
)
import symbolicregression_jl_tpu_torch as sr
from symbolicregression_jl_tpu_torch import convert
from symbolicregression_jl_tpu_torch.models import mutate_device as tmut
from symbolicregression_jl_tpu_torch.ops import kernel_eval as tke
from symbolicregression_jl_tpu_torch.ops import kernel_grad as tkg
from symbolicregression_jl_tpu_torch.ops import kernel_instr as tki
from symbolicregression_jl_tpu_torch.ops import losses as tlosses
from symbolicregression_jl_tpu_torch.ops import user_ops
from symbolicregression_jl_tpu_torch.ops.operators import (
    make_operator_set as tmake_ops,
)

from torch_port_helpers import jax_trees, port_trees, to_numpy

BIN, UNA = ["+", "-", "*", "/"], ["cos", "exp"]
JOPS, TOPS = jmake_ops(BIN, UNA), tmake_ops(BIN, UNA)
F64 = torch.float64


NUDGE = 4 * np.finfo(np.float64).eps  # 4 ulps of X and the constants


def _x64(jt, nudge=0.0):
    """The trees with float64 constants (moved by ``nudge``, relative), as
    jnp arrays (inside ``jax.enable_x64``)."""
    t = jax.tree_util.tree_map(jnp.asarray, jt)
    return t._replace(cval=jnp.asarray(np.asarray(jt.cval) * (1 + nudge),
                                       jnp.float64))


def _reference(fn, jt, X, *args):
    """``fn(trees, X, *args)`` of the JAX package under x64, and its
    largest change when X or the constants move by ``NUDGE`` (X's rows in
    turn, the constants, each way: the conditioning yardstick)."""
    sign = np.where(np.arange(X.shape[0]) % 2 == 0, 1.0, -1.0)[:, None]
    moves = [(0.0, NUDGE), (0.0, -NUDGE)] + [
        (NUDGE * s, 0.0) for s in (sign, -sign, 1.0)]
    # one compile for the six calls (same shapes), not a scan traced anew
    fn = jax.jit(fn, static_argnums=tuple(range(2, 2 + len(args))))
    with jax.enable_x64():
        ref = np.asarray(fn(_x64(jt), jnp.asarray(X, jnp.float64), *args))
        spread = np.zeros(ref.shape)
        for dx, dc in moves:
            moved = np.asarray(fn(_x64(jt, dc),
                                  jnp.asarray(X * (1 + dx), jnp.float64), *args))
            fin = np.isfinite(ref) & np.isfinite(moved)
            spread = np.maximum(spread, np.abs(np.where(fin, ref - moved, 0.0)))
    return ref, spread


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(4)
    p = lambda s: jtrees.parse_expression(s, JOPS)
    extra = [p("x0 / (x1 - x1)"), p("exp(x0 * 0.0 + 710.0)"),
             p("exp(x1 * 0.0 + 100.0)"), p("2.5"), p("x1"),
             p("x0 * (1.3 + 2.7)"), p("cos(0.7) * x1 - exp(0.3 / 1.9)")]
    jt = jax_trees(rng, JOPS, 40, 2, max_size=18, exprs=extra)
    # constants of float64 precision (the encoding holds float32)
    jt = jt._replace(cval=np.asarray(jt.cval, np.float64)
                     * (1 + 1e-9 * rng.standard_normal(jt.cval.shape)))
    X = rng.uniform(-2, 2, (2, 70))
    y = X[0] * X[1] - np.cos(X[0])
    tt = convert.trees_from_numpy(to_numpy(jt), "cpu")
    assert tt.cval.dtype == F64
    return jt, tt, X, y


def _jax_values(jt, X):
    """(values, ok, the values' conditioning yardstick) of the jnp
    interpreter at float64."""
    ref, spread = _reference(lambda t, x: jinterp.eval_trees(t, x, JOPS)[0],
                             jt, X)
    with jax.enable_x64():
        ok = np.asarray(jinterp.eval_trees(_x64(jt), jnp.asarray(X), JOPS)[1])
    return ref, ok, spread


@pytest.fixture(scope="module")
def values(data):
    """``_jax_values`` on the module's trees and X, computed once for the
    tests that read it."""
    return _jax_values(data[0], data[2])


def _close(got, ref, spread, atol=0.0):
    """Finite at the same places; within rtol 1e-10 plus 100 x the
    reference's change under the 4-ulp nudge."""
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    tol = 1e-10 * np.abs(ref) + 100 * spread + atol
    assert np.all(np.abs(got - ref)[fin] <= tol[fin]), np.max(
        (np.abs(got - ref) - tol)[fin])


@pytest.mark.parametrize("kernel", ["value", "program", "instr",
                                    "instr_packed"])
def test_float64_value_plain_versions_match_jnp(data, values, kernel):
    jt, tt, X, _ = data
    ref, ok_ref, spread = values
    Xt = torch.tensor(X)
    if kernel == "value":
        y, ok = tke.eval_trees_plain(tt, Xt, TOPS)
    elif kernel == "program":
        y, bad = tke.eval_program_plain(tt, Xt, TOPS)
        ok = ~bad & (tt.length > 0)
    else:
        y, ok = tki.eval_trees_instr_plain(tt, Xt, TOPS,
                                           kernel == "instr_packed")
    assert y.dtype == F64
    np.testing.assert_array_equal(ok.numpy(), ok_ref)
    assert not ok_ref[40:42].any() and ok_ref[42]  # inf in float64 only
    assert float(y[42, 0]) > 1e43
    _close(y.numpy()[ok_ref], ref[ok_ref], spread[ok_ref])


def test_float64_constant_fold_matches_jax(data):
    """The constant fold at float64 (the slot mode's plain version at the
    constants' dtype) against ``_const_fold_scan`` under x64."""
    jt, tt, _, _ = data
    fold = lambda t, x: jax.vmap(
        lambda s: jmut._const_fold_scan(s, JOPS)[1])(t)
    vj, spread = _reference(fold, jt, data[2])
    with jax.enable_x64():
        cj = np.asarray(jax.vmap(
            lambda s: jmut._const_fold_scan(s, JOPS)[0])(_x64(jt)))
    ct, vt, _ = tmut._const_fold(tt, TOPS)
    assert vt.dtype == F64
    np.testing.assert_array_equal(ct.numpy(), cj)
    _close(vt.numpy()[cj], vj[cj], spread[cj])
    assert cj[-2:].sum() >= 5
    # the slot mode itself: each tree's last slot is its root value
    X1 = torch.tensor(data[2][:, :1])
    vals, ok = tke.eval_slot_values_plain(tt, X1, TOPS)
    root = vals.gather(1, (tt.length - 1).clamp_min(0).unsqueeze(-1))[:, 0]
    ref, ok_ref, spread = _jax_values(jt, data[2][:, :1])
    np.testing.assert_array_equal(ok.numpy(), ok_ref)
    _close(root.numpy()[ok_ref], ref[ok_ref, 0], spread[ok_ref, 0])


@pytest.mark.parametrize("weighted", [False, True])
def test_float64_gradient_and_loss_plain_versions_match_jax(data, values,
                                                           weighted):
    """B3's mirror (loss and gradient) and B4's plain version at float64
    against the jnp interpreter's L2 loss and its jax.grad under x64."""
    jt, tt, X, y = data
    w = np.random.default_rng(1).uniform(0.5, 1.5, X.shape[1])
    w[:5] = 0.0
    wt = torch.tensor(w) if weighted else None
    ok_ref = values[1]

    def loss(c, t, Xj):
        with jax.enable_x64():
            yj = jnp.asarray(y, jnp.float64)
            wj = jnp.asarray(w, jnp.float64) if weighted else None
            pred, _ = jinterp.eval_tree(t._replace(cval=c), Xj, JOPS)
            return jlosses.aggregate_loss((pred - yj) ** 2, wj)

    lref, lspread = _reference(
        lambda t, x: jax.vmap(lambda c, s: loss(c, s, x))(t.cval, t), jt, X)
    gref, gspread = _reference(
        lambda t, x: jax.vmap(jax.grad(lambda c, s: loss(c, s, x)))(t.cval, t),
        jt, X)
    lm, gm, okm = tkg.eval_loss_grad_program_plain(
        tt, torch.tensor(X), torch.tensor(y), wt, TOPS)
    assert lm.dtype == gm.dtype == F64
    np.testing.assert_array_equal(okm.numpy(), ok_ref)
    _close(lm.numpy()[ok_ref], lref[ok_ref], lspread[ok_ref])
    g, r = gm.numpy()[ok_ref], gref[ok_ref]
    fin = np.isfinite(r)
    _close(g[fin], r[fin], gspread[ok_ref][fin], atol=1e-12)
    l4, ok4 = tkg.eval_loss_plain(tt, torch.tensor(X), torch.tensor(y), wt,
                                  TOPS)
    np.testing.assert_array_equal(ok4.numpy(), ok_ref)
    _close(l4.numpy()[ok_ref], lref[ok_ref], lspread[ok_ref])


def test_float64_cotangent_mode_matches_jax_vjp(data, values):
    """The cotangent-seeded mode's plain version at float64 against
    ``jax.vjp`` of the jnp interpreter's values with the same seeds."""
    jt, tt, X, _ = data
    g = np.random.default_rng(2).uniform(-1, 1, (tt.length.shape[0],
                                                 X.shape[1]))
    ok_ref = values[1]

    def vjp_of(t, x):
        _, pull = jax.vjp(lambda c: jinterp.eval_trees(
            t._replace(cval=c), x, JOPS)[0], t.cval)
        return pull(jnp.asarray(g, jnp.float64))[0]

    ref, spread = _reference(vjp_of, jt, X)
    vjp, ok = tkg.eval_vjp_constants(tt, torch.tensor(X), torch.tensor(g), TOPS)
    assert vjp.dtype == F64
    np.testing.assert_array_equal(ok.numpy(), ok_ref)
    fin = np.isfinite(ref[ok_ref])
    _close(vjp.numpy()[ok_ref][fin], ref[ok_ref][fin], spread[ok_ref][fin],
           atol=1e-12)


@pytest.mark.parametrize("name", ["HuberLoss", "LogCoshLoss", "PeriodicLoss",
                                  "LPDistLoss"])
def test_float64_losses_take_float64_constants(name):
    params = {"HuberLoss": (0.3,), "PeriodicLoss": (0.7,),
              "LPDistLoss": (1.7,)}.get(name, ())
    tl = tlosses.ElementwiseLoss(tlosses.KIND_NAMES.index(name), params)
    jl = jlosses.LOSS_REGISTRY[name] if not params else getattr(
        jlosses, {"HuberLoss": "huber_loss", "PeriodicLoss": "periodic_loss",
                  "LPDistLoss": "lp_dist_loss"}[name])(*params)
    rng = np.random.default_rng(3)
    p, t = rng.uniform(-3, 3, 50), rng.uniform(-3, 3, 50)
    with jax.enable_x64():
        ref = np.asarray(jl(jnp.asarray(p, jnp.float64),
                            jnp.asarray(t, jnp.float64)))
    got = tl(torch.tensor(p), torch.tensor(t)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-13, atol=1e-15)
    assert tl.constants_of(F64)[:len(params)] != tl.constants[:len(params)] or (
        all(float(np.float32(c)) == c for c in params))


def test_float64_user_header_computes_in_double():
    prog = user_ops.trace(lambda a: torch.exp(a) * 0.1 + 1.0, 1, "op")
    text = user_ops.header_text([("op", prog)], [], None, double=True)
    assert "float" not in text.replace("__int_as_float", "")
    assert "__int_as_float" not in text and "__dmul_rn" in text
    assert "__longlong_as_double(0x3fb999999999999aLL)" in text  # 0.1
    assert text != user_ops.header_text([("op", prog)], [], None)


def test_float64_front_door_predict_and_to_callable():
    """X and y stay float64: 1e39 is no cast overflow at float64 (it is at
    float32, tests/test_torch_dataset.py); predict and to_callable give
    float64."""
    rng = np.random.default_rng(5)
    X = rng.uniform(-2, 2, (2, 40))
    X[1, 3] = 1e39
    y = X[0] * X[0] + 1e-12 * X[0]
    res = sr.equation_search(X, y, precision="float64", device="cpu",
                             binary_operators=["+", "*"], npop=16,
                             npopulations=2, ncycles_per_iteration=10,
                             tournament_selection_n=6, maxsize=8,
                             niterations=1, verbosity=0, return_state=True)
    assert res.dataset_diagnostics["cast_overflow_cells"] == 0
    assert not res.dataset_diagnostics["errors"]
    assert res.state[0].island_states.pop.trees.cval.dtype == F64
    pred = res.predict(X)
    assert pred.dtype == np.float64 and pred.shape == (40,)
    best = res.best_loss()
    f = sr.to_callable(best.tree.map(lambda v: v.to(F64) if v.is_floating_point()
                                     else v), res.options, device="cpu")
    np.testing.assert_array_equal(f(torch.tensor(X)).numpy(),
                                  res.predict(X, complexity=best.complexity))


def test_float64_options_accepted_without_the_reference_warning():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        o = sr.make_options(precision="float64")
    assert o.dtype == F64 and o != sr.make_options()
    assert o._graph_key() != sr.make_options()._graph_key()


def test_float64_in_subprocess():
    """The reference's tests/test_precision.py::test_float64_in_subprocess
    search, in this process (the port has no global flag) on the CPU."""
    rng = np.random.default_rng(0)
    X = (rng.standard_normal((2, 40)) * 2).astype("f8")
    y = X[0] * X[0]
    res = sr.equation_search(X, y, niterations=2,
                             binary_operators=["+", "*"], npop=16,
                             npopulations=2, ncycles_per_iteration=20,
                             tournament_selection_n=6, precision="float64",
                             verbosity=0, progress=False, maxsize=10,
                             device="cpu")
    assert res.best_loss().loss < 1e-8, res.best_loss().loss
