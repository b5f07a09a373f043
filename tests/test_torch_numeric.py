"""PyTorch port vs the JAX package, numeric level: the operator library on
a grid with the guard edges, the scoring kernel's plain version (value
mode and fused L2 loss) against the Pallas kernel in interpret mode and the
jnp interpreter, and the port's lockstep interpreter. Trees include ones
that divide by zero or overflow exp, single leaves and full-length
programs; row counts are not multiples of 128."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

import symbolicregression_jl_tpu.models.trees as jtrees
from symbolicregression_jl_tpu.ops import interpreter as jinterp
from symbolicregression_jl_tpu.ops import losses as jlosses
from symbolicregression_jl_tpu.ops import operators as jops
from symbolicregression_jl_tpu.ops import pallas_eval as jpe
from symbolicregression_jl_tpu_torch.ops import interpreter as tinterp
from symbolicregression_jl_tpu_torch.ops import kernel_eval as tke
from symbolicregression_jl_tpu_torch.ops import losses as tlosses
from symbolicregression_jl_tpu_torch.ops import operators as tops

from torch_port_helpers import L, jax_trees, port_trees

E = jtrees.Expr
GRID = np.array(
    [0.0, -0.0, 1e-30, -1e-30, 1e-7, 0.5, -0.5, 1.0, -1.0, 2.0, -2.5, 3.0,
     -3.7, 10.0, -10.0, 88.0, 89.5, -89.5, 100.0, -100.0, 1e6, -1e6, 3e38,
     -3e38, np.inf, -np.inf, np.nan] + list(np.linspace(-7, 7, 29)),
    np.float32)


def _assert_close_nan_equal(got, ref, rtol, atol):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    fin = ~np.isnan(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", sorted(tops.KERNEL_UNARY_IDS))
def test_unary_operator_grid(name):
    got = tops.UNARY_REGISTRY[name](torch.tensor(GRID)).numpy()
    ref = np.asarray(jops.UNARY_REGISTRY[name](jnp.asarray(GRID)))
    if name in ("sinh", "cosh", "gamma"):
        # XLA's f32 sinh/cosh are 1.4e-6 off for |x| > ~10, and its gamma
        # (exp of lgamma) up to 2.8e-6 (gamma(10) = 362881 against 362880),
        # measured against float64; torch's are within 1e-6 of it. Hold
        # the port to the float64 value instead, and to JAX only on where
        # NaN/inf land
        np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
        f64 = scipy.special.gamma if name == "gamma" else getattr(np, name)
        with np.errstate(over="ignore", invalid="ignore"):
            ref64 = f64(GRID.astype(np.float64)).astype(np.float32)
        ref = np.where(np.isnan(ref), ref, ref64)
    _assert_close_nan_equal(got, ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", sorted(tops.KERNEL_BINARY_IDS))
def test_binary_operator_grid(name):
    a, b = np.meshgrid(GRID, GRID, indexing="ij")
    ref = jops.BINARY_REGISTRY[name](jnp.asarray(a), jnp.asarray(b))
    got = tops.BINARY_REGISTRY[name](torch.tensor(a), torch.tensor(b))
    _assert_close_nan_equal(got.numpy(), ref, rtol=1e-6, atol=1e-7)


def test_mod_is_exact_where_the_quotient_overflows():
    """mod(3e38, y) for the grid's small y: x / y overflows, so
    x - floor(x / y) * y (torch.remainder) is NaN; jnp.mod's truncated
    remainder is exact, and so is the port's (0.0 at y = 0.5, 7.0e-8 at
    y = 1e-7): bit-equal at all 14 such grid points."""
    a, b = np.meshgrid(GRID, GRID, indexing="ij")
    pts = np.isfinite(a) & np.isfinite(b) & np.isnan(
        torch.remainder(torch.tensor(a), torch.tensor(b)).numpy()) & (b != 0)
    assert pts.sum() == 14 and (np.abs(a[pts]) == np.float32(3e38)).all()
    ref = np.asarray(jops.mod_op(jnp.asarray(a[pts]), jnp.asarray(b[pts])))
    got = tops.mod_op(torch.tensor(a[pts]), torch.tensor(b[pts])).numpy()
    assert np.isfinite(ref).all()
    np.testing.assert_array_equal(got, ref)
    assert tops.mod_op(torch.tensor(3e38), torch.tensor(0.5)).item() == 0.0


BINS = ["+", "-", "*", "/"]
UNAS = ["cos", "exp", "sqrt", "log"]
JOPS = jops.make_operator_set(BINS, UNAS)
TOPS = tops.make_operator_set(BINS, UNAS)
NFEAT = 3


def _edge_exprs():
    """Division by zero, exp overflow, a single leaf, a full-length tree."""
    b = JOPS.binary_index
    u = JOPS.unary_index
    x0 = E.var(0)
    div0 = E.binary(b("/"), x0, E.binary(b("-"), x0, x0))
    overflow = E.unary(u("exp"), E.unary(u("exp"), E.unary(u("exp"), x0)))
    full = x0
    while full.size() + 2 < L:
        full = E.binary(b("+"), full, E.const(0.25))
    full = E.unary(u("cos"), full)  # 23 binary-chain nodes + 1 = L
    return [div0, overflow, E.const(1.5), E.var(2), full]


@pytest.fixture(scope="module")
def trees():
    jt = jax_trees(np.random.default_rng(7), JOPS, 40, NFEAT,
                   exprs=_edge_exprs())
    assert int(np.asarray(jt.length).max()) == L
    return jt


@pytest.fixture(scope="module", params=[37, 200])
def data(request):
    rng = np.random.default_rng(request.param)
    X = (rng.standard_normal((NFEAT, request.param)) * 2).astype(np.float32)
    y = rng.standard_normal(request.param).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def pallas_ref(trees):
    """The Pallas kernel in interpret mode, value and fused-loss epilogues,
    on 200 rows (two 128-row tiles, the second one ragged)."""
    rng = np.random.default_rng(200)
    X = (rng.standard_normal((NFEAT, 200)) * 2).astype(np.float32)
    y = rng.standard_normal(200).astype(np.float32)
    kw = dict(t_block=8, r_block=128, interpret=True)
    y_pl, ok_pl = jpe.eval_trees_pallas(trees, jnp.asarray(X), JOPS, **kw)
    loss_pl = jpe.eval_loss_trees_pallas(trees, jnp.asarray(X), jnp.asarray(y),
                                         JOPS, jlosses.l2_dist_loss, **kw)
    return X, y, np.asarray(y_pl), np.asarray(ok_pl), np.asarray(loss_pl)


def _assert_value_mode(X, y_ref, ok_ref, trees):
    """y at rtol 1e-5 / atol 1e-6 where finite; ok equal."""
    y_t, ok_t = tke.eval_trees(port_trees(trees), torch.tensor(X), TOPS)
    ok_ref = np.asarray(ok_ref)
    np.testing.assert_array_equal(ok_t.numpy(), ok_ref)
    np.testing.assert_allclose(y_t.numpy()[ok_ref], np.asarray(y_ref)[ok_ref],
                               rtol=1e-5, atol=1e-6)
    assert 0 < int(ok_t.sum()) < len(ok_t)


def test_plain_value_mode_matches_pallas(trees, pallas_ref):
    X, _, y_pl, ok_pl, _ = pallas_ref
    _assert_value_mode(X, y_pl, ok_pl, trees)


def test_plain_value_mode_matches_jax_interpreter(trees, data):
    X, _ = data
    y_in, ok_in = jinterp.eval_trees(trees, jnp.asarray(X), JOPS)
    _assert_value_mode(X, y_in, ok_in, trees)


def test_port_interpreter_matches_jax_interpreter(trees, data):
    X, _ = data
    y_in, ok_in = jinterp.eval_trees(trees, jnp.asarray(X), JOPS)
    y_t, ok_t = tinterp.eval_trees(port_trees(trees), torch.tensor(X), TOPS)
    ok_in = np.asarray(ok_in)
    np.testing.assert_array_equal(ok_t.numpy(), ok_in)
    np.testing.assert_allclose(y_t.numpy()[ok_in], np.asarray(y_in)[ok_in],
                               rtol=1e-5, atol=1e-6)


def test_plain_fused_loss_matches_pallas(trees, pallas_ref):
    """The Pallas epilogue sums each 128-row tile and folds the tiles in
    order; the plain version sums all rows in torch's order. The two
    reduction orders differ in rounding only, hence rtol 1e-5 (not bit
    equality); +inf positions must be equal."""
    X, y, _, _, ref = pallas_ref
    got = tke.eval_loss_trees(port_trees(trees), torch.tensor(X),
                              torch.tensor(y), TOPS)
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got.numpy()[fin], ref[fin], rtol=1e-5)


def test_slot_values_match_per_subtree_evaluation(trees):
    """Every slot's value (the constant-folding input) equals the value of
    that slot's subtree evaluated on its own."""
    tt = port_trees(trees)
    X1 = torch.tensor([[0.75], [-1.5], [2.0]])
    vals, _ = tke.eval_slot_values(tt, X1, TOPS)
    root, _ = tke.eval_trees(tt, X1, TOPS)
    n = tt.length
    np.testing.assert_array_equal(
        vals[torch.arange(len(n)), (n - 1).clamp_min(0)].numpy(),
        root[:, 0].numpy())
    assert (vals[torch.arange(L) >= n.unsqueeze(-1)] == 0).all()


@pytest.mark.parametrize("name", ["L2DistLoss", "L1DistLoss", "HuberLoss",
                                  "LogCoshLoss"])
def test_losses_and_aggregation(name):
    rng = np.random.default_rng(2)
    p, t, w = (rng.standard_normal((3, 50)).astype(np.float32) for _ in range(3))
    w = np.abs(w)
    ref = jlosses.LOSS_REGISTRY[name](jnp.asarray(p), jnp.asarray(t))
    got = tlosses.LOSS_REGISTRY[name](torch.tensor(p), torch.tensor(t))
    # atol 1e-6: LogCosh subtracts log 2 and loses absolute digits near 0
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tlosses.aggregate_loss(got, torch.tensor(w)).numpy(),
        np.asarray(jlosses.aggregate_loss(ref, jnp.asarray(w))), rtol=1e-6)
