"""The interpreter's derivatives, the fused loss and the tree helpers of
the port against the JAX package's: ``eval_grad_constants``,
``eval_grad_variables`` and ``eval_diff_tree`` (forward and reverse mode
over the lockstep interpreter) against ``jax.jacfwd`` / ``jax.grad`` /
``jax.jvp`` over the jnp interpreter, non-finite at the same places, within
rtol 1e-4 + atol 1e-6 plus 4 x the reference's own distance from the
float64 value (the JAX package's interpreter at float64, so the term shares
no code with the port): random chains of up to 14 nodes through ``exp`` and
``sin`` cancel, and there an ulp of one operator becomes a large relative
error in both float32 results;
``eval_loss_trees_fused`` against the jnp reference (rtol 1e-4) and, on its
fused route, against the Pallas kernel in interpret mode (rtol 1e-4,
per-128-row-tile sums); ``pairwise_sum`` and
``aggregate_loss(deterministic=True)`` bit-equal, ``tile_rows`` at rtol
1e-5 (XLA and torch sum a tile's 256 rows in different orders);
``tree_hash``, ``get_constants`` and ``set_constants`` bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symbolicregression_jl_tpu.models import trees as jtrees
from symbolicregression_jl_tpu.ops import interpreter as jinterp
from symbolicregression_jl_tpu.ops import losses as jlosses
from symbolicregression_jl_tpu.ops import pallas_eval as jpe
from symbolicregression_jl_tpu.ops.operators import (
    make_operator_set as jmake_ops,
)
from symbolicregression_jl_tpu_torch.models import trees as ttrees
from symbolicregression_jl_tpu_torch.ops import interpreter as tinterp
from symbolicregression_jl_tpu_torch.ops import losses as tlosses
from symbolicregression_jl_tpu_torch.ops.operators import (
    make_operator_set as tmake_ops,
)

from torch_port_helpers import jax_trees, port_trees

BIN, UNA = ["+", "-", "*", "/"], ["cos", "exp", "sin"]
JOPS, TOPS = jmake_ops(BIN, UNA), tmake_ops(BIN, UNA)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    jt = jax_trees(rng, JOPS, 24, 3, max_size=14)
    X = rng.uniform(-2, 2, (3, 40)).astype(np.float32)
    return jt, port_trees(jt), X


# The JAX package's derivatives of one tree, jitted once for the module:
# the six single-tree cases below (and their float64 yardsticks) share a
# compile per dtype instead of tracing the interpreter's scan anew on
# every call.
_J_GRAD_VARIABLES = jax.jit(jinterp.eval_grad_variables, static_argnums=2)
_J_DIFF_TREE = jax.jit(jinterp.eval_diff_tree, static_argnums=(2, 3))


def _single(jt, i):
    return jax.tree_util.tree_map(lambda a: a[i], jt)


def _close(got, ref, ref64=None):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    tol = 1e-4 * np.abs(ref) + 1e-6
    if ref64 is not None:
        ref64 = np.asarray(ref64)
        fin &= np.isfinite(ref64)
        tol = tol + 4 * np.abs(np.where(fin, ref - ref64, 0.0))
    assert np.all(np.abs(got - ref)[fin] <= tol[fin]), np.max(
        (np.abs(got - ref) - tol)[fin])


def _ref64(fn, jt, X, *args):
    """``fn`` of the JAX package at float64 on the same trees and X: the
    conditioning yardstick, computed without the port's code."""
    with jax.enable_x64():
        out = fn(jt._replace(cval=jnp.asarray(np.asarray(jt.cval),
                                              jnp.float64)),
                 jnp.asarray(X, jnp.float64), JOPS, *args)
        return tuple(np.asarray(o) for o in out)


def test_eval_grad_constants_matches_jacfwd(case):
    jt, tt, X = case
    y, ok, dy = tinterp.eval_grad_constants(tt, torch.tensor(X), TOPS)
    jy, jok, jdy = jinterp.eval_grad_constants(jt, jnp.asarray(X), JOPS)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert dy.shape == (24, 24, 40)
    y64, _, dy64 = _ref64(jinterp.eval_grad_constants, jt, X)
    m = np.asarray(jok)
    _close(y.numpy()[m], np.asarray(jy)[m], y64[m])
    _close(dy.numpy()[m], np.asarray(jdy)[m], dy64[m])


@pytest.mark.parametrize("i", range(6))
def test_eval_grad_variables_and_diff_tree(case, i):
    jt, tt, X = case
    jt1, tt1 = _single(jt, i), tt[i]
    y, g = tinterp.eval_grad_variables(tt1, torch.tensor(X), TOPS)
    jy, jg = _J_GRAD_VARIABLES(jt1, jnp.asarray(X), JOPS)
    y64, g64 = _ref64(_J_GRAD_VARIABLES, jt1, X)
    _close(g.numpy(), jg, g64)
    _close(y.numpy(), jy, y64)
    for direction in range(3):
        y, dy, ok = tinterp.eval_diff_tree(tt1, torch.tensor(X), TOPS,
                                           direction)
        jy, jdy, jok = _J_DIFF_TREE(jt1, jnp.asarray(X), JOPS, direction)
        _, dy64, _ = _ref64(_J_DIFF_TREE, jt1, X, direction)
        assert bool(ok) == bool(jok)
        _close(dy.numpy(), jdy, dy64)


@pytest.mark.parametrize("deterministic", [False, True])
@pytest.mark.parametrize("rows_per_tile", [0, 16])
@pytest.mark.parametrize("weighted", [False, True])
def test_eval_loss_trees_fused_matches_the_reference(case, weighted,
                                                     rows_per_tile,
                                                     deterministic):
    jt, tt, X = case
    rng = np.random.default_rng(1)
    y = (X[0] * X[1] + np.cos(X[2])).astype(np.float32)
    w = rng.uniform(0.2, 2.0, 40).astype(np.float32) if weighted else None
    loss = tlosses.LOSS_REGISTRY["L2DistLoss"]
    got = tinterp.eval_loss_trees_fused(
        tt, torch.tensor(X), torch.tensor(y),
        None if w is None else torch.tensor(w), TOPS, loss,
        rows_per_tile=rows_per_tile, deterministic=deterministic)
    ref = jinterp.eval_loss_trees_fused(
        jt, jnp.asarray(X), jnp.asarray(y), None if w is None else
        jnp.asarray(w), JOPS, jlosses.LOSS_REGISTRY["L2DistLoss"],
        rows_per_tile=rows_per_tile, deterministic=deterministic)
    _close(got.numpy(), ref)


def test_eval_loss_trees_fused_route_matches_pallas():
    """Unweighted, untiled, non-deterministic: the fused route (the
    scoring kernel's fused mode's plain version here, B2 on the card)
    against the Pallas fused-loss kernel in interpret mode."""
    rng = np.random.default_rng(2)
    jt = jax_trees(rng, JOPS, 16, 3, max_size=14)
    X = rng.uniform(-2, 2, (3, 128)).astype(np.float32)
    y = (X[0] * X[1]).astype(np.float32)
    got = tinterp.eval_loss_trees_fused(
        port_trees(jt), torch.tensor(X), torch.tensor(y), None, TOPS,
        tlosses.LOSS_REGISTRY["L2DistLoss"]).numpy()
    ref = np.asarray(jpe.eval_loss_trees_pallas(
        jt, jnp.asarray(X), jnp.asarray(y), JOPS,
        jlosses.LOSS_REGISTRY["L2DistLoss"], interpret=True, t_block=8,
        r_block=128, tree_unroll=1))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-4)


@pytest.mark.parametrize("n", [1, 5, 128, 300, 2048])
def test_pairwise_sum_and_deterministic_aggregate_bit_equal(n):
    rng = np.random.default_rng(n)
    e = rng.standard_normal((3, n)).astype(np.float32)
    w = rng.uniform(0, 1, n).astype(np.float32)
    np.testing.assert_array_equal(
        tlosses.pairwise_sum(torch.tensor(e)).numpy(),
        np.asarray(jlosses.pairwise_sum(jnp.asarray(e))))
    np.testing.assert_array_equal(
        tlosses.pairwise_sum(torch.tensor(e.T), axis=0).numpy(),
        np.asarray(jlosses.pairwise_sum(jnp.asarray(e.T), axis=0)))
    for weights in (None, w):
        got = tlosses.aggregate_loss(
            torch.tensor(e), None if weights is None else torch.tensor(weights),
            deterministic=True)
        ref = jlosses.aggregate_loss(
            jnp.asarray(e), None if weights is None else jnp.asarray(weights),
            deterministic=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_allclose(
        tlosses.aggregate_loss(torch.tensor(e), tile_rows=256).numpy(),
        np.asarray(jlosses.aggregate_loss(jnp.asarray(e), tile_rows=256)),
        rtol=1e-5)


def test_tile_rows_refuses_what_the_reference_refuses():
    e = torch.ones(2, 300)
    for kw in (dict(weights=torch.ones(300)), dict(deterministic=True),
               dict(tile_rows_value=100)):
        tile = kw.pop("tile_rows_value", 128)
        with pytest.raises(ValueError, match="tile_rows"):
            tlosses.aggregate_loss(e, tile_rows=tile, **kw)


def test_tree_hash_bit_equal_and_canonical(case):
    """The same 64-bit digests as the JAX package's tree_hash, for a batch
    and a single tree, at float32 and bfloat16 constants; a padded tail's
    garbage and max_len do not move them."""
    jt, tt, _ = case
    np.testing.assert_array_equal(ttrees.tree_hash(tt), jtrees.tree_hash(jt))
    assert ttrees.tree_hash(tt[3]) == jtrees.tree_hash(_single(jt, 3))
    bf = tt._replace(cval=tt.cval.to(torch.bfloat16))
    jbf = jt._replace(cval=jnp.asarray(jt.cval, jnp.bfloat16))
    np.testing.assert_array_equal(ttrees.tree_hash(bf), jtrees.tree_hash(jbf))
    noisy = tt._replace(op=tt.op + 7 * (torch.arange(24) >= tt.length[:, None]),
                        cval=tt.cval + 3.0 * (torch.arange(24)
                                              >= tt.length[:, None]))
    np.testing.assert_array_equal(ttrees.tree_hash(noisy), ttrees.tree_hash(tt))
    wide = ttrees.encode_tree(ttrees.decode_tree(tt[0]), 40, device="cpu")
    assert ttrees.tree_hash(wide) == ttrees.tree_hash(tt[0])


def test_get_and_set_constants(case):
    jt, tt, _ = case
    cval, mask = ttrees.get_constants(tt)
    jcval, jmask = jtrees.get_constants(jt)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(cval.numpy(), np.asarray(jcval))
    new = np.random.default_rng(4).standard_normal(cval.shape).astype("f4")
    got = ttrees.set_constants(tt, torch.tensor(new))
    ref = jtrees.set_constants(jt, jnp.asarray(new))
    np.testing.assert_array_equal(got.cval.numpy(), np.asarray(ref.cval))
