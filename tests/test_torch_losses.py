"""PyTorch port vs the JAX package, loss level: every loss of the registry
(its 26 names, and each of the 8 parameterised factories at a parameter
other than its default) through the port's forward and its seed
``LOSS_VJP`` against the JAX loss and ``jax.vjp`` on an edge grid; the
plain versions of the fused scoring epilogue (B2), the gradient kernel (B3)
and the loss-only kernel (B4) under every loss against the JAX package's
jnp composition, and under four losses against its Pallas kernels in
interpret mode; the kernels' plain mirrors against the plain versions; and
a search under ``L1DistLoss`` with the default BFGS. Small shapes: 28
programs (max_len 24) x 64 rows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu.models.trees as jtrees
from symbolicregression_jl_tpu.ops import interpreter as jinterp
from symbolicregression_jl_tpu.ops import losses as jlosses
from symbolicregression_jl_tpu.ops import operators as jops
from symbolicregression_jl_tpu.ops import pallas_eval as jpe
from symbolicregression_jl_tpu.ops import pallas_grad as jpg
import symbolicregression_jl_tpu_torch as sr
from symbolicregression_jl_tpu_torch.models import fitness as tfit
from symbolicregression_jl_tpu_torch.ops import kernel_eval as tke
from symbolicregression_jl_tpu_torch.ops import kernel_grad as tkg
from symbolicregression_jl_tpu_torch.ops import losses as tlosses
from symbolicregression_jl_tpu_torch.ops import operators as tops

from torch_port_helpers import jax_trees, loss_labels, loss_pair, port_trees

LABELS = loss_labels()
BASE = [0.0, -0.0, 1e-30, -1e-30, 1.0, -1.0, 0.5, -0.5, 2.0, -2.0, 0.3, -3.7,
        20.0, 100.0, -100.0, 1e4, -1e4, np.inf, -np.inf, np.nan]
TARGETS = np.array([0.0, 1.0, -1.0, 0.5, 2.0, -3.0], np.float32)
SUBNORMAL = 1e-36
# 1 - tanh(a) and d + log1p(exp(-2d)) - log 2 subtract values near 1 and
# log 2: XLA's and torch's CPU tanh / exp / log1p differ by up to two ulps
# there (2 x 6e-8), which the subtraction leaves as an absolute error
CANCELLING = {tlosses.SIGMOID: 2.4e-7, tlosses.LOG_COSH: 2.4e-7}


def _grid(port):
    """Predictions x targets: the edge values, and each of the loss's
    thresholds (its constants: delta, eps, 1 - gamma, q / (q + 1), ...)
    at, and one step either side of, the points where a residual or an
    agreement meets them; ties of a maximum at 0 and 1 come from the edge
    values."""
    extra = []
    for c in port.constants:
        if c:
            for v in (c, -c, 1.0 - c, 1.0 + c):
                extra += [v, np.nextafter(np.float32(v), np.float32(np.inf)),
                          np.nextafter(np.float32(v), np.float32(-np.inf))]
    P, T = np.meshgrid(np.array(BASE + extra, np.float32), TARGETS)
    return P.ravel(), T.ravel()


def _assert_close(got, ref, atol):
    """NaN where ``ref`` has NaN, infinities equal, the rest within rtol
    1e-6 plus ``atol`` (a number or one per element)."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    m = np.isfinite(ref)
    np.testing.assert_array_equal(got[~m], ref[~m])
    with np.errstate(invalid="ignore", over="ignore"):
        err = np.abs(got.astype(np.float64) - ref)
    tol = 1e-6 * np.abs(ref.astype(np.float64)) + np.broadcast_to(atol, ref.shape)
    assert np.all(err[m] <= tol[m]), [(g, r) for g, r in zip(
        got[m][err[m] > tol[m]], ref[m][err[m] > tol[m]])][:5]


@pytest.mark.parametrize("label", LABELS)
def test_loss_and_seed_match_jax_on_edge_grid(label):
    """The forward against the JAX loss, and ``LOSS_VJP`` times a
    cotangent against ``jax.vjp(loss, pred)(cotangent)``: NaN where JAX
    has NaN, infinities equal, values at rtol 1e-6. atol 1e-36 because
    XLA's CPU code flushes subnormal results to zero and torch keeps them
    (exp(-100) is 3.8e-44 in torch, 0 in XLA); 2.4e-7 for the two losses
    that subtract a transcendental value near 1 or log 2 (``CANCELLING``),
    and for SigmoidLoss's seed t (1 + tanh)(1 - tanh) x cotangent that
    error times |t| x 2 x the cotangent."""
    ref_fn, port = loss_pair(label)
    P, T = _grid(port)
    ct = np.random.default_rng(0).uniform(0.1, 2.0, P.shape).astype(np.float32)
    atol = CANCELLING.get(port.kind, SUBNORMAL)
    p, t = torch.tensor(P), torch.tensor(T)
    elem, vjp = jax.vjp(lambda x: ref_fn(x, jnp.asarray(T)), jnp.asarray(P))
    _assert_close(port(p, t).numpy(), elem, atol)
    (seed,) = vjp(jnp.asarray(ct))
    if port.kind == tlosses.SIGMOID:
        atol = atol * np.abs(T) * 2.0 * ct
    _assert_close((port.seed(p, t) * torch.tensor(ct)).numpy(), seed, atol)


@pytest.mark.parametrize("label", LABELS)
def test_options_take_constant_optimisation_under_every_loss(label):
    """Default Options (BFGS on) take every loss, by name or as the
    factory's ``ElementwiseLoss``; both spellings resolve to the same
    kind and constants, and Options stays hashable."""
    _, port = loss_pair(label)
    opts = sr.make_options(loss=label if label in tlosses.LOSS_REGISTRY
                           else port)
    assert opts.should_optimize_constants
    assert tlosses.resolve_loss(opts.loss) == port
    hash(opts)


def test_registry_kinds_and_constants():
    """The port's registry has the JAX package's names; a factory at its
    default is the registry's entry (``huber_loss(2.0)`` and
    ``"HuberLoss"`` differ only in the constant); 21 distinct losses; the
    constants are the JAX package's Python expressions, rounded to
    float32."""
    assert set(tlosses.LOSS_REGISTRY) == set(jlosses.LOSS_REGISTRY)
    assert len({v.kind for v in tlosses.LOSS_REGISTRY.values()}) == 21
    assert tlosses.huber_loss() == tlosses.LOSS_REGISTRY["HuberLoss"]
    assert tlosses.huber_loss(2.0).kind == tlosses.LOSS_REGISTRY["HuberLoss"].kind
    assert tlosses.huber_loss(2.0).constants == (2.0, 1.0, 0.0)
    f32 = lambda v: float(np.float32(v))
    assert tlosses.smoothed_l1_hinge_loss(0.3).constants == (
        f32(1.0 - 0.3), f32(0.5 / 0.3), f32(1.0 - 0.3 / 2.0))
    assert tlosses.dwd_margin_loss(2.0).constants == (
        f32(2.0 / 3.0), f32(4.0 / 27.0), 2.0)
    assert tlosses.quantile_loss(0.3).constants == (f32(0.3), f32(0.3 - 1.0), 0.0)
    assert len({tlosses.huber_loss(1.0), tlosses.LOSS_REGISTRY["HuberLoss"]}) == 1


def test_lane_sum_four_rows_per_lane_is_the_kernel_order():
    """The fused mode's usual layout: lane l adds rows 4l .. 4l + 3 of each
    128-row pass in order, pass after pass, then the butterfly; checked
    against the same sums written out in numpy float32 on a ragged row
    count."""
    rng = np.random.default_rng(1)
    terms = (rng.standard_normal((4, 300)) * 10.0 ** rng.integers(
        -6, 6, (4, 300))).astype(np.float32)
    lanes = np.zeros((4, 32), np.float32)
    for r in range(300):
        lanes[:, (r % 128) // 4] += terms[:, r]
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, np.arange(32) ^ off]
    got = tke.lane_sum(torch.tensor(terms), 4).numpy()
    np.testing.assert_array_equal(got.view(np.int32), lanes[:, 0].view(np.int32))


# ---------------------------------------------------------------------------
# The kernels' plain versions under every loss
# ---------------------------------------------------------------------------

BINS = ["+", "-", "*", "/"]
UNAS = ["cos", "exp"]
JOPS = jops.make_operator_set(BINS, UNAS)
TOPS = tops.make_operator_set(BINS, UNAS)
NFEAT, NROWS = 2, 64
ZERO_ROWS = (3, 40)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(7)
    p = lambda s: jtrees.parse_expression(s, JOPS)
    edge = [p("x0 / (x1 - x1)"), p("exp(exp(exp(x1 * 3.5)))"), p("0.8"),
            p("x1"), p("0.7 + cos(x0 * 1.3)"), p("(0.3 * x1) - exp(-0.4 + x0)")]
    jt = jax_trees(rng, JOPS, 22, NFEAT, max_size=20, exprs=edge)
    X = (rng.standard_normal((NFEAT, NROWS)) * 1.5).astype(np.float32)
    y = rng.standard_normal(NROWS).astype(np.float32)
    w = rng.uniform(0.2, 2.0, NROWS).astype(np.float32)
    w[list(ZERO_ROWS)] = 0.0
    return jt, X, y, w


@pytest.fixture(scope="module")
def jnp_reference(case):
    """The JAX package's jnp composition, compiled once for every loss:
    per tree, ``aggregate_loss(loss_fn(y_pred, y), weights)`` over the
    interpreter's prediction and its ``jax.grad`` with respect to the
    constants (vmapped over the trees), the loss picked by ``lax.switch``;
    (loss, ok, grad) as numpy, per (label, weighted)."""
    jt, X, y, w = case
    fns = [loss_pair(label)[0] for label in LABELS]

    def member(kind, op, feat, cval, length, idx, weighted):
        pred, ok = jinterp._eval_single(kind, op, feat, cval, length,
                                        jnp.asarray(X), JOPS)
        elem = jax.lax.switch(idx, [lambda a, f=f: f(a, jnp.asarray(y))
                                    for f in fns], pred)
        return jlosses.aggregate_loss(
            elem, jnp.asarray(w) if weighted else None), ok

    def batch(idx, weighted):
        grad = jax.value_and_grad(member, argnums=3, has_aux=True)
        return jax.vmap(grad, in_axes=(0, 0, 0, 0, 0, None, None))(
            jt.kind, jt.op, jt.feat, jt.cval, jt.length, idx, weighted)

    run = jax.jit(batch, static_argnums=1)
    memo = {}

    def get(label, weighted):
        if (label, weighted) not in memo:
            (loss, ok), grad = run(LABELS.index(label), weighted)
            memo[label, weighted] = (np.asarray(loss), np.asarray(ok),
                                     np.asarray(grad))
        return memo[label, weighted]

    return get


def _assert_grad_close(got, ref, ok, extra=0.0):
    """Trees without poison: NaN where the reference has NaN; values at
    rtol 1e-4 with atol 1e-6 x the tree's largest finite gradient (plus
    ``extra``, one per element). The two sum rows in float32 in different
    orders, and a gradient sums terms of both signs, so a small component
    can lose digits the large one keeps (tests/test_torch_grad.py)."""
    extra = np.broadcast_to(extra, ref.shape)[ok]
    got, ref = got[ok], ref[ok]
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    scale = np.where(np.isfinite(ref), np.abs(ref), 0.0).max(axis=1,
                                                              keepdims=True)
    m = np.isfinite(ref)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    tol = 1e-4 * np.abs(ref) + 1e-6 * scale + extra
    assert np.all(np.abs(got - ref)[m] <= tol[m]), np.max(
        (np.abs(got - ref) - tol)[m])


def _sigmoid_yardstick(jt, X, y, w):
    """SigmoidLoss's seed t (1 + tanh)(1 - tanh) carries the two ulps
    (2.4e-7) by which XLA's tanh and torch's differ near 1, times |t| x 2
    (test_loss_and_seed_match_jax_on_edge_grid), through the cancellation;
    a constant's gradient gets that times wn |d pred / d c| from each row:
    (T, L), from the JAX interpreter's Jacobian."""
    _, _, jac = jinterp.eval_grad_constants(jt, jnp.asarray(X), JOPS)
    wn = np.full(NROWS, 1.0 / NROWS) if w is None else w / w.sum()
    with np.errstate(invalid="ignore", over="ignore"):
        bound = (4.8e-7 * np.abs(y) * wn * np.abs(np.asarray(jac))).sum(-1)
    return np.where(np.isfinite(bound), bound, np.inf)


def _assert_losses_close(got, ok, ref, ok_ref, rtol):
    np.testing.assert_array_equal(ok, ok_ref)
    np.testing.assert_array_equal(np.isfinite(got[ok]), np.isfinite(ref[ok]))
    fin = ok & np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=rtol)
    return fin


@pytest.mark.parametrize("label", LABELS)
def test_plain_kernels_match_the_jnp_composition(case, jnp_reference, label):
    """Under each loss, unweighted and weighted (two zero-weight rows):
    B3's plain version (loss at rtol 1e-5, the rows summed in another
    order; gradients as ``_assert_grad_close``), B4's (its loss the bits of
    B3's), and unweighted B2's (contained to +inf like the reference's
    ``contain_nonfinite``) against the JAX package's jnp composition; the
    kernels' plain mirrors (``eval_loss_grad_program_plain``, and B2's
    ``eval_loss_trees_program_plain`` at two row ranges of 4 rows per lane)
    against the plain versions."""
    jt, X, y, w = case
    _, loss = loss_pair(label)
    tt, Xt, yt = port_trees(jt), torch.tensor(X), torch.tensor(y)
    for weighted in (False, True):
        wt = torch.tensor(w) if weighted else None
        ref_loss, ref_ok, ref_grad = jnp_reference(label, weighted)
        l3, g3, ok3 = tkg.eval_loss_grad(tt, Xt, yt, wt, TOPS, loss=loss)
        l3, g3, ok3 = l3.numpy(), g3.numpy(), ok3.numpy()
        fin = _assert_losses_close(l3, ok3, ref_loss, ref_ok, 1e-5)
        assert 0 < ok3.sum() < len(ok3)
        # the jnp interpreter runs every operator at every slot and selects
        # one, so an operator that overflows where it was not selected
        # reaches jax.grad as 0 x inf = NaN; the kernels and the plain
        # versions dispatch. Such trees' gradients are held against the
        # Pallas kernel (test_plain_kernels_match_pallas), the rest here
        clean = fin & ~np.isnan(ref_grad).any(-1)
        assert clean.sum() >= 0.75 * fin.sum(), (clean.sum(), fin.sum())
        _assert_grad_close(g3, ref_grad, clean,
                           _sigmoid_yardstick(jt, X, y, w if weighted else None)
                           if loss.kind == tlosses.SIGMOID else 0.0)
        l4, ok4 = tkg.eval_loss(tt, Xt, yt, wt, TOPS, loss=loss)
        np.testing.assert_array_equal(ok4.numpy(), ok3)
        np.testing.assert_array_equal(l4.numpy().view(np.int32),
                                      l3.view(np.int32))
        lm, gm, okm = tkg.eval_loss_grad_program_plain(tt, Xt, yt, wt, TOPS,
                                                       loss=loss)
        np.testing.assert_array_equal(okm.numpy(), ok3)
        fin_m = ok3 & np.isfinite(l3)
        np.testing.assert_array_equal(np.isfinite(lm.numpy()[ok3]),
                                      np.isfinite(l3[ok3]))
        np.testing.assert_allclose(lm.numpy()[fin_m], l3[fin_m], rtol=1e-5)
        _assert_grad_close(gm.numpy(), g3, fin_m)
    l2 = tke.eval_loss_trees(tt, Xt, yt, TOPS, loss).numpy()
    ref_loss, ref_ok, _ = jnp_reference(label, False)
    ref2 = np.where(ref_ok & np.isfinite(ref_loss), ref_loss, np.inf)
    np.testing.assert_array_equal(np.isinf(l2), np.isinf(ref2))
    fin = np.isfinite(ref2)
    np.testing.assert_allclose(l2[fin], ref2[fin], rtol=1e-5)
    assert np.array_equal(tfit.eval_loss_trees(tt, Xt, yt, None, TOPS, label
                                               if label in tlosses.LOSS_REGISTRY
                                               else loss).numpy(), l2)
    plan = tke.EvalPlan(2, 4, 1, 1, False, 128, 0, 0)
    sums, ok2 = tke.eval_loss_trees_program_plain(tt, Xt, yt, TOPS, loss, plan)
    mine = np.where(ok2.numpy() & np.isfinite(sums.numpy()),
                    sums.numpy() / NROWS, np.inf)
    np.testing.assert_array_equal(np.isinf(mine), np.isinf(l2))
    np.testing.assert_allclose(mine[fin], l2[fin], rtol=1e-5)


PALLAS_LABELS = ["L1DistLoss", "HuberLoss", "LogCoshLoss", "quantile_loss(0.3)"]


@pytest.mark.parametrize("label", PALLAS_LABELS)
def test_plain_kernels_match_pallas(case, label):
    """The Pallas kernels in interpret mode with ``loss_fn``: B3
    (``eval_loss_grad_pallas``, weighted with two zero-weight rows) against
    the plain gradient and loss-only versions, B2
    (``eval_loss_trees_pallas``) against the plain fused loss; losses at
    rtol 1e-5 (B2 1e-4: per-128-row-tile sums against torch's order, the
    tolerance of tests/test_torch_program.py), gradients as
    ``_assert_grad_close``."""
    jt, X, y, w = case
    ref_fn, loss = loss_pair(label)
    kw = dict(interpret=True, t_block=8, r_block=128, tree_unroll=1)
    lr, gr, okr = (np.asarray(o) for o in jpg.eval_loss_grad_pallas(
        jt, jnp.asarray(X), jnp.asarray(y), jnp.asarray(w), JOPS,
        loss_fn=ref_fn, **kw))
    tt, Xt, yt, wt = port_trees(jt), torch.tensor(X), torch.tensor(y), \
        torch.tensor(w)
    l3, g3, ok3 = (o.numpy() for o in tkg.eval_loss_grad(tt, Xt, yt, wt, TOPS,
                                                         loss=loss))
    fin = _assert_losses_close(l3, ok3, lr, okr, 1e-5)
    _assert_grad_close(g3, gr, fin)
    l4, ok4 = tkg.eval_loss(tt, Xt, yt, wt, TOPS, loss=loss)
    _assert_losses_close(l4.numpy(), ok4.numpy(), lr, okr, 1e-5)
    ref2 = np.asarray(jpe.eval_loss_trees_pallas(
        jt, jnp.asarray(X), jnp.asarray(y), JOPS, ref_fn, **kw))
    l2 = tke.eval_loss_trees(tt, Xt, yt, TOPS, loss).numpy()
    np.testing.assert_array_equal(np.isinf(l2), np.isinf(ref2))
    fin = np.isfinite(ref2)
    np.testing.assert_allclose(l2[fin], ref2[fin], rtol=1e-4)


def test_equation_search_under_l1_runs_its_bfgs_on_cpu(monkeypatch):
    """``loss="L1DistLoss"`` at the default Options (BFGS on): the search
    runs to its end through the plain versions (no kernel launch on the
    CPU), each iteration's BFGS pass staged both kernels under L1, and the
    best candidate's loss is the mean absolute error of its prediction."""
    from symbolicregression_jl_tpu_torch.models import constant_opt as tco

    staged = []
    make = tco.make_loss_kernel

    def spy(*a, **k):
        staged.append(k["loss"])
        return make(*a, **k)

    monkeypatch.setattr(tco, "make_loss_kernel", spy)
    rng = np.random.default_rng(0)
    X = rng.uniform(-3, 3, (2, 100)).astype(np.float32)
    y = (2.5 * np.cos(X[0]) + 0.7).astype(np.float32)
    before = dict(tkg.LAUNCHES)
    res = sr.equation_search(
        X, y, device="cpu", loss="L1DistLoss", binary_operators=["+", "*"],
        unary_operators=["cos"], npopulations=2, npop=30, maxsize=8,
        ncycles_per_iteration=10, niterations=2, seed=0, verbosity=0)
    assert res.options.should_optimize_constants
    assert staged == [tlosses.l1_dist_loss] * 4  # gradient + line search, x 2
    assert tkg.LAUNCHES == before and not any(tke.LAUNCHES.values())
    best = res.best_loss()
    assert np.isfinite(best.loss)
    mae = np.mean(np.abs(res.predict(X, complexity=best.complexity) - y))
    np.testing.assert_allclose(best.loss, mae, rtol=1e-5)
