"""PyTorch port vs the JAX package, constant-gradient level: the derivative
table of every kernel operator against ``jax.vjp`` of the JAX registry, and
the plain versions of the loss+gradient kernel (B3) and its loss-only
variant (B4) against the Pallas kernels in interpret mode on the same
trees and data. Trees include poisoning ones, bare leaves, a full-length
program and a unary slot whose left sibling is a constant; rows (300) span
three 128-row tiles of the Pallas grid, and one weighted case has
zero-weight rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu.models.trees as jtrees
from symbolicregression_jl_tpu.ops import operators as jops
from symbolicregression_jl_tpu.ops import pallas_grad as jpg
from symbolicregression_jl_tpu_torch.ops import kernel_eval as tke
from symbolicregression_jl_tpu_torch.ops import kernel_grad as tkg
from symbolicregression_jl_tpu_torch.ops import operators as tops

from torch_port_helpers import L, jax_trees, port_trees

GRID = np.array(
    [0.0, -0.0, 1e-30, -1e-30, 1e-7, 0.5, -0.5, 1.0, -1.0, 2.0, -2.5, 3.0,
     -3.7, 10.0, -10.0, 88.0, 89.5, -89.5, 100.0, -100.0, 1e6, -1e6, 3e38,
     -3e38, np.inf, -np.inf, np.nan] + list(np.linspace(-7, 7, 29)),
    np.float32)


SUBNORMAL = 1e-36


def _assert_vjp_equal(got, ref, rtol=1e-6, atol=SUBNORMAL):
    """NaN where JAX has NaN, values at rtol; atol 1e-36 because XLA's CPU
    code flushes subnormal values to zero and torch keeps them (3e38^-1
    times log(3e38) is 3e-37 in torch, 0 in XLA)."""
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    fin = ~np.isnan(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", sorted(tops.KERNEL_UNARY_IDS))
def test_unary_derivative_matches_jax_vjp(name):
    """At adjoint 1 (the derivative) and 0 (a zero-weight row, where a
    product meets an infinite local derivative as NaN and a guard's select
    gives 0)."""
    import jax

    a = torch.tensor(GRID)
    v = tops.UNARY_REGISTRY[name](a)
    _, vjp = jax.vjp(jops.UNARY_REGISTRY[name], jnp.asarray(GRID))
    for w in (1.0, 0.0):
        got = tops.UNARY_VJP[name](a, v, torch.full_like(a, w)).numpy()
        (ref,) = vjp(jnp.full(GRID.shape, w, jnp.float32))
        ref = np.asarray(ref)
        if name in ("sinh", "cosh") and w == 1.0:
            # XLA's f32 cosh/sinh are 1.4e-6 off for |x| > ~10 (see
            # test_torch_numeric): NaN/inf where JAX has them, values
            # against float64
            np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
            with np.errstate(over="ignore", invalid="ignore"):
                ref = getattr(np, "cosh" if name == "sinh" else "sinh")(
                    GRID.astype(np.float64)).astype(np.float32)
        # tanh' = (1 + v)(1 - v) cancels as |v| -> 1: torch's and XLA's
        # tanh differ by an ulp there, which becomes up to 2.4e-7 absolute.
        # gamma' multiplies by digamma, whose root at 1.4616 costs both
        # float32 digammas relative digits nearby (psi(1.5) = 0.0364900:
        # torch 0.0364899, XLA 0.0364901), and gamma itself differs by up
        # to 2.8e-6 (test_torch_numeric): gamma'(-0.5) through the
        # reflection differs by 4.3e-6 relative, hence rtol 1e-5
        _assert_vjp_equal(got, ref, rtol=1e-5 if name == "gamma" else 1e-6,
                          atol=5e-7 if name == "tanh" else SUBNORMAL)


@pytest.mark.parametrize("name", sorted(tops.KERNEL_BINARY_IDS))
def test_binary_derivative_matches_jax_vjp(name):
    """Both partials over the grid squared: ties of max/min split 0.5/0.5,
    ^ at base 0 and at negative bases, division by 0."""
    import jax

    A, B = np.meshgrid(GRID, GRID, indexing="ij")
    a, b = torch.tensor(A), torch.tensor(B)
    v = tops.BINARY_REGISTRY[name](b, a)
    _, vjp = jax.vjp(jops.BINARY_REGISTRY[name], jnp.asarray(B), jnp.asarray(A))
    for w in (1.0, 0.0):
        db, da = tops.BINARY_VJP[name](b, a, v, torch.full_like(a, w))
        rb, ra = vjp(jnp.full(A.shape, w, jnp.float32))
        _assert_vjp_equal(db.numpy(), rb, rtol=1e-6)
        _assert_vjp_equal(da.numpy(), ra, rtol=1e-6)


def test_derivative_tables_cover_the_kernel_operators():
    """The kernels and the derivative table carry every registry operator,
    the kernel ids keep unary below binary (the kernels' switches split on
    the first binary id), and the full-only operators are those the
    header's compact switches leave out."""
    assert set(tops.UNARY_VJP) == set(tops.KERNEL_UNARY_IDS) == set(
        tops.UNARY_REGISTRY)
    assert set(tops.BINARY_VJP) == set(tops.KERNEL_BINARY_IDS) == set(
        tops.BINARY_REGISTRY)
    assert max(tops.KERNEL_UNARY_IDS.values()) < min(
        tops.KERNEL_BINARY_IDS.values())
    # the full-only operators are the ids from "asin" (unary) and "mod"
    # (binary) on, which csrc/operators.cuh compiles into the full
    # instantiation only
    ids = {**tops.KERNEL_UNARY_IDS, **tops.KERNEL_BINARY_IDS}
    first = (tops.KERNEL_UNARY_IDS["asin"], tops.KERNEL_BINARY_IDS["mod"])
    assert tops.KERNEL_FULL_ONLY == {
        n for n, i in ids.items()
        if first[0] <= i < min(tops.KERNEL_BINARY_IDS.values()) or i >= first[1]}
    assert not tke.uses_full_kernel(TOPS)
    for una, bins in ((["erf"], ["+"]), (["cos"], ["+", "mod"]),
                      ([], ["logical_and"])):
        assert tke.uses_full_kernel(tops.make_operator_set(bins, una))


# ---------------------------------------------------------------------------
# The plain loss+gradient kernel against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

BINS = ["+", "-", "*", "/"]
UNAS = ["cos", "exp", "sqrt", "log"]
JOPS = jops.make_operator_set(BINS, UNAS)
TOPS = tops.make_operator_set(BINS, UNAS)
NFEAT = 3
NROWS = 300
ZERO_ROWS = (5, 170)  # zero weight in the weighted case; the only x0 = 0


def _edge_exprs():
    p = lambda s: jtrees.parse_expression(s, JOPS)
    full = jtrees.Expr.var(0)
    while full.size() + 2 < L:
        full = jtrees.Expr.binary(JOPS.binary_index("*"), full,
                                  jtrees.Expr.const(1.01))
    full = jtrees.Expr.unary(JOPS.unary_index("cos"), full)
    return [
        p("x0 / (x1 - x1)"),                 # poisons: division by zero
        p("exp(exp(exp(x1 * 1.5)))"),         # poisons: overflow
        p("2.5"),                             # bare constant
        p("x2"),                              # bare variable
        p("0.7 + cos(x0 * 1.3)"),             # unary slot, constant sibling
        p("(0.3 * x1) - exp(-0.4 + x2)"),
        p("sqrt(1.2 * x0)"),                  # sqrt'(0) = inf at x0 = 0
        p("log(x0 * 0.5)"),                   # poisons where x0 <= 0
        full,                                 # L slots, 11 constants
    ]


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(11)
    jt = jax_trees(rng, JOPS, 23, NFEAT, exprs=_edge_exprs())
    X = (rng.standard_normal((NFEAT, NROWS)) * 1.5).astype(np.float32)
    X[0] = np.abs(X[0])
    X[0, list(ZERO_ROWS)] = 0.0
    y = rng.standard_normal(NROWS).astype(np.float32)
    w = rng.uniform(0.2, 2.0, NROWS).astype(np.float32)
    w[list(ZERO_ROWS)] = 0.0
    assert int(np.asarray(jt.length).max()) == L
    return jt, X, y, w


@pytest.fixture(scope="module")
def pallas(case):
    """The Pallas kernels in interpret mode, each (weighted, with_grad)
    variant computed once."""
    jt, X, y, w = case
    kw = dict(interpret=True, t_block=8, r_block=128, tree_unroll=1)
    memo = {}

    def get(weighted, with_grad):
        if (weighted, with_grad) not in memo:
            args = (jt, jnp.asarray(X), jnp.asarray(y),
                    jnp.asarray(w) if weighted else None, JOPS)
            out = (jpg.eval_loss_grad_pallas(*args, **kw) if with_grad
                   else jpg.eval_loss_pallas(*args, **kw))
            memo[weighted, with_grad] = [np.asarray(o) for o in out]
        return memo[weighted, with_grad]

    return get


def _assert_grad_close(got, ref, ok):
    """Poison-free trees: NaN where JAX has NaN; values at rtol 1e-4 with
    atol 1e-6 x the tree's largest finite gradient. Both sum rows in
    float32 in different orders (the Pallas kernel per 128-row tile, then
    across tiles; the plain version in torch's order), and a gradient sums
    terms of both signs, so a small component can lose digits the large
    one keeps."""
    got, ref = got[ok], ref[ok]
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    scale = np.where(np.isfinite(ref), np.abs(ref), 0.0).max(axis=1,
                                                              keepdims=True)
    m = np.isfinite(ref)
    err = np.abs(got - ref)
    tol = 1e-4 * np.abs(ref) + 1e-6 * scale
    assert np.all(err[m] <= tol[m]), np.max((err - tol)[m])


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_plain_loss_grad_matches_pallas(case, pallas, weighted):
    jt, X, y, w = case
    w = w if weighted else None
    loss_r, grad_r, ok_r = pallas(weighted, True)
    loss, grad, ok = tkg.eval_loss_grad(
        port_trees(jt), torch.tensor(X), torch.tensor(y),
        None if w is None else torch.tensor(w), TOPS)
    ok = ok.numpy()
    np.testing.assert_array_equal(ok, ok_r)
    assert 0 < ok.sum() < len(ok)
    np.testing.assert_allclose(loss.numpy()[ok], loss_r[ok], rtol=1e-5)
    _assert_grad_close(grad.numpy(), grad_r, ok)
    # non-CONST slots carry no gradient
    assert (grad.numpy()[np.asarray(jt.kind) != jtrees.CONST] == 0).all()


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_program_mirror_matches_pallas(case, pallas, weighted):
    """The plain mirror of the gradient kernel as it runs on the card
    (stack machine, adjoints on the stack, lane-ordered row sums) against
    the Pallas kernel: the tolerances of test_plain_loss_grad_matches_pallas,
    for the same reasons."""
    jt, X, y, w = case
    w = w if weighted else None
    loss_r, grad_r, ok_r = pallas(weighted, True)
    loss, grad, ok = tkg.eval_loss_grad_program_plain(
        port_trees(jt), torch.tensor(X), torch.tensor(y),
        None if w is None else torch.tensor(w), TOPS)
    ok = ok.numpy()
    np.testing.assert_array_equal(ok, ok_r)
    np.testing.assert_allclose(loss.numpy()[ok], loss_r[ok], rtol=1e-5)
    _assert_grad_close(grad.numpy(), grad_r, ok)


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_plain_loss_only_matches_pallas(case, pallas, weighted):
    jt, X, y, w = case
    w = w if weighted else None
    loss_r, ok_r = pallas(weighted, False)
    loss, ok = tkg.eval_loss(port_trees(jt), torch.tensor(X), torch.tensor(y),
                             None if w is None else torch.tensor(w), TOPS)
    np.testing.assert_array_equal(ok.numpy(), ok_r)
    np.testing.assert_allclose(loss.numpy()[ok_r], loss_r[ok_r], rtol=1e-5)


def test_zero_weight_rows_poison_and_reach_the_gradient(case, pallas):
    """x0 is 0 only on the zero-weight rows: log(x0 * 0.5) is non-finite
    there alone and is poisoned all the same; sqrt(1.2 * x0) is finite, but
    sqrt'(0) = inf meets the zero seed of those rows as NaN, which reaches
    the constant's gradient as it does through jax.grad."""
    jt, X, y, w = case
    i_log, i_sqrt = len(jt.length) - 2, len(jt.length) - 3
    _, grad, ok = tkg.eval_loss_grad(port_trees(jt), torch.tensor(X),
                                     torch.tensor(y), torch.tensor(w), TOPS)
    _, grad_r, ok_r = pallas(True, True)
    assert not ok[i_log] and not ok_r[i_log]
    assert ok[i_sqrt] and ok_r[i_sqrt]
    assert np.isnan(grad_r[i_sqrt, 0]) and torch.isnan(grad[i_sqrt, 0])


def test_unary_slot_with_constant_sibling(case):
    """0.7 + cos(x0 * 1.3): at the cos slot the stack holds the constant
    0.7 below, so the operand schedule names it as cos's left index; the
    adjoint sweep must not write there. Closed form: dL/d0.7 =
    2 mean(r), dL/d1.3 = -2 mean(r sin(1.3 x0) x0), r = f(x) - y."""
    jt, X, y, _ = case
    i = len(jt.length) - 5
    one = port_trees(jt)[i:i + 1]
    assert one.kind[0, :5].tolist() == [jtrees.CONST, jtrees.VAR,
                                        jtrees.CONST, jtrees.BIN, jtrees.UNA]
    _, grad, ok = tkg.eval_loss_grad(one, torch.tensor(X), torch.tensor(y),
                                     None, TOPS)
    x0 = X[0].astype(np.float64)
    r = 0.7 + np.cos(1.3 * x0) - y
    np.testing.assert_allclose(grad[0, 0].item(), 2 * r.mean(), rtol=1e-5)
    np.testing.assert_allclose(grad[0, 2].item(),
                               -2 * (r * np.sin(1.3 * x0) * x0).mean(), rtol=1e-4)


def test_loss_only_variant_equals_fused_scoring_loss(case):
    """Unweighted, B4's loss is the fused scoring epilogue's sum of squares
    over nrows (summed in another order: rtol 1e-6)."""
    jt, X, y, _ = case
    tt = port_trees(jt)
    loss, ok = tkg.eval_loss(tt, torch.tensor(X), torch.tensor(y), None, TOPS)
    ref = tke.eval_loss_trees(tt, torch.tensor(X), torch.tensor(y), TOPS)
    assert torch.equal(torch.isinf(ref), ~ok)
    torch.testing.assert_close(loss[ok], ref[ok], rtol=1e-6, atol=0)


def test_repeated_structure_equals_repeated_trees(case):
    """make_loss_kernel(reps=k) runs each tree's structure for k constant
    vectors: the same as the trees repeated k times (the JAX package's
    jnp.repeat for the line search)."""
    jt, X, y, w = case
    tt = port_trees(jt)
    gen = torch.Generator().manual_seed(0)
    cv = tt.cval.repeat_interleave(3, 0) * (
        1 + 0.1 * torch.randn(tt.cval.shape[0] * 3, L, generator=gen))
    rep = tt.map(lambda f: f.repeat_interleave(3, 0))._replace(cval=cv)
    Xt, yt, wt = torch.tensor(X), torch.tensor(y), torch.tensor(w)
    got = tkg.make_loss_kernel(tt, Xt, yt, wt, TOPS, reps=3)(cv.reshape(-1, 3, L))
    ref = tkg.eval_loss_grad(rep, Xt, yt, wt, TOPS)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g.reshape(r.shape), r, rtol=0, atol=0,
                                   equal_nan=True)


def test_autograd_function_matches_torch_autograd(case):
    """ConstantLoss's backward hands back the kernel's gradient; torch
    autograd through the plain forward gives the same where it is finite
    (it can turn 0 * inf of an unselected operator branch into NaN)."""
    jt, X, y, _ = case
    tt = port_trees(jt)
    Xt, yt = torch.tensor(X), torch.tensor(y)
    fn = tkg.make_loss_kernel(tt, Xt, yt, None, TOPS)
    c1 = tt.cval.clone().requires_grad_(True)
    loss = tkg.ConstantLoss.apply(c1, fn)
    _, ok = tkg.eval_loss(tt, Xt, yt, None, TOPS)
    (loss * ok).sum().backward()
    c2 = tt.cval.clone().requires_grad_(True)
    root, _, _ = tke._plain_forward(tt._replace(cval=c2), Xt, TOPS)
    ref_loss = ((root - yt) ** 2).mean(-1)
    (ref_loss * ok).sum().backward()
    torch.testing.assert_close(loss[ok], ref_loss[ok], rtol=1e-5, atol=0)
    const = (tt.kind == jtrees.CONST) & ok.unsqueeze(-1)
    fin = const & torch.isfinite(c2.grad)
    assert int(fin.sum()) >= 8
    torch.testing.assert_close(c1.grad[fin], c2.grad[fin], rtol=1e-4, atol=1e-6)


def test_search_with_the_added_operators_runs_to_its_end(monkeypatch):
    """asin, erf, gamma, mod and atan2 under default Options: scoring and
    the BFGS pass run through every one of them (the derivative table had
    no entry for asin before, and the pass stopped with a KeyError)."""
    import symbolicregression_jl_tpu_torch as sr
    from symbolicregression_jl_tpu_torch.models import constant_opt

    bfgs_trees = []

    def spy(trees, *a, **k):
        bfgs_trees.append(trees)
        return tkg.make_loss_kernel(trees, *a, **k)

    monkeypatch.setattr(constant_opt, "make_loss_kernel", spy)
    rng = np.random.default_rng(0)
    X = rng.uniform(-1.5, 1.5, (2, 64)).astype(np.float32)
    y = np.arcsin(X[0] * 0.5) + 0.3
    res = sr.equation_search(
        X, y, device="cpu", binary_operators=["+", "*", "mod", "atan2"],
        unary_operators=["asin", "erf", "gamma"], npopulations=2, npop=24,
        ncycles_per_iteration=12, maxsize=12, niterations=2, seed=0,
        verbosity=0)
    assert res.options.should_optimize_constants
    assert res.frontier() and np.isfinite(res.best_loss().loss)
    # every unary operator here is an added one, and so are binary 2 and 3
    added = [bool(((t.kind == jtrees.UNA) | ((t.kind == jtrees.BIN)
                                             & (t.op >= 2))).any())
             for t in bfgs_trees]
    assert any(added), [t.kind.unique() for t in bfgs_trees]
