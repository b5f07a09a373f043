"""PyTorch port vs the JAX package: the gradient kernel (B3) as it runs on
the card, through its plain mirror ``eval_loss_grad_program_plain`` (the
stack machine's forward sweep, the adjoint sweep with the left operands'
adjoints on the stack, the kernel's lane-ordered row sums). The mirror is
held against the slot-indexed plain version ``_plain_loss_grad`` and the
JAX package's jnp reference (``eval_grad_constants``, forward-mode
derivatives of the jnp interpreter) on programs of every length 1..L at
max_len 24 and 128, with poisoning trees, zero-weight rows, invalid
programs and a unary slot whose left sibling is a constant, and on deep
programs at max_len 512 and 1,024; then a CPU search at maxsize 110 runs
its default BFGS to its end. The mirror against
the Pallas kernel in interpret mode is in ``test_torch_grad.py``, which
computes that kernel's outputs once."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu.models.trees as jtrees
from symbolicregression_jl_tpu.ops import interpreter as jinterp
from symbolicregression_jl_tpu.ops import operators as jops
from symbolicregression_jl_tpu.utils.random_exprs import random_expr_fixed_size
from symbolicregression_jl_tpu_torch.models.trees import BIN, CONST, VAR, TreeBatch
from symbolicregression_jl_tpu_torch.ops import kernel_eval as tke
from symbolicregression_jl_tpu_torch.ops import kernel_grad as tkg
from symbolicregression_jl_tpu_torch.ops import operators as tops

from torch_port_helpers import deep_trees, port_trees

BINS = ["+", "-", "*", "/"]
UNAS = ["cos", "exp", "sqrt", "log"]
JOPS = jops.make_operator_set(BINS, UNAS)
TOPS = tops.make_operator_set(BINS, UNAS)
NFEAT = 3
NROWS = 100
ZERO_ROWS = (3, 40, 77)


def _batch(max_len: int, seed: int, per_length: int):
    """``per_length`` random programs of every length 1..max_len - 1 (a
    unary operator may overshoot a length by one), the poisoning trees and
    a program of exactly max_len slots, as a JAX TreeBatch; X, y and
    weights with zero-weight rows."""
    rng = np.random.default_rng(seed)
    p = lambda s: jtrees.parse_expression(s, JOPS)
    exprs = [random_expr_fixed_size(rng, JOPS, NFEAT, n)
             for n in range(1, max_len) for _ in range(per_length)]
    exprs = [e for e in exprs if e.size() <= max_len]
    full = jtrees.Expr.var(0)
    while full.size() + 2 < max_len:
        full = jtrees.Expr.binary(JOPS.binary_index("*"), full,
                                  jtrees.Expr.const(1.001))
    full = jtrees.Expr.unary(JOPS.unary_index("cos"), full)
    exprs += [p("x0 / (x1 - x1)"), p("exp(exp(exp(x1 * 1.5)))"),
              p("0.7 + cos(x0 * 1.3)"), full]
    jt = jtrees.stack_trees([jtrees.encode_tree(e, max_len) for e in exprs])
    X = (rng.standard_normal((NFEAT, NROWS)) * 1.5).astype(np.float32)
    y = rng.standard_normal(NROWS).astype(np.float32)
    w = rng.uniform(0.2, 2.0, NROWS).astype(np.float32)
    w[list(ZERO_ROWS)] = 0.0
    lengths = set(np.asarray(jt.length).tolist())
    assert set(range(1, max_len + 1)) <= lengths
    return jt, X, y, w


@pytest.fixture(scope="module", params=[24, 128], ids=["L24", "L128"])
def case(request):
    return _batch(request.param, seed=request.param,
                  per_length=2 if request.param == 24 else 1)


@pytest.fixture(scope="module")
def jnp_values(case):
    """The jnp interpreter's values, ok and forward-mode derivatives with
    respect to every constant slot, computed once per batch."""
    jt, X = case[:2]
    return [np.asarray(a) for a in jinterp.eval_grad_constants(
        jt, jnp.asarray(X), JOPS)]


def _jnp_reference(jt, y, w, values):
    """Loss and d loss / d constants from the jnp interpreter's values and
    forward-mode derivatives, summed over rows in float64."""
    yp, ok, dy = values
    wn = (np.full(NROWS, 1.0 / NROWS) if w is None
          else w.astype(np.float64) / w.astype(np.float64).sum())
    r = yp.astype(np.float64) - y
    with np.errstate(invalid="ignore", over="ignore"):
        loss = (np.where(wn > 0, r * r, 0.0) * wn).sum(-1)
        grad = (dy * (2.0 * r * wn)[:, None, :]).sum(-1)
    const = np.asarray(jt.kind) == jtrees.CONST
    return loss, np.where(const, grad, 0.0), ok


def _mirror(jt, X, y, w):
    return tkg.eval_loss_grad_program_plain(
        port_trees(jt), torch.tensor(X), torch.tensor(y),
        None if w is None else torch.tensor(w), TOPS)


def _assert_grad_close(got, ref, scale):
    """NaN where the reference has NaN; elsewhere within rtol 1e-4 plus
    1e-5 of ``scale``, the sum over rows of the terms' magnitudes: both sum
    the rows in float32 in different orders, and terms of both signs
    cancel, so a small gradient keeps only the digits of the large terms."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    fin = np.isfinite(ref) & np.isfinite(scale)
    tol = 1e-4 * np.abs(ref) + 1e-5 * scale
    assert np.all(np.abs(got - ref)[fin] <= tol[fin]), \
        np.max((np.abs(got - ref) - tol)[fin])


def test_adjoint_words_name_left_operands_and_constant_ranks(case):
    """The gradient kernel's words: a binary slot's left operand is the
    operand schedule's left index, exactly (the JAX package's stack
    simulation, held equal to the port's in test_torch_structure); a
    CONST slot's is its rank among the CONST slots; the opcode and stack
    entry bits and every other word are those of program_words."""
    jt = case[0]
    tt = port_trees(jt)
    words, invalid = tke.program_words(tt, TOPS, NFEAT)
    assert not invalid.any()
    got = tkg.adjoint_words(words, tt.length)
    L = tt.kind.shape[1]
    live = torch.arange(L) < tt.length.unsqueeze(-1)
    binary = (tt.kind == BIN) & live
    const = (tt.kind == CONST) & live
    lidx, _ = tke.operand_schedule(tt.kind, tt.length)
    assert int(binary.sum()) > L and int(const.sum()) > L
    assert torch.equal(got[binary] >> 32, lidx[binary])
    assert torch.equal(got[const] >> 32, (torch.cumsum(const.long(), -1) - 1)[const])
    assert torch.equal(got & 0xFFFFFFFF, words & 0xFFFFFFFF)
    assert torch.equal(got[~binary & ~const], words[~binary & ~const])


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_program_mirror_matches_the_slot_plain_version(case, weighted):
    """Each row's adjoints take the same operations in both, so only the
    order of the row sums differs: ok equal, losses at rtol 1e-5, the
    gradients as _assert_grad_close says."""
    jt, X, y, w = case
    w = w if weighted else None
    tt = port_trees(jt)
    args = (torch.tensor(X), torch.tensor(y),
            None if w is None else torch.tensor(w), TOPS)
    loss, grad, ok = tkg.eval_loss_grad_program_plain(tt, *args)
    loss_p, grad_p, ok_p, scale = tkg.eval_loss_grad_plain(tt, *args,
                                                           scale=True)
    assert torch.equal(ok, ok_p)
    assert 0 < int(ok.sum()) < len(ok)
    torch.testing.assert_close(loss[ok], loss_p[ok], rtol=1e-5, atol=0)
    _assert_grad_close(grad[ok].numpy(), grad_p[ok].numpy(),
                       scale[ok].numpy())
    assert not grad[tt.kind != CONST].any()


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_program_mirror_matches_the_jnp_reference(case, jnp_values, weighted):
    """Against the JAX package's jnp interpreter: ok equal; losses at rtol
    1e-5 (float64 sums against float32); gradients within rtol 1e-4 plus
    1e-5 of the terms' magnitudes (forward- against reverse-mode rounding
    and float32 sums), on the trees the reference finds finite."""
    jt, X, y, w = case
    w = w if weighted else None
    loss, grad, ok = _mirror(jt, X, y, w)
    loss_r, grad_r, ok_r = _jnp_reference(jt, y, w, jnp_values)
    ok = ok.numpy()
    np.testing.assert_array_equal(ok, ok_r)
    np.testing.assert_allclose(loss.numpy()[ok], loss_r[ok], rtol=1e-5)
    _, _, _, scale = tkg.eval_loss_grad_plain(
        port_trees(jt), torch.tensor(X), torch.tensor(y),
        None if w is None else torch.tensor(w), TOPS, scale=True)
    fin = np.isfinite(grad_r[ok]).all(-1)
    assert fin.sum() > 0.9 * ok.sum()
    _assert_grad_close(grad.numpy()[ok][fin], grad_r[ok][fin],
                       scale.numpy()[ok][fin])


@pytest.mark.parametrize("max_len", [512, 1024])
def test_long_programs_adjoint_words_and_mirror(max_len):
    """max_len 512 and 1,024 (stacks past 255 entries at 1,024): the
    adjoint words name each binary slot's left operand exactly, and the
    mirror matches the slot-indexed plain version (ok equal, losses at
    rtol 1e-5, gradients as _assert_grad_close says) on deep sums, a sum
    with a cos after every +/-, a chain of max_len - 1 cos, random programs
    of 40-60 slots and the poisoning trees; zero-weight rows. (The jnp
    reference's forward-mode derivatives, one per constant slot, take
    minutes at this max_len; the mirror is held against it at 24 and 128
    above.)"""
    rng = np.random.default_rng(max_len)
    p = lambda e: jtrees.parse_expression(e, JOPS)
    exprs = [random_expr_fixed_size(rng, JOPS, NFEAT, int(n))
             for n in rng.integers(40, 61, 4)]
    exprs += [p("x0 / (x1 - x1)"), p("0.7 + cos(x0 * 1.3)")]
    jt = jtrees.stack_trees([jtrees.encode_tree(e, max_len) for e in exprs])
    tt = TreeBatch(*(torch.cat(z) for z in zip(deep_trees(max_len, NFEAT),
                                               port_trees(jt))))
    X = (rng.standard_normal((NFEAT, 40)) * 1.5).astype(np.float32)
    y = rng.standard_normal(40).astype(np.float32)
    w = rng.uniform(0.2, 2.0, 40).astype(np.float32)
    w[[3, 17]] = 0.0
    words, invalid = tke.program_words(tt, TOPS, NFEAT)
    assert not invalid.any()
    got = tkg.adjoint_words(words, tt.length)
    live = torch.arange(max_len) < tt.length.unsqueeze(-1)
    binary = (tt.kind == BIN) & live
    lidx, _ = tke.operand_schedule(tt.kind, tt.length)
    assert torch.equal(got[binary] >> 32, lidx[binary])
    assert int(tke.word_fields(words)[1].max()) >= (
        256 if max_len > 512 else 200)
    args = (torch.tensor(X), torch.tensor(y), torch.tensor(w), TOPS)
    loss, grad, ok = tkg.eval_loss_grad_program_plain(tt, *args)
    loss_p, grad_p, ok_p, scale = tkg.eval_loss_grad_plain(tt, *args,
                                                           scale=True)
    assert torch.equal(ok, ok_p) and 0 < int(ok.sum()) < len(ok)
    torch.testing.assert_close(loss[ok], loss_p[ok], rtol=1e-5, atol=0)
    _assert_grad_close(grad[ok].numpy(), grad_p[ok].numpy(),
                       scale[ok].numpy())


def test_program_mirror_sums_rows_as_the_kernel():
    """lane_sum is the kernels' order: lane l adds rows l, l + 32, ... in
    order, then lanes l and l ^ 16, ^ 8, ^ 4, ^ 2, ^ 1 are added; lane 0's
    bits, checked against the same sums written out in numpy float32 on a
    ragged row count."""
    rng = np.random.default_rng(0)
    terms = (rng.standard_normal((5, 77)) * 10.0 ** rng.integers(
        -6, 6, (5, 77))).astype(np.float32)
    lanes = np.zeros((5, 32), np.float32)
    for r in range(77):
        lanes[:, r % 32] += terms[:, r]
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, np.arange(32) ^ off]
    got = tke.lane_sum(torch.tensor(terms)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), lanes[:, 0].view(np.int32))


def test_program_mirror_poisons_invalid_programs_with_zero_gradient():
    """A program that is not valid postfix (underflow, unfinished, a
    length beyond L, an operator outside the set, a feature out of range)
    is poisoned, its loss and gradient 0, as the kernel reports it; the
    valid program beside them is not."""
    L = 8
    rows = [([VAR, BIN], 2), ([VAR, VAR], 2), ([VAR], 9),
            ([VAR, VAR, BIN], 3), ([VAR], 1), ([CONST, VAR, BIN], 3)]
    kind = torch.tensor([r + [0] * (L - len(r)) for r, _ in rows])
    op, feat = torch.zeros_like(kind), torch.zeros_like(kind)
    op[3, 2] = TOPS.n_binary
    feat[4, 0] = NFEAT
    trees = TreeBatch(kind, op, feat, torch.full(kind.shape, 0.5),
                      torch.tensor([n for _, n in rows]))
    X = torch.randn(NFEAT, 40)
    y = torch.randn(40)
    loss, grad, ok = tkg.eval_loss_grad_program_plain(trees, X, y, None, TOPS)
    assert ok.tolist() == [False] * 5 + [True]
    assert not loss[:5].any() and not grad[:5].any()
    assert grad[5, 0] != 0 and not grad[5, 1:].any()


def test_program_mirror_unary_slot_with_constant_sibling():
    """0.7 + cos(x0 * 1.3): at the cos slot the stack holds the constant
    0.7 below it, which the adjoint sweep must leave alone. Closed form:
    dL/d0.7 = 2 mean(r), dL/d1.3 = -2 mean(r sin(1.3 x0) x0), r = f(x) -
    y, at rtol 1e-5 / 1e-4 (float32 sums of 100 rows)."""
    jt, X, y, _ = _batch(24, seed=24, per_length=1)
    i = len(jt.length) - 2
    one = jtrees.TreeBatch(*(np.asarray(f)[i:i + 1] for f in jt))
    assert np.asarray(one.kind)[0, :5].tolist() == [
        jtrees.CONST, jtrees.VAR, jtrees.CONST, jtrees.BIN, jtrees.UNA]
    _, grad, ok = _mirror(one, X, y, None)
    assert bool(ok[0])
    x0 = X[0].astype(np.float64)
    r = 0.7 + np.cos(1.3 * x0) - y
    np.testing.assert_allclose(grad[0, 0].item(), 2 * r.mean(), rtol=1e-5)
    np.testing.assert_allclose(grad[0, 2].item(),
                               -2 * (r * np.sin(1.3 * x0) * x0).mean(),
                               rtol=1e-4)


def test_equation_search_at_maxsize_110_runs_its_bfgs_on_cpu(monkeypatch):
    """maxsize 110 gives max_len 112, which the gradient kernel of earlier
    versions refused; with the default BFGS the search runs to its end and
    every optimisation pass reaches the gradient variant (on the CPU its
    plain version) at that max_len."""
    import symbolicregression_jl_tpu_torch as sr
    from symbolicregression_jl_tpu_torch.models import constant_opt

    widths = []

    def spy(trees, *a, **k):
        widths.append(trees.kind.shape[-1])
        return tkg.make_loss_kernel(trees, *a, **k)

    monkeypatch.setattr(constant_opt, "make_loss_kernel", spy)
    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, (2, 64)).astype(np.float32)
    y = (1.7 * X[0] * X[1] + np.cos(X[1])).astype(np.float32)
    res = sr.equation_search(
        X, y, device="cpu", binary_operators=["+", "*"],
        unary_operators=["cos"], npopulations=2, npop=16,
        ncycles_per_iteration=6, maxsize=110, niterations=2, seed=0,
        verbosity=0)
    assert res.options.should_optimize_constants
    assert res.frontier() and np.isfinite(res.best_loss().loss)
    assert widths and set(widths) == {112}
