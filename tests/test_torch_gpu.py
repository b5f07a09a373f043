"""The PyTorch port on a CUDA card: the scoring kernel in every mode, the
constant-gradient kernel in both variants and the instruction-program
kernels against their plain versions (the latter also bit-equal to the
scoring kernel's value mode), each registry operator (and its derivative,
and the hand-written digamma) on the edge grid, and short searches; every
float64 build and the gradient kernel's cotangent-seeded mode, the
constant-fold kernel (``simplify_tree``) at every build, with a user
operator and at max_len 512, 1,024 and 2,048, eval_tree's
batching rule (one B1 launch), per-island minibatches in the captured
cycle and a custom objective's search; the
redesigned scoring kernel below and above one wave of blocks, with ragged
row counts, wide X and long or invalid programs, the loss-only kernel's
candidate groups, and two launches giving the same bits; every kernel at
max_len 512, 1,024 and 2,048 (the narrow routes, with their stacks, slot
values or results in shared or global memory), B5 / B6 at their longest
and the instruction-program scoring call without a host wait; the cycle
captured as a CUDA graph, bit-equal to the eager loop with the same launch
counts, reused by a second search and by a second output, and raising
when it cannot be captured; the mask policy's weighted route and
``to_callable`` on B1; the threefry draw plans in the plan kernel's
float32 and float64 instantiations. Marked ``gpu``;
each skips without a card (decided in a fixture, so every test worker
collects the same tests).

This file imports neither JAX nor the JAX package (nor does the part of
``torch_port_helpers`` it uses), because the machine with the card has no
JAX; ``tests/conftest.py`` imports JAX, so run it there without the
conftest:

    python -m pytest tests/test_torch_gpu.py -m gpu -q --noconftest
"""

import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu_torch as sr
from symbolicregression_jl_tpu_torch.models import cycle_graph as cg
from symbolicregression_jl_tpu_torch.models import evolve as tevolve
from symbolicregression_jl_tpu_torch.models import mutate_device as tmut
from symbolicregression_jl_tpu_torch.models.trees import (
    BIN, CONST, UNA, VAR, TreeBatch, encode_tree, parse_expression, stack_trees,
)
from symbolicregression_jl_tpu_torch.ops import kernel_eval as tke
from symbolicregression_jl_tpu_torch.ops import kernel_grad as tkg
from symbolicregression_jl_tpu_torch.ops import kernel_instr as tki
from symbolicregression_jl_tpu_torch.ops import losses as tlosses
from symbolicregression_jl_tpu_torch.ops import kernel_rng as tkr
from symbolicregression_jl_tpu_torch.ops import operators as tops
from torch_port_helpers import island_keys, make_generator, random_trees

from torch_port_helpers import deep_trees

L = 24
# the operator grid of test_torch_numeric.py: guard edges, then a sweep
GRID = np.array(
    [0.0, -0.0, 1e-30, -1e-30, 1e-7, 0.5, -0.5, 1.0, -1.0, 2.0, -2.5, 3.0,
     -3.7, 10.0, -10.0, 88.0, 89.5, -89.5, 100.0, -100.0, 1e6, -1e6, 3e38,
     -3e38, np.inf, -np.inf, np.nan] + list(np.linspace(-7, 7, 29)),
    np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernel_matches_plain_on_card(cuda):
    torch.manual_seed(0)
    ops = tops.make_operator_set(["+", "-", "*", "/"], ["cos", "exp", "sqrt", "log"])
    gen = make_generator(0, cuda)
    trees = random_trees(
        gen, torch.randint(1, 24, (700,), device=cuda), 3, ops, L, cuda)
    X = torch.randn(3, 333, device=cuda) * 2
    y = torch.randn(333, device=cuda)
    before = sum(tke.LAUNCHES.values())
    yk, okk = tke.eval_trees(trees, X, ops)
    yp, okp = tke.eval_trees_plain(trees, X, ops)
    assert torch.equal(okk, okp) and 0 < int(okk.sum()) < 700
    torch.testing.assert_close(yk[okk], yp[okk], rtol=1e-5, atol=1e-6)
    lk = tke.eval_loss_trees(trees, X, y, ops)
    lp = tke.eval_loss_trees_plain(trees, X, y, ops)
    assert torch.equal(torch.isinf(lk), torch.isinf(lp))
    fin = torch.isfinite(lp)
    torch.testing.assert_close(lk[fin], lp[fin], rtol=1e-4, atol=0)
    sk, _ = tke.eval_slot_values(trees, X[:, :1], ops)
    sp, _ = tke.eval_slot_values_plain(trees, X[:, :1], ops)
    f = torch.isfinite(sp)
    assert torch.equal(torch.isfinite(sk), f)
    torch.testing.assert_close(sk[f], sp[f], rtol=1e-5, atol=1e-6)
    assert sum(tke.LAUNCHES.values()) == before + 3


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted({**tops.KERNEL_UNARY_IDS,
                                         **tops.KERNEL_BINARY_IDS}))
def test_kernel_operator_grid_on_card(cuda, name):
    """Each operator the kernel carries, as a one-node program over the
    edge grid, against the plain version on the card."""
    unary = name in tops.KERNEL_UNARY_IDS
    ops = (tops.make_operator_set([], [name]) if unary
           else tops.make_operator_set([name], []))
    a, b = np.meshgrid(GRID, GRID, indexing="ij")
    X = torch.tensor(np.stack([a.ravel(), b.ravel()]), device=cuda)
    kind = [VAR, UNA] if unary else [VAR, VAR, BIN]
    n = len(kind)
    t = TreeBatch(
        torch.tensor([kind + [0] * (L - n)], device=cuda),
        torch.zeros((1, L), dtype=torch.int64, device=cuda),
        torch.tensor([[0, 1] + [0] * (L - 2)], device=cuda),
        torch.zeros((1, L), device=cuda),
        torch.tensor([n], device=cuda))
    yk, _ = tke.eval_trees(t, X, ops)
    yp, _ = tke.eval_trees_plain(t, X, ops)
    assert torch.equal(torch.isnan(yk), torch.isnan(yp))
    m = ~torch.isnan(yp)
    torch.testing.assert_close(yk[m], yp[m], rtol=1e-6, atol=1e-7)


@pytest.mark.gpu
def test_equation_search_on_card(cuda):
    rng = np.random.default_rng(0)
    X = rng.integers(-3, 4, size=(5, 100)).astype(np.float32)
    y = X[0] * X[0] - X[1] * X[2]
    before = tke.LAUNCHES["fused"]
    res = sr.equation_search(
        X, y, binary_operators=["+", "-", "*"], should_optimize_constants=False,
        npopulations=16, npop=100, tournament_selection_n=6,
        ncycles_per_iteration=40, maxsize=12, niterations=2, seed=0,
        verbosity=0)
    assert tke.LAUNCHES["fused"] - before >= 2 * 40
    assert res.frontier() and np.isfinite(res.best_loss().loss)


def _assert_grad_outputs_close(got, ref, scale=None):
    """ok equal; loss at rtol 1e-5 where ok and finite. CONST-slot
    gradients against ``scale``, the sum over rows of the terms'
    magnitudes: where a term is NaN both are NaN; where ``scale`` is
    finite no partial sum overflows in any order, so both are finite and
    agree within rtol 1e-4 plus 1e-5 of ``scale`` (rows summed in
    different orders; terms of both signs cancel); where ``scale``
    overflowed the result depends on the order of the sum."""
    (lk, gk, okk), (lp, gp, okp) = got, ref
    assert torch.equal(okk, okp)
    fin = okp & torch.isfinite(lp)
    assert torch.equal(torch.isfinite(lk[okp]), fin[okp])
    torch.testing.assert_close(lk[fin], lp[fin], rtol=1e-5, atol=0)
    if gp is None:
        return
    gk, gp, scale = gk[okp], gp[okp], scale[okp]
    nan_term = torch.isnan(scale)
    assert bool(torch.isnan(gk[nan_term]).all())
    m = torch.isfinite(scale)
    assert bool(torch.isfinite(gk[m]).all())
    tol = 1e-4 * gp.abs() + 1e-5 * scale
    assert bool(((gk - gp).abs() <= tol)[m].all())


@pytest.mark.gpu
@pytest.mark.parametrize("weighted", [False, True])
def test_grad_kernel_matches_plain_on_card(cuda, weighted):
    """Both variants, poisoning trees and zero-weight rows included, and
    the line search's repeated structure (reps = 8)."""
    ops = tops.make_operator_set(["+", "-", "*", "/"], ["cos", "exp", "sqrt", "log"])
    gen = make_generator(1, cuda)
    trees = random_trees(
        gen, torch.randint(1, 24, (500,), device=cuda), 3, ops, L, cuda)
    edge = stack_trees([encode_tree(parse_expression(e, ops), L, device=cuda)
                        for e in ("x0 / (x1 - x1)", "exp(exp(exp(x1 * 1.5)))",
                                  "2.5", "0.7 + cos(x0 * 1.3)", "sqrt(1.2 * x0)")])
    trees = TreeBatch(*(torch.cat([a, b]) for a, b in zip(trees, edge)))
    X = torch.randn(3, 333, device=cuda) * 2
    X[0] = X[0].abs()
    X[0, :4] = 0.0
    y = torch.randn(333, device=cuda)
    w = None
    if weighted:
        w = torch.rand(333, device=cuda) + 0.5
        w[:4] = 0.0
    before = dict(tkg.LAUNCHES)
    got = tkg.eval_loss_grad(trees, X, y, w, ops)
    *ref, scale = tkg.eval_loss_grad_plain(trees, X, y, w, ops, scale=True)
    assert 0 < int(got[2].sum()) < 505
    _assert_grad_outputs_close(got, ref, scale)
    lk, okk = tkg.eval_loss(trees, X, y, w, ops)
    lp, okp = tkg.eval_loss_plain(trees, X, y, w, ops)
    _assert_grad_outputs_close((lk, None, okk), (lp, None, okp))
    cv = trees.cval.repeat_interleave(8, 0) * (
        1 + 0.1 * torch.randn(505 * 8, L, device=cuda))
    rep = trees.map(lambda f: f.repeat_interleave(8, 0))._replace(cval=cv)
    *ref, scale = tkg.eval_loss_grad_plain(rep, X, y, w, ops, scale=True)
    for with_grad in (True, False):
        fn = tkg.make_loss_kernel(trees, X, y, w, ops, with_grad, reps=8)
        got = fn(cv.reshape(505, 8, L))
        got = tuple(None if g is None else g.reshape((505 * 8,) + g.shape[2:])
                    for g in got)
        _assert_grad_outputs_close(
            got, ref if with_grad else (ref[0], None, ref[2]), scale)
    assert tkg.LAUNCHES["loss_grad"] == before["loss_grad"] + 2
    assert tkg.LAUNCHES["loss"] == before["loss"] + 2


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted({**tops.KERNEL_UNARY_IDS,
                                         **tops.KERNEL_BINARY_IDS}))
def test_grad_kernel_operator_grid_on_card(cuda, name):
    """Each operator over constant operands from the edge grid (one
    instance per grid point, one row): the loss-gradient kernel's
    derivative against the plain version's derivative table."""
    unary = name in tops.KERNEL_UNARY_IDS
    ops = (tops.make_operator_set([], [name]) if unary
           else tops.make_operator_set([name], []))
    if unary:
        cv = torch.tensor(GRID)[:, None]
        kind = [CONST, UNA]
    else:
        a, b = np.meshgrid(GRID, GRID, indexing="ij")
        cv = torch.tensor(np.stack([b.ravel(), a.ravel()], -1))
        kind = [CONST, CONST, BIN]
    n, T = len(kind), cv.shape[0]
    cval = torch.zeros((T, L))
    cval[:, : cv.shape[1]] = cv
    t = TreeBatch(torch.tensor([kind + [0] * (L - n)] * T),
                  torch.zeros((T, L), dtype=torch.int64),
                  torch.zeros((T, L), dtype=torch.int64), cval,
                  torch.full((T,), n))
    X, y = torch.zeros((1, 1)), torch.full((1,), 0.25)
    lp, gp, okp = tkg.eval_loss_grad_plain(t, X, y, None, ops)
    lk, gk, okk = tkg.eval_loss_grad(t.map(lambda f: f.to(cuda)), X.to(cuda),
                                     y.to(cuda), None, ops)
    lk, gk, okk = lk.cpu(), gk.cpu(), okk.cpu()
    assert torch.equal(okk, okp)
    for got, ref in ((lk, lp), (gk, gp)):
        assert torch.equal(torch.isnan(got), torch.isnan(ref))
        m = ~torch.isnan(ref)
        torch.testing.assert_close(got[m], ref[m], rtol=1e-5, atol=1e-30)


@pytest.mark.gpu
def test_equation_search_with_constant_optimisation_on_card(cuda):
    """Default constant optimisation: per iteration one BFGS pass of 9
    gradient and 8 line-search launches."""
    rng = np.random.default_rng(0)
    X = rng.uniform(-3, 3, (2, 200)).astype(np.float32)
    y = 2.5 * np.cos(X[0]) + 0.7
    before = dict(tkg.LAUNCHES)
    res = sr.equation_search(
        X, y, binary_operators=["+", "*"], unary_operators=["cos"],
        npopulations=8, npop=60, ncycles_per_iteration=30, maxsize=10,
        niterations=3, seed=0, verbosity=0)
    assert tkg.LAUNCHES["loss_grad"] - before["loss_grad"] == 9 * 3
    assert tkg.LAUNCHES["loss"] - before["loss"] == 8 * 3
    assert res.best_loss().loss < 1e-2


def _all_operators():
    return tops.make_operator_set(
        sorted(set(tops.BINARY_REGISTRY) - {"pow"}), sorted(tops.UNARY_REGISTRY))


def _assert_bits_equal(got, ref):
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True], ids=["instr", "instr_packed"])
@pytest.mark.parametrize("operators", ["main", "all"])
def test_instr_kernel_matches_plain_and_value_mode_on_card(cuda, packed,
                                                           operators):
    """B5 / B6 on random trees (over the north star's operators, or over
    all 44 registry operators), bare leaves and poisoning trees included:
    ok equal to the postfix value mode's and values bit-equal to it, and
    against the plain version at rtol 1e-5 / atol 1e-6."""
    ops = (tops.make_operator_set(["+", "-", "*", "/"], ["cos", "exp"])
           if operators == "main" else _all_operators())
    gen = make_generator(2, cuda)
    trees = random_trees(
        gen, torch.randint(1, 24, (900,), device=cuda, generator=gen), 3, ops,
        L, cuda)
    X = torch.randn(3, 333, device=cuda, generator=gen) * 1.5
    name = "instr_packed" if packed else "instr"
    before = tki.LAUNCHES[name]
    yk, okk = tki.eval_trees_instr(trees, X, ops, packed)
    assert tki.LAUNCHES[name] == before + 1
    yv, okv = tke.eval_trees(trees, X, ops)
    assert torch.equal(okk, okv) and 0 < int(okk.sum()) < 900
    _assert_bits_equal(yk[okk], yv[okk])
    yp, okp = tki.eval_trees_instr_plain(trees, X, ops, packed)
    assert torch.equal(okk, okp)
    torch.testing.assert_close(yk[okk], yp[okk], rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted({**tops.KERNEL_UNARY_IDS,
                                         **tops.KERNEL_BINARY_IDS}))
def test_instr_kernel_operator_grid_on_card(cuda, name):
    """Each operator as a one-instruction program over the edge grid
    through B5 and B6: bit-equal to the postfix kernel's value mode."""
    unary = name in tops.KERNEL_UNARY_IDS
    ops = (tops.make_operator_set([], [name]) if unary
           else tops.make_operator_set([name], []))
    a, b = np.meshgrid(GRID, GRID, indexing="ij")
    X = torch.tensor(np.stack([a.ravel(), b.ravel()]), device=cuda)
    kind = [VAR, UNA] if unary else [VAR, VAR, BIN]
    n = len(kind)
    t = TreeBatch(
        torch.tensor([kind + [0] * (L - n)], device=cuda),
        torch.zeros((1, L), dtype=torch.int64, device=cuda),
        torch.tensor([[0, 1] + [0] * (L - 2)], device=cuda),
        torch.zeros((1, L), device=cuda),
        torch.tensor([n], device=cuda))
    yv, okv = tke.eval_trees(t, X, ops)
    for packed in (False, True):
        yk, okk = tki.eval_trees_instr(t, X, ops, packed)
        assert torch.equal(okk, okv)
        _assert_bits_equal(yk, yv)


@pytest.mark.gpu
def test_digamma_matches_torch_on_card(cuda):
    """The kernels' digamma (CUDA's math library has none; gamma's
    derivative reads it) against torch.digamma: the same NaN and inf
    positions; values at rtol 1e-5 with atol 2e-6, because near a root
    (1.4616, and one in each negative unit interval) a float32 digamma
    keeps absolute, not relative, digits: torch's subtracts up to ten terms
    below 3, half an ulp (1.2e-7) each."""
    x = torch.tensor(np.concatenate([
        GRID, np.linspace(-9.75, 40, 4000), [1.4616321, 1.4616322]]).astype(
            np.float32), device=cuda)
    got, ref = tkg.digamma_on_card(x), torch.digamma(x)
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    assert torch.equal(torch.isinf(got), torch.isinf(ref))
    m = torch.isfinite(ref)
    torch.testing.assert_close(got[m], ref[m], rtol=1e-5, atol=2e-6)


@pytest.mark.gpu
def test_instr_searches_on_card(cuda):
    """kernel_program="instr" and "instr_packed" with the same seed: the
    same hall of fame, every scoring call through B5 / B6 (1 at init, 1
    per cycle, 1 rescore per iteration)."""
    rng = np.random.default_rng(0)
    X = rng.uniform(-3, 3, (2, 200)).astype(np.float32)
    y = 2.5 * np.cos(X[0]) + 0.7
    fronts = {}
    for program in ("instr", "instr_packed"):
        before = tki.LAUNCHES[program]
        res = sr.equation_search(
            X, y, binary_operators=["+", "*"], unary_operators=["cos"],
            npopulations=8, npop=60, ncycles_per_iteration=30, maxsize=10,
            niterations=2, seed=0, verbosity=0, kernel_program=program)
        assert tki.LAUNCHES[program] - before == 1 + 2 * 30 + 2
        fronts[program] = [(c.complexity, c.loss, c.equation)
                           for c in res.frontier()]
    assert fronts["instr"] == fronts["instr_packed"] and fronts["instr"]


@pytest.mark.gpu
def test_compact_and_full_instantiations_agree_on_card(cuda, monkeypatch):
    """On operators of the common set the wrappers launch each kernel's
    compact instantiation; the full one (forced) gives the same bits."""
    ops = tops.make_operator_set(["+", "-", "*", "/"], ["cos", "exp", "sqrt"])
    assert not tke.uses_full_kernel(ops)
    assert tke.uses_full_kernel(tops.make_operator_set(["+", "mod"], []))
    gen = make_generator(4, cuda)
    trees = random_trees(
        gen, torch.randint(1, 24, (600,), device=cuda, generator=gen), 2, ops,
        L, cuda)
    X = torch.randn(2, 333, device=cuda, generator=gen) * 1.5
    y = torch.randn(333, device=cuda, generator=gen)

    def run_all():
        return [tke.eval_trees(trees, X, ops)[0],
                tke.eval_loss_trees(trees, X, y, ops),
                *tkg.eval_loss_grad(trees, X, y, None, ops)[:2],
                tki.eval_trees_instr(trees, X, ops, False)[0],
                tki.eval_trees_instr(trees, X, ops, True)[0]]

    compact = run_all()
    monkeypatch.setattr(tke, "uses_full_kernel", lambda operators: True)
    for got, ref in zip(run_all(), compact):
        _assert_bits_equal(got.nan_to_num(), ref.nan_to_num())


def _length_sweep(ops, nfeat, max_len, per_length, device, seed=0):
    """per_length random valid programs of every length 1..max_len."""
    from symbolicregression_jl_tpu_torch.tools.kernel_breakdown import (
        fixed_length_trees,
    )

    rng = np.random.default_rng(seed)
    parts = [fixed_length_trees(rng, per_length, n, nfeat, ops, max_len, device)
             for n in range(1, max_len + 1)]
    return TreeBatch(*(torch.cat(z) for z in zip(*parts)))


@pytest.mark.gpu
@pytest.mark.parametrize("T, nrows", [(37, 333), (3000, 2048), (30000, 2049),
                                      (5376, 100)],
                         ids=["below-one-wave", "cycle-like", "above-waves-ragged",
                              "short-rows"])
def test_scoring_kernel_work_items_on_card(cuda, T, nrows):
    """The redesigned scoring kernel below and above one wave of blocks,
    with row counts that are not a multiple of a pass (32 lanes x 4 rows):
    value and slot modes bit-equal to the plain versions, the fused loss
    within rtol 1e-4 of the plain version (rows summed in another order)
    and the same bits on a second launch; trees of every length, bare
    leaves and poisoning trees included."""
    ops = tops.make_operator_set(["+", "-", "*", "/"], ["cos", "exp", "log"])
    trees = _length_sweep(ops, 2, L, -(-T // L), cuda)[:T]
    X = torch.randn(2, nrows, device=cuda) * 2
    y = torch.randn(nrows, device=cuda)
    plan = tke.launch_plan(T, L, 2, nrows, tke.MODE_FUSED, False, 0)
    assert plan.blocks == -(-T // plan.warps) * plan.items
    yk, okk = tke.eval_trees(trees, X, ops)
    yp, okp = tke.eval_trees_plain(trees, X, ops)
    assert torch.equal(okk, okp) and 0 < int(okk.sum()) < T
    _assert_bits_equal(yk[okk], yp[okk])
    lk = tke.eval_loss_trees(trees, X, y, ops)
    _assert_bits_equal(tke.eval_loss_trees(trees, X, y, ops), lk)
    lp = tke.eval_loss_trees_plain(trees, X, y, ops)
    assert torch.equal(torch.isinf(lk), torch.isinf(lp))
    fin = torch.isfinite(lp)
    torch.testing.assert_close(lk[fin], lp[fin], rtol=1e-4, atol=0)
    sk, _ = tke.eval_slot_values(trees, X[:, :1], ops)
    sp, _ = tke.eval_slot_values_plain(trees, X[:, :1], ops)
    f = torch.isfinite(sp)
    assert torch.equal(torch.isfinite(sk), f)
    _assert_bits_equal(sk[f], sp[f])


@pytest.mark.gpu
def test_scoring_kernel_reads_wide_X_from_global_memory_on_card(cuda):
    """1,000 features: X's rows of a work item do not fit in shared memory,
    so the kernel reads X from global memory; values bit-equal to plain,
    the stack-machine plain version bit-equal to the kernel."""
    ops = tops.make_operator_set(["+", "*"], ["cos"])
    trees = _length_sweep(ops, 1000, L, 20, cuda)
    X = torch.randn(1000, 300, device=cuda)
    assert not tke.launch_plan(trees.length.shape[0], L, 1000, 300,
                               tke.MODE_VALUE, False, 0).staged
    yk, okk = tke.eval_trees(trees, X, ops)
    yp, okp = tke.eval_trees_plain(trees, X, ops)
    assert torch.equal(okk, okp)
    _assert_bits_equal(yk[okk], yp[okk])
    ys, bad = tke.eval_program_plain(trees, X, ops)
    assert torch.equal(~bad, okk)
    _assert_bits_equal(yk[okk], ys[okk])


@pytest.mark.gpu
def test_long_programs_and_invalid_programs_on_card(cuda):
    """max_len 64 (a 32-entry stack) through both redesigned kernels, and
    programs that are not valid postfix programs reported poisoned."""
    ops = tops.make_operator_set(["+", "-", "*", "/"], ["cos", "exp"])
    trees = _length_sweep(ops, 2, 64, 8, cuda)
    X = torch.randn(2, 500, device=cuda)
    y = torch.randn(500, device=cuda)
    yk, okk = tke.eval_trees(trees, X, ops)
    yp, okp = tke.eval_trees_plain(trees, X, ops)
    assert torch.equal(okk, okp)
    _assert_bits_equal(yk[okk], yp[okk])
    lk, _, ok = tkg.make_loss_kernel(trees, X, y, None, ops, False, 1)(trees.cval)
    lp, okp2 = tkg.eval_loss_plain(trees, X, y, None, ops)
    assert torch.equal(ok, okp2)
    torch.testing.assert_close(lk[ok], lp[ok], rtol=1e-5, atol=0)
    kind = torch.zeros((3, L), dtype=torch.int64, device=cuda)
    kind[0, :2] = torch.tensor([VAR, BIN])  # stack underflow
    kind[1, :2] = torch.tensor([VAR, VAR])  # two roots
    kind[2, :1] = VAR
    bad = TreeBatch(kind, torch.zeros_like(kind), torch.zeros_like(kind),
                    torch.zeros((3, L), device=cuda),
                    torch.tensor([2, 2, 1], device=cuda))
    assert tke.eval_trees(bad, X, ops)[1].tolist() == [False, False, True]
    assert tke.eval_loss_trees(bad, X, y, ops)[:2].isinf().all()


@pytest.mark.gpu
def test_invalid_programs_match_the_plain_versions_on_card(cuda):
    """Every kernel and its plain version compute the same function on
    programs that are not valid (each kind that ``program_words`` flags):
    ok False, the value and every slot value 0, the fused loss +inf, the
    gradient 0; the valid trees beside them are unchanged."""
    ops = tops.make_operator_set(["+", "-", "*", "/"], ["cos", "exp"])
    rows = [([VAR, BIN], 2), ([VAR, VAR], 2), ([UNA], 1), ([VAR], L + 1),
            ([VAR], -1), ([VAR, VAR, BIN], 3), ([7], 1), ([VAR], 1)]
    kind = torch.tensor([r + [0] * (L - len(r)) for r, _ in rows], device=cuda)
    op, feat = torch.zeros_like(kind), torch.zeros_like(kind)
    op[5, 2] = ops.n_binary
    feat[7, 0] = 2
    bad = TreeBatch(kind, op, feat, torch.full(kind.shape, 0.5, device=cuda),
                    torch.tensor([n for _, n in rows], device=cuda))
    good = _length_sweep(ops, 1, L, 2, cuda)
    trees = TreeBatch(*(torch.cat(z) for z in zip(good, bad)))
    ng = good.length.shape[0]
    X = torch.randn(2, 300, device=cuda)
    y = torch.randn(300, device=cuda)
    cpu = trees.map(lambda f: f.cpu())
    Xc, yc = X.cpu(), y.cpu()
    for card, plain in (
            (tke.eval_trees(trees, X, ops), tke.eval_trees_plain(cpu, Xc, ops)),
            (tke.eval_slot_values(trees, X[:, :1], ops),
             tke.eval_slot_values_plain(cpu, Xc[:, :1], ops)),
            (tki.eval_trees_instr(trees, X, ops, False),
             tki.eval_trees_instr_plain(cpu, Xc, ops, False))):
        assert torch.equal(card[1].cpu(), plain[1])
        assert not card[1][ng:].any() and not card[0][ng:].any()
    lk = tke.eval_loss_trees(trees, X, y, ops).cpu()
    lp = tke.eval_loss_trees_plain(cpu, Xc, yc, ops)
    assert torch.equal(lk.isinf(), lp.isinf()) and lk[ng:].isposinf().all()
    _, gk, okg = tkg.eval_loss_grad(trees, X, y, None, ops)
    _, gp, okp = tkg.eval_loss_grad_plain(cpu, Xc, yc, None, ops)
    assert torch.equal(okg.cpu(), okp) and not gk[ng:].any()
    _, okl = tkg.eval_loss(trees, X, y, None, ops)
    assert torch.equal(okl.cpu(), tkg.eval_loss_plain(cpu, Xc, yc, None, ops)[1])


@pytest.mark.gpu
@pytest.mark.parametrize("reps", [1, 3, 8])
def test_loss_kernel_candidate_groups_on_card(cuda, reps):
    """The loss-only kernel with reps candidates per tree (8: two warps of
    4 candidates x 2 rows per lane; 1 and 3: one candidate x 4 rows), zero
    weight rows included: against the plain version within rtol 1e-5 (the
    same row-order sum per lane, other reductions), ok equal, and the same
    bits on a second launch."""
    ops = tops.make_operator_set(["+", "-", "*", "/"], ["cos", "exp", "log"])
    trees = _length_sweep(ops, 2, L, 30, cuda)
    T = trees.length.shape[0]
    X = torch.randn(2, 700, device=cuda) * 2
    y = torch.randn(700, device=cuda)
    w = torch.rand(700, device=cuda) + 0.5
    w[:40] = 0.0
    cv = trees.cval.unsqueeze(1) * (1 + 0.1 * torch.randn(T, reps, L, device=cuda))
    before = tkg.LAUNCHES["loss"]
    fn = tkg.make_loss_kernel(trees, X, y, w, ops, with_grad=False, reps=reps)
    lk, _, okk = fn(cv)
    lk2, _, okk2 = fn(cv)
    assert tkg.LAUNCHES["loss"] == before + 2
    assert torch.equal(okk, okk2)
    _assert_bits_equal(lk2, lk)
    rep = trees.map(lambda f: f.repeat_interleave(reps, 0))._replace(
        cval=cv.reshape(-1, L))
    lp, okp = tkg.eval_loss_plain(rep, X, y, w, ops)
    assert torch.equal(okk.reshape(-1), okp) and 0 < int(okp.sum()) < okp.numel()
    torch.testing.assert_close(lk.reshape(-1)[okp], lp[okp], rtol=1e-5, atol=0)


def _grad_case(cuda, max_len, T, seed=0):
    """T random programs of up to max_len - 3 slots plus the poisoning
    trees at max_len, 2 features, 600 rows (not a multiple of a pass),
    weights with zero-weight rows."""
    ops = tops.make_operator_set(["+", "-", "*", "/"], ["cos", "exp", "sqrt", "log"])
    gen = make_generator(seed, cuda)
    trees = random_trees(
        gen, torch.randint(1, max_len - 2, (T,), generator=gen, device=cuda), 2,
        ops, max_len, cuda)
    edge = stack_trees([encode_tree(parse_expression(e, ops), max_len,
                                    device=cuda)
                        for e in ("x0 / (x1 - x1)", "exp(exp(exp(x1 * 1.5)))",
                                  "0.7 + cos(x0 * 1.3)", "sqrt(1.2 * x0)")])
    trees = TreeBatch(*(torch.cat([a, b]) for a, b in zip(trees, edge)))
    X = torch.randn(2, 600, generator=gen, device=cuda) * 2
    X[0] = X[0].abs()
    X[0, :4] = 0.0
    y = torch.randn(600, generator=gen, device=cuda)
    w = torch.rand(600, generator=gen, device=cuda) + 0.5
    w[:4] = 0.0
    return ops, trees, X, y, w


@pytest.mark.gpu
@pytest.mark.parametrize("max_len", [128, 504])
def test_grad_kernel_long_programs_on_card(cuda, max_len):
    """The gradient kernel at max_len 128 and 504 (above the 104 that
    earlier versions took; at 504 one warp's slot values take 165 KB of a
    block's 227), and the loss-only kernel in the line search's layout
    there (one candidate per lane at 504): against the plain versions, ok
    equal, the gradient within the tolerances of
    _assert_grad_outputs_close."""
    ops, trees, X, y, w = _grad_case(cuda, max_len, 300 if max_len > 200 else 1000)
    plan = tkg.grad_plan(trees.length.shape[0], 1, max_len, False)
    assert plan.smem <= 232448 and plan.blocks_per_sm >= 1, plan
    got = tkg.eval_loss_grad(trees, X, y, w, ops)
    *ref, scale = tkg.eval_loss_grad_plain(trees, X, y, w, ops, scale=True)
    assert 0 < int(got[2].sum()) < trees.length.shape[0]
    _assert_grad_outputs_close(got, ref, scale)
    cv = trees.cval.repeat_interleave(8, 0)
    lk, _, okk = tkg.make_loss_kernel(trees, X, y, w, ops, False, reps=8)(cv)
    _assert_grad_outputs_close((lk.reshape(-1, 8)[:, 0], None,
                                okk.reshape(-1, 8)[:, 0]),
                               (ref[0], None, ref[2]))


@pytest.mark.gpu
@pytest.mark.parametrize("max_len", [24, 128])
def test_grad_kernel_loss_equals_loss_kernel_bits_on_card(cuda, max_len):
    """BFGS compares the gradient kernel's loss with the line search's, so
    the two kernels are one function: for the same constants the losses
    and poison flags are equal in every bit, in both of the loss-only
    kernel's layouts (one candidate per lane; 4 candidates x 2 rows)."""
    ops, trees, X, y, w = _grad_case(cuda, max_len, 2000, seed=1)
    for weights in (None, w):
        lg, _, okg = tkg.eval_loss_grad(trees, X, y, weights, ops)
        for reps in (1, 8):
            fn = tkg.make_loss_kernel(trees, X, y, weights, ops, False, reps)
            lk, _, okk = fn(trees.cval.repeat_interleave(reps, 0))
            assert torch.equal(okk.reshape(-1, reps),
                               okg.unsqueeze(-1).expand(-1, reps))
            _assert_bits_equal(lk.reshape(-1, reps),
                               lg.unsqueeze(-1).expand(-1, reps).contiguous())


@pytest.mark.gpu
def test_grad_kernel_two_launches_and_its_mirror_on_card(cuda):
    """Two launches of the gradient kernel give the same bits, and so does
    its plain mirror (the same operations per row, each lane's rows in
    order, the same butterfly) on the operators whose torch and CUDA
    library functions agree (+ - * /, cos, exp)."""
    ops = tops.make_operator_set(["+", "-", "*", "/"], ["cos", "exp"])
    gen = make_generator(2, cuda)
    trees = random_trees(
        gen, torch.randint(1, 23, (3000,), generator=gen, device=cuda), 1,
        ops, L, cuda)
    X = torch.rand(1, 2048, generator=gen, device=cuda) * 2 + 1
    y = torch.exp(-X[0] ** 2 / 2)
    fn = tkg.make_loss_kernel(trees, X, y, None, ops, True)
    (l1, g1, ok1), (l2, g2, ok2) = fn(trees.cval), fn(trees.cval)
    assert torch.equal(ok1, ok2)
    _assert_bits_equal(l2, l1)
    _assert_bits_equal(g2, g1)
    lm, gm, okm = tkg.eval_loss_grad_program_plain(trees, X, y, None, ops)
    assert torch.equal(ok1, okm) and int(ok1.sum()) > 2000
    _assert_bits_equal(l1[ok1], lm[ok1])
    _assert_bits_equal(g1[ok1], gm[ok1])


@pytest.mark.gpu
def test_grad_kernel_poisons_invalid_programs_with_zero_gradient_on_card(cuda):
    """Programs that are not valid postfix (underflow, unfinished, a length
    beyond L, a negative length, an operator outside the set, an unknown
    kind, a feature out of range) are reported poisoned by the kernel
    itself, loss and gradient 0, at max_len 24 and 128; the valid program
    beside them is not."""
    ops = tops.make_operator_set(["+", "-", "*", "/"], ["cos", "exp"])
    X = torch.randn(2, 300, device=cuda)
    y = torch.randn(300, device=cuda)
    for max_len in (L, 128):
        rows = [([VAR, BIN], 2), ([VAR, VAR], 2), ([VAR], max_len + 1),
                ([VAR], -1), ([VAR, VAR, BIN], 3), ([7], 1), ([VAR], 1),
                ([CONST, VAR, BIN], 3)]
        kind = torch.tensor([r + [0] * (max_len - len(r)) for r, _ in rows],
                            device=cuda)
        op, feat = torch.zeros_like(kind), torch.zeros_like(kind)
        op[4, 2] = ops.n_binary
        feat[6, 0] = 2
        trees = TreeBatch(kind, op, feat,
                          torch.full(kind.shape, 0.5, device=cuda),
                          torch.tensor([n for _, n in rows], device=cuda))
        loss, grad, ok = tkg.eval_loss_grad(trees, X, y, None, ops)
        assert ok.tolist() == [False] * 7 + [True]
        assert not loss[:7].any() and not grad[:7].any()
        assert grad[7, 0] != 0 and not grad[7, 1:].any()


def _invalid(max_len, nfeat, n_binary, device):
    """One program of each kind that ``program_words`` flags."""
    rows = [([VAR, BIN], 2), ([VAR, VAR], 2), ([UNA], 1), ([VAR], max_len + 1),
            ([VAR], -1), ([VAR, VAR, BIN], 3), ([7], 1), ([VAR], 1)]
    kind = torch.tensor([r + [0] * (max_len - len(r)) for r, _ in rows],
                        device=device)
    op, feat = torch.zeros_like(kind), torch.zeros_like(kind)
    op[5, 2] = n_binary
    feat[7, 0] = nfeat
    return TreeBatch(kind, op, feat, torch.full(kind.shape, 0.5, device=device),
                     torch.tensor([n for _, n in rows], device=device))


def _long_batch(cuda, max_len, nfeat=3, T=60, seed=0):
    """T random programs of up to max_len - 3 slots, the deep programs,
    the poisoning trees and (last) the invalid programs, at max_len; X of
    300 rows, y, weights with zero-weight rows."""
    ops = tops.make_operator_set(["+", "-", "*", "/"], ["cos", "exp"])
    gen = make_generator(seed, cuda)
    trees = random_trees(
        gen, torch.randint(1, max_len - 2, (T,), generator=gen, device=cuda),
        nfeat, ops, max_len, cuda)
    edge = stack_trees([encode_tree(parse_expression(e, ops), max_len,
                                    device=cuda)
                        for e in ("x0 / (x1 - x1)", "exp(exp(exp(x1 * 1.5)))",
                                  "0.7 + cos(x0 * 1.3)")])
    bad = _invalid(max_len, nfeat, ops.n_binary, cuda)
    trees = TreeBatch(*(torch.cat(z) for z in zip(
        trees, deep_trees(max_len, nfeat, device=cuda), edge, bad)))
    X = torch.randn(nfeat, 300, generator=gen, device=cuda) * 1.5
    y = torch.randn(300, generator=gen, device=cuda)
    w = torch.rand(300, generator=gen, device=cuda) + 0.5
    w[:5] = 0.0
    return ops, trees, X, y, w, len(bad.length)


@pytest.mark.gpu
@pytest.mark.parametrize("max_len", [512, 1024, 2048])
def test_every_kernel_at_long_max_len_on_card(cuda, max_len):
    """max_len 512, 1,024 and 2,048 (the kernels refused 512 and above
    before): B1 and the slot mode bit-equal to their plain versions, B2
    within rtol 1e-4 (rows summed in another order) with the same +inf,
    B3 bit-equal to its plain mirror, its loss bit-equal to B4's in both
    of B4's layouts, B5 (and B6 where its packed word takes the width)
    bit-equal to B1; two launches of each give the same bits; every
    invalid program poisoned, its value and slot values 0, its loss +inf
    and its gradient 0, as at max_len 24."""
    ops, trees, X, y, w, n_bad = _long_batch(cuda, max_len)
    T = trees.length.shape[0]
    good = slice(0, T - n_bad)
    yk, okk = tke.eval_trees(trees, X, ops)
    _assert_bits_equal(tke.eval_trees(trees, X, ops)[0], yk)
    ys, bad = tke.eval_program_plain(trees, X, ops)
    assert torch.equal(okk, ~bad & (trees.length > 0))
    assert 0 < int(okk.sum()) < T - n_bad and not okk[-n_bad:].any()
    _assert_bits_equal(yk[okk], ys[okk])
    assert not yk[-n_bad:].any()
    lk = tke.eval_loss_trees(trees, X, y, ops)
    _assert_bits_equal(tke.eval_loss_trees(trees, X, y, ops), lk)
    lp = tke.eval_loss_trees_plain(trees, X, y, ops)
    assert torch.equal(torch.isinf(lk), torch.isinf(lp))
    assert lk[-n_bad:].isposinf().all()
    fin = torch.isfinite(lp)
    torch.testing.assert_close(lk[fin], lp[fin], rtol=1e-4, atol=0)
    sk, oks = tke.eval_slot_values(trees, X[:, :1], ops)
    sp, _ = tke.eval_slot_values_plain(trees, X[:, :1], ops)
    f = torch.isfinite(sp)
    assert torch.equal(torch.isfinite(sk), f) and not oks[-n_bad:].any()
    _assert_bits_equal(sk[f], sp[f])
    assert not sk[-n_bad:].any()
    lg, gg, okg = tkg.eval_loss_grad(trees, X, y, w, ops)
    lg2, gg2, _ = tkg.eval_loss_grad(trees, X, y, w, ops)
    _assert_bits_equal(lg2, lg)
    _assert_bits_equal(gg2, gg)
    lm, gm, okm = tkg.eval_loss_grad_program_plain(trees, X, y, w, ops)
    assert torch.equal(okg, okm) and not okg[-n_bad:].any()
    _assert_bits_equal(lg[okg], lm[okg])
    _assert_bits_equal(gg[okg], gm[okg])
    assert not gg[-n_bad:].any()
    for reps in (1, 8):
        fn = tkg.make_loss_kernel(trees, X, y, w, ops, False, reps)
        l4, _, ok4 = fn(trees.cval.repeat_interleave(reps, 0))
        assert torch.equal(ok4.reshape(-1, reps),
                           okg.unsqueeze(-1).expand(-1, reps))
        _assert_bits_equal(l4.reshape(-1, reps),
                           lg.unsqueeze(-1).expand(-1, reps).contiguous())
    for packed in (False, True):
        if packed and X.shape[0] + max_len + 4 > 2048:
            with pytest.raises(ValueError, match="instr_packed"):
                tki.eval_trees_instr(trees, X, ops, packed)
            continue
        yi, oki = tki.eval_trees_instr(trees, X, ops, packed)
        assert torch.equal(oki, okk)
        _assert_bits_equal(yi[okk], yk[okk])
        assert not yi[-n_bad:].any()
    plan = tke.launch_plan(T, max_len, 3, 300, tke.MODE_VALUE, False, 0)
    assert plan.narrow == (max_len > 512), plan
    assert tkg.grad_plan(T, 1, max_len, False).narrow == (max_len > 512)
    assert okk[good].any()


@pytest.mark.gpu
def test_instr_kernels_at_their_longest_on_card(cuda):
    """5 features: B5 at max_len 2,048 (the narrow route, its results in
    shared memory) and 3,072 (in global memory), and B6 at 2,039, the
    longest its 11-bit operand indices take (5 + 2,039 + 4 = 2,048; in
    global memory), each bit-equal to B1 with the same poisoned trees; B6
    raises one slot beyond, as the JAX package does."""
    for max_len, packed, in_global in ((2048, False, False),
                                       (3072, False, True), (2039, True, True)):
        ops, trees, X, _, _, n_bad = _long_batch(cuda, max_len, nfeat=5,
                                                 T=30, seed=max_len)
        T = trees.length.shape[0]
        plan = tki.launch_plan(T, max_len, 5, 300, packed, False, 0)
        assert plan.narrow and (plan.scratch_bytes > 0) == in_global, plan
        yk, okk = tke.eval_trees(trees, X, ops)
        yi, oki = tki.eval_trees_instr(trees, X, ops, packed)
        assert torch.equal(oki, okk) and 0 < int(okk.sum()) < T - n_bad
        _assert_bits_equal(yi[okk], yk[okk])
    ops, trees, X, _, _, _ = _long_batch(cuda, 2040, nfeat=5, T=4)
    with pytest.raises(ValueError, match="instr_packed"):
        tki.eval_trees_instr(trees, X, ops, True)


@pytest.mark.gpu
def test_instr_scoring_call_makes_no_host_wait_on_card(cuda):
    """The instruction programs' scoring call (the kernel's wrapper, then
    the loss and its containment in PyTorch) at the cycle's 5,376 trees
    neither waits for the card nor copies between host and card: the
    kernels derive the program themselves."""
    from torch.profiler import ProfilerActivity, profile

    from symbolicregression_jl_tpu_torch.models import fitness as tfit
    from symbolicregression_jl_tpu_torch.tools.kernel_breakdown import (
        sync_counts,
    )

    ops = tops.make_operator_set(["+", "-", "*", "/"], ["cos", "exp"])
    gen = make_generator(7, cuda)
    trees = random_trees(
        gen, torch.randint(1, 21, (5376,), generator=gen, device=cuda), 1, ops,
        L, cuda)
    X = torch.rand(1, 2048, generator=gen, device=cuda) * 2 + 1
    y = torch.exp(-X[0] ** 2 / 2)
    for program in ("instr", "instr_packed"):
        call = lambda: tfit.eval_loss_trees(trees, X, y, None, ops,
                                            "L2DistLoss", program=program)
        call()
        torch.cuda.synchronize()
        before = tki.LAUNCHES[program]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                call()
        assert tki.LAUNCHES[program] == before + 5
        by_call, by_op = sync_counts(prof)
        # the profiler's own closing synchronize has no issuing operator
        waits = [k for k in by_op if "Synchronize" in k and " <- None " not in k]
        copies = [c for c in by_call if "HtoD" in c or "DtoH" in c]
        assert not waits and not copies, (program, waits, copies)


def _every_loss():
    """Each loss of the registry once, then the parameterised factories at
    parameters other than their defaults."""
    losses = []
    for v in tlosses.LOSS_REGISTRY.values():
        if v not in losses:
            losses.append(v)
    return losses + [tlosses.huber_loss(2.0), tlosses.quantile_loss(0.3),
                     tlosses.lp_dist_loss(3.0), tlosses.dwd_margin_loss(2.0),
                     tlosses.smoothed_l1_hinge_loss(0.5),
                     tlosses.periodic_loss(3.0),
                     tlosses.l1_epsilon_ins_loss(0.3)]


def _loss_case(cuda, max_len):
    """Over + - * / cos exp (whose torch and CUDA library functions agree,
    so the mirrors can give the kernels' bits): at max_len 24, 2,000 random
    programs and the poisoning trees on 600 rows; longer, ``_long_batch``
    (300 rows, its invalid programs last)."""
    if max_len != L:
        return _long_batch(cuda, max_len)
    ops = tops.make_operator_set(["+", "-", "*", "/"], ["cos", "exp"])
    gen = make_generator(5, cuda)
    trees = random_trees(
        gen, torch.randint(1, L - 2, (2000,), generator=gen, device=cuda), 2,
        ops, L, cuda)
    edge = stack_trees([encode_tree(parse_expression(e, ops), L, device=cuda)
                        for e in ("x0 / (x1 - x1)", "exp(exp(exp(x1 * 1.5)))",
                                  "0.7 + cos(x0 * 1.3)")])
    trees = TreeBatch(*(torch.cat([a, b]) for a, b in zip(trees, edge)))
    X = torch.randn(2, 600, generator=gen, device=cuda) * 2
    y = torch.randn(600, generator=gen, device=cuda)
    w = torch.rand(600, generator=gen, device=cuda) + 0.5
    w[:4] = 0.0
    return ops, trees, X, y, w, 0


@pytest.mark.gpu
def test_loss_library_grid_on_card(cuda):
    """csrc/losses.cuh elementwise: programs that are a single constant,
    one row (X's value unused) and target t, so B2's fused sum is
    loss_elem(c, t) and B3's loss and gradient are loss_elem(c, t) and
    loss_seed(c, t) (the weight is 1); against the plain ``loss`` and
    ``loss.seed`` on the card over a grid of finite predictions (a
    non-finite constant poisons its program) and targets: bit for bit for
    the losses without a transcendental function, rtol 1e-6 (atol 1e-36
    for subnormal results) for the rest."""
    ops = tops.make_operator_set(["+", "*"], [])
    base = [0.0, -0.0, 1e-30, -1e-30, 0.3, -0.3, 0.5, -0.5, 1.0, -1.0, 1.5,
            2.0, -2.0, 3.7, -3.7, 20.0, -20.0, 87.0, 89.0, 100.0, -100.0, 1e4,
            -1e4, 1e20, -1e20, 3e38]
    for loss in _every_loss():
        grid = torch.tensor(base + [v for c in loss.constants if c
                                    for v in (c, -c, 1 - c, 1 + c)],
                            device=cuda)
        n = grid.shape[0]
        kind = torch.zeros((n, L), dtype=torch.int64, device=cuda)
        kind[:, 0] = 1  # CONST
        cval = torch.zeros((n, L), device=cuda)
        cval[:, 0] = grid
        trees = TreeBatch(kind, torch.zeros_like(kind), torch.zeros_like(kind),
                          cval, torch.ones(n, dtype=torch.int64, device=cuda))
        X = torch.zeros((1, 1), device=cuda)
        for t in (0.0, 1.0, -1.0, 0.5, 2.0, -3.0):
            y = torch.tensor([t], device=cuda)
            # the kernels add each value to a zero sum: -0 comes out +0
            ref = loss(grid, y.expand(n)) + 0.0
            seed = loss.seed(grid, y.expand(n)) + 0.0
            fused = tke.eval_loss_trees(trees, X, y, ops, loss)
            l3, g3, ok3 = tkg.eval_loss_grad(trees, X, y, None, ops, loss=loss)
            assert bool(ok3.all())
            for name, got, want in (("elem (B2)", fused, ref),
                                    ("elem (B3)", l3, ref),
                                    ("seed (B3)", g3[:, 0], seed)):
                if name == "elem (B2)":  # contained to +inf
                    want = torch.where(torch.isfinite(want), want, float("inf"))
                if loss.kind in tlosses.TRANSCENDENTAL:
                    torch.testing.assert_close(
                        got, want, rtol=1e-6, atol=1e-36, equal_nan=True,
                        msg=lambda m: f"{loss} {name} t={t}: {m}")
                else:
                    diff = got.view(torch.int32) != want.view(torch.int32)
                    diff &= ~(torch.isnan(got) & torch.isnan(want))
                    assert not bool(diff.any()), (
                        loss, name, t, grid[diff].tolist(), got[diff].tolist(),
                        want[diff].tolist())


# the losses whose mirrors run at the long max_len (each mirror sweeps
# every slot in PyTorch): one with abs, one with a where, one with exp and
# log1p, one margin loss
LONG_MIRRORED = ("L1DistLoss", "HuberLoss", "LogCoshLoss", "L2HingeLoss")


@pytest.mark.gpu
@pytest.mark.parametrize("max_len", [24, 512, 1024])
def test_every_loss_through_the_kernels_on_card(cuda, max_len):
    """Every loss of the registry through B2 (unweighted), B3 and B4
    (weighted, zero-weight rows included), at max_len 24, 512 and 1,024
    (B2's and B3's narrow routes at 1,024): two launches the same bits;
    B3's loss bit-equal to B4's in both of B4's layouts; against the plain
    mirrors (``eval_loss_trees_program_plain`` under B2's plan,
    ``eval_loss_grad_program_plain``), bit for bit for the losses without
    a transcendental function (L2's B2 instantiation contracts acc + d * d
    into one multiply-add, so its sums at rtol 1e-6) and for the rest
    within rtol 1e-5 (losses) and the row-sum yardstick of
    ``_assert_grad_outputs_close`` (gradients); at the long max_len the
    mirrors run for ``LONG_MIRRORED``. B2 also against its plain version
    within rtol 1e-4 (rows summed in another order)."""
    ops, trees, X, y, w, nb = _loss_case(cuda, max_len)
    T, nrows = trees.length.shape[0], X.shape[1]
    full = tke.uses_full_kernel(ops)
    for loss in _every_loss():
        exact = loss.kind not in tlosses.TRANSCENDENTAL
        any_loss = loss.kind != tlosses.L2
        lk = tke.eval_loss_trees(trees, X, y, ops, loss)
        _assert_bits_equal(tke.eval_loss_trees(trees, X, y, ops, loss), lk)
        plan = tke.launch_plan(T, max_len, X.shape[0], nrows, tke.MODE_FUSED,
                               full, 0, any_loss)
        assert plan.narrow == (max_len > 512), (loss, plan)
        sums, okm = tke.eval_loss_trees_program_plain(trees, X, y, ops, loss,
                                                      plan)
        lm = tlosses.contain_nonfinite(sums / nrows, okm)
        assert torch.equal(torch.isinf(lk), torch.isinf(lm)), loss
        fin = torch.isfinite(lm)
        if exact and any_loss:
            _assert_bits_equal(lk[fin], lm[fin])
        else:
            torch.testing.assert_close(
                lk[fin], lm[fin], rtol=1e-5 if any_loss else 1e-6, atol=0,
                msg=lambda m: f"{loss}: {m}")
        lp = tke.eval_loss_trees_plain(trees, X, y, ops, loss)
        assert torch.equal(torch.isinf(lk), torch.isinf(lp)), loss
        torch.testing.assert_close(lk[fin], lp[fin], rtol=1e-4, atol=0)
        if nb:
            assert bool(lk[-nb:].isposinf().all())
        l3, g3, ok3 = tkg.eval_loss_grad(trees, X, y, w, ops, loss=loss)
        l3b, g3b, ok3b = tkg.eval_loss_grad(trees, X, y, w, ops, loss=loss)
        assert torch.equal(ok3, ok3b)
        _assert_bits_equal(l3b, l3)
        _assert_bits_equal(g3b, g3)
        for reps in (1, 8):
            fn = tkg.make_loss_kernel(trees, X, y, w, ops, False, reps,
                                      loss=loss)
            l4, _, ok4 = fn(trees.cval.repeat_interleave(reps, 0))
            assert torch.equal(ok4.reshape(-1, reps),
                               ok3.unsqueeze(-1).expand(-1, reps))
            _assert_bits_equal(l4.reshape(-1, reps),
                               l3.unsqueeze(-1).expand(-1, reps).contiguous())
        if max_len != L and loss.name not in LONG_MIRRORED:
            continue
        lm, gm, okm = tkg.eval_loss_grad_program_plain(trees, X, y, w, ops,
                                                       loss=loss)
        assert torch.equal(ok3, okm), loss
        if exact:
            _assert_bits_equal(l3[ok3], lm[ok3])
            _assert_bits_equal(g3[ok3], gm[ok3])
        else:
            *_, scale = tkg.eval_loss_grad_plain(trees, X, y, w, ops,
                                                 scale=True, loss=loss)
            _assert_grad_outputs_close((l3, g3, ok3), (lm, gm, okm), scale)


def _bits(t):
    return t.contiguous().view({2: torch.int16, 4: torch.int32,
                                8: torch.int64}[t.element_size()])


@pytest.mark.gpu
@pytest.mark.parametrize("max_len", [24, 512, 1024])
@pytest.mark.parametrize("precision", ["bfloat16", "float16"])
def test_precision_builds_bit_equal_to_plain_on_card(cuda, precision, max_len):
    """The bfloat16 / float16 builds of B1, the slot mode, B5, B6, B3 and
    B4 against their plain versions (which round every value to the
    dtype, as the kernels do) bit for bit, B5/B6 against B1 and B3's loss
    against B4's, two launches the same bits; a product that overflows
    only at the storage rounding and an invalid program poisoned. At
    max_len 1,024 every kernel takes its narrow route."""
    dt = getattr(torch, precision)
    ops = tops.make_operator_set(["+", "-", "*", "/"], ["cos", "exp"])
    gen = make_generator(3, cuda)
    trees = random_trees(
        gen, torch.randint(1, min(max_len, 24) - 1, (500,), device=cuda), 2,
        ops, max_len, cuda)
    over = stack_trees([encode_tree(parse_expression(e, ops), max_len,
                                    device=cuda)
                        for e in (f"(x0 * 0.0 + 1.1171875) * {229 * 2.0 ** 120!r}",
                                  "exp(x1 * 0.0 + 11.2)", "x0 / (x1 - x1)")])
    bad = over[2:3]._replace(length=over.length[2:3] + max_len)  # invalid
    trees = TreeBatch(*(torch.cat(z) for z in zip(over, bad, trees)))
    if max_len > 24:
        deep = deep_trees(max_len, 2, device=cuda)
        trees = TreeBatch(*(torch.cat(z) for z in zip(trees, deep)))
    X = (torch.rand(2, 777, device=cuda) * 4 - 2).to(dt)
    y = (torch.rand(777, device=cuda) * 2).to(dt)
    w = torch.rand(777, device=cuda) + 0.5
    w[:40] = 0.0
    before = dict(tke.STORAGE_LAUNCHES)
    yk, okk = tke.eval_trees(trees, X, ops)
    assert yk.dtype == dt
    assert torch.equal(_bits(tke.eval_trees(trees, X, ops)[0]), _bits(yk))
    ym, badm = tke.eval_program_plain(trees, X, ops)
    assert torch.equal(okk, ~badm & (trees.length > 0))
    assert not okk[[0 if dt == torch.bfloat16 else 1, 2, 3]].any()
    assert torch.equal(_bits(yk[okk]), _bits(ym[okk]))
    sfx = tke.STORAGE[dt][1]
    assert tke.STORAGE_LAUNCHES[f"value{sfx}"] == before[f"value{sfx}"] + 2
    X1 = X[:, :1]
    sk, oks = tke.eval_slot_values(trees, X1, ops)
    sp, okp = tke.eval_slot_values_plain(trees, X1, ops)
    fin = torch.isfinite(sp)
    assert torch.equal(torch.isfinite(sk), fin) and torch.equal(oks, okp)
    assert torch.equal(_bits(sk[fin]), _bits(sp[fin]))
    for packed in (False, True):
        yi, oki = tki.eval_trees_instr(trees, X, ops, packed)
        assert torch.equal(oki, okk)
        assert torch.equal(_bits(yi[okk]), _bits(yk[okk]))
    for weights in (None, w):
        raw = tkg.stage_launch(trees, X, y, weights, ops, True, 1)
        l3, g3, b3 = raw(trees.cval)
        l3b, g3b, _ = raw(trees.cval)
        assert torch.equal(_bits(l3b), _bits(l3))
        assert torch.equal(_bits(g3b), _bits(g3))
        lm, gm, okm = tkg.eval_loss_grad_program_plain(trees, X, y, weights, ops)
        assert torch.equal((b3 == 0) & (trees.length > 0), okm)
        assert torch.equal(_bits(l3[okm]), _bits(lm[okm]))
        assert torch.equal(_bits(g3[okm]), _bits(gm[okm]))
        for reps in (1, 8):
            fn = tkg.stage_launch(trees, X, y, weights, ops, False, reps)
            l4 = fn(trees.cval.repeat_interleave(reps, 0))[0]
            assert torch.equal(_bits(l4.reshape(-1, reps)),
                               _bits(l3.unsqueeze(-1).expand(-1, reps)))
    fn = tkg.make_loss_kernel(trees, X, y, None, ops)
    total, grad, _ = fn(trees.cval)
    assert total.dtype == grad.dtype == dt


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["bfloat16", "float16"])
def test_precision_search_routes_on_card(cuda, precision):
    """A search at bfloat16 / float16 launches that dtype's builds only:
    the value mode for every scoring call (never the fused mode, which is
    float32 only), the fold kernel for simplify_tree, B3 / B4 for BFGS, and no
    float32 build; its state is in the working dtype."""
    dt = getattr(torch, precision)
    sfx = tke.STORAGE[dt][1]
    for counts in (tke.LAUNCHES, tkg.LAUNCHES, tki.LAUNCHES,
                   tke.STORAGE_LAUNCHES, tkg.STORAGE_LAUNCHES,
                   tki.STORAGE_LAUNCHES):
        for k in counts:
            counts[k] = 0
    rng = np.random.default_rng(0)
    X = (rng.standard_normal((2, 60)) * 2).astype("f4")
    res = sr.equation_search(X, 2.5 * np.cos(X[0]) + X[1], niterations=2,
                             binary_operators=["+", "*"],
                             unary_operators=["cos"], npop=30, npopulations=4,
                             ncycles_per_iteration=15, maxsize=10,
                             precision=precision, verbosity=0, seed=0,
                             return_state=True)
    assert not any({**tke.LAUNCHES, **tkg.LAUNCHES, **tki.LAUNCHES}.values())
    assert tke.STORAGE_LAUNCHES[f"value{sfx}"] == 2 * (15 + 1) + 1
    assert tke.STORAGE_LAUNCHES[f"fold{sfx}"] == 2 * (15 + 1)
    assert tkg.STORAGE_LAUNCHES[f"loss_grad{sfx}"] == 2 * 9
    assert tkg.STORAGE_LAUNCHES[f"loss{sfx}"] == 2 * 8
    assert res.state[0].island_states.pop.losses.dtype == dt
    assert res.state[0].island_states.pop.trees.cval.dtype == dt
    assert np.isfinite(res.best_loss().loss)
    assert res.predict(X).shape == (60,)


# ---------------------------------------------------------------------------
# The cycle captured as a CUDA graph (models/cycle_graph.py)
# ---------------------------------------------------------------------------

GRAPH_CFG = dict(binary_operators=["+", "-", "*", "/"],
                 unary_operators=["cos", "exp"], npop=50, npopulations=4,
                 tournament_selection_n=6, maxsize=12, verbosity=0)


def _zero_counts():
    for counts in cg.LAUNCH_COUNTERS:
        for k in list(counts):
            counts[k] = 0


def _graph_case(cuda, kw):
    o = sr.make_options(**GRAPH_CFG, **kw)
    rng = np.random.default_rng(0)
    X = torch.tensor((rng.standard_normal((2, 200)) * 2).astype("f4"),
                     device=cuda).to(o.dtype)
    y = (X[0] * X[0] - torch.cos(X[1])).to(o.dtype)
    st = tevolve.init_island_state(island_keys(0, 4, cuda), o, 2, X, y, None,
                                   1.5)
    return o, X, y, st


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [
    dict(annealing=True),
    dict(batching=True, batch_size=40, warmup_maxsize_by=0.5),
    dict(precision="bfloat16", kernel_program="instr"),
], ids=["annealing", "batching", "bf16-instr"])
def test_captured_cycle_bit_equal_to_eager_on_card(cuda, kw):
    """Two iterations of 10 cycles (curmaxsize 5, then 12) replayed from
    one capture give the eager loop's state bit for bit, every
    ``IslandState`` field, the islands' keys included, with the same
    launch counts."""
    cg.clear_cache()
    o, X, y, st = _graph_case(cuda, kw)
    a = b = st
    for cm in (5, 12):
        _zero_counts()
        a = tevolve.s_r_cycle_islands(a, cm, X, y, None, 1.5, o, ncycles=10)
        eager = [dict(c) for c in cg.LAUNCH_COUNTERS]
        _zero_counts()
        b = cg.s_r_cycle_islands_graph(b, cm, X, y, None, 1.5, o, ncycles=10)
        captured = [dict(c) for c in cg.LAUNCH_COUNTERS]
        assert captured == eager
        assert sum(sum(c.values()) for c in eager) > 0
        for fa, fb in zip(cg._leaves(a), cg._leaves(b), strict=True):
            assert torch.equal(fa, fb)
        assert tkr.LAUNCHES["split"] > 0
    (g,) = cg._CACHE.values()
    assert g.captures == 1 and g.replays == 20


@pytest.mark.gpu
def test_second_search_replays_the_first_capture_on_card(cuda):
    """A second search at the same widths, with other data and another
    alpha, replays the first search's graph (no new capture), and its hall
    of fame equals that search run alone with a cleared cache."""
    kw = dict(GRAPH_CFG, niterations=2, ncycles_per_iteration=15, seed=2,
              annealing=True)
    rng = np.random.default_rng(1)
    X1 = (rng.standard_normal((2, 100)) * 2).astype("f4")
    X2 = (rng.standard_normal((2, 100)) * 2).astype("f4")
    cg.clear_cache()
    sr.equation_search(X1, X1[0] * X1[1], **kw)
    (g,) = cg._CACHE.values()
    assert g.captures == 1 and g.replays == 2 * 15
    r2 = sr.equation_search(X2, np.cos(X2[0]) + X2[1], alpha=0.5, **kw)
    assert list(cg._CACHE.values()) == [g]
    assert g.captures == 1 and g.replays == 4 * 15
    cg.clear_cache()
    r3 = sr.equation_search(X2, np.cos(X2[0]) + X2[1], alpha=0.5, **kw)
    assert [(c.complexity, c.loss, c.equation) for c in r2.frontier()] == [
        (c.complexity, c.loss, c.equation) for c in r3.frontier()]


@pytest.mark.gpu
def test_failed_capture_raises_on_card(cuda, monkeypatch):
    """A step that reads the card from the host cannot be captured: the
    search raises and does not fall back to the eager loop."""
    real = cg.cycle_step

    def host_read(*a, **k):
        out = real(*a, **k)
        if bool(out[0].num_evals.sum() < 0):  # a wait for the card
            raise AssertionError("unreachable")
        return out

    monkeypatch.setattr(cg, "cycle_step", host_read)
    cg.clear_cache()
    rng = np.random.default_rng(0)
    X = (rng.standard_normal((2, 50)) * 2).astype("f4")
    with pytest.raises(RuntimeError):
        sr.equation_search(X, X[0] * X[0], niterations=1,
                           ncycles_per_iteration=3, **GRAPH_CFG)
    (g,) = cg._CACHE.values()
    assert g.graph is None and g.replays == 0
    cg.clear_cache()
    torch.cuda.synchronize()


def _frontier_bits(cands):
    return [(c.complexity, c.loss, c.equation) for c in cands]


@pytest.mark.gpu
def test_two_outputs_share_one_capture_on_card(cuda):
    """A 2-output search captures its cycle once and replays it for both
    outputs; output 1 equals the solo search at seed + 7919 bit for bit,
    which replays the same capture."""
    kw = dict(GRAPH_CFG, niterations=2, ncycles_per_iteration=15)
    rng = np.random.default_rng(2)
    X = (rng.standard_normal((2, 100)) * 2).astype("f4")
    Y = np.stack([X[0] * X[1], np.cos(X[0]) + X[1]])
    cg.clear_cache()
    _zero_counts()
    res = sr.equation_search(X, Y, seed=3, **kw)
    (g,) = cg._CACHE.values()
    assert g.captures == 1 and g.replays == 2 * 2 * 15
    assert tke.LAUNCHES["fused"] == 2 * (1 + 2 * (15 + 1))
    solo = sr.equation_search(X, Y[1], seed=3 + 7919, **kw)
    assert list(cg._CACHE.values()) == [g] and g.captures == 1
    assert _frontier_bits(solo.frontier()) == _frontier_bits(res.frontier(1))
    cg.clear_cache()


@pytest.mark.gpu
def test_mask_route_launches_on_card(cuda, monkeypatch):
    """data_policy="mask" on NaN rows is a weighted search: its own
    capture, every scoring call on B1's value mode, BFGS on weighted B3 /
    B4, and no plain version reached."""
    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")

    for mod, name in ((tke, "eval_trees_plain"),
                      (tke, "eval_loss_trees_plain"),
                      (tke, "eval_slot_values_plain"),
                      (tmut, "simplify_tree_plain"),
                      (tkg, "_plain_loss_grad")):
        monkeypatch.setattr(mod, name, refuse)
    weighted = []
    stage = tkg.stage_launch

    def spy(trees, X_, y_, weights, *rest, **k):
        weighted.append(weights is not None)
        return stage(trees, X_, y_, weights, *rest, **k)

    monkeypatch.setattr(tkg, "stage_launch", spy)
    rng = np.random.default_rng(4)
    X = (rng.standard_normal((2, 100)) * 2).astype("f4")
    y = X[0] * X[1]
    y[[3, 50, 77]] = np.nan
    cg.clear_cache()
    _zero_counts()
    res = sr.equation_search(X, y, seed=0, niterations=1,
                             ncycles_per_iteration=15, data_policy="mask",
                             **GRAPH_CFG)
    (g,) = cg._CACHE.values()
    assert g.captures == 1 and g.weights is not None
    assert res.dataset_diagnostics["masked_rows"] == 3
    assert tke.LAUNCHES["value"] == 1 + 15 + 1 and tke.LAUNCHES["fused"] == 0
    assert tkg.LAUNCHES == {"loss_grad": 9, "loss": 8}
    assert weighted and all(weighted)
    assert all(np.isfinite(c.loss) for c in res.frontier())
    cg.clear_cache()


@pytest.mark.gpu
def test_to_callable_runs_b1_on_card(cuda):
    """to_callable on a CUDA tensor launches B1's value mode once and
    equals B1's plain version on the same tensors bit for bit."""
    from symbolicregression_jl_tpu_torch.utils.export import to_callable

    ops = tops.make_operator_set(["+", "-", "*", "/"], ["cos", "exp"])
    tree = encode_tree(parse_expression("2*cos(x1) + x0*x0 - exp(x1/3)", ops),
                       L, device="cpu")
    X = torch.tensor(np.random.default_rng(6).standard_normal((2, 300)),
                     dtype=torch.float32, device=cuda)
    before = tke.LAUNCHES["value"]
    got = to_callable(tree, ops)(X)
    assert tke.LAUNCHES["value"] == before + 1 and got.is_cuda
    plain, _ = tke.eval_trees_plain(tree.map(lambda x: x.to(cuda)[None]), X,
                                    ops)
    assert torch.equal(got, plain[0])


@pytest.fixture
def custom_pair(monkeypatch):
    """The reference's custom pair registered into copies of the
    registries (undone at the test's end)."""
    monkeypatch.setattr(tops, "UNARY_REGISTRY", dict(tops.UNARY_REGISTRY))
    monkeypatch.setattr(tops, "BINARY_REGISTRY", dict(tops.BINARY_REGISTRY))
    tops.register_binary("op2c", lambda x, y: x * x + 1.0 / (y * y + 0.1))
    tops.register_unary("op3c", lambda x: torch.sin(x) + torch.cos(x))
    return tops.make_operator_set(["+", "*", "op2c"], ["op3c", "cos"])


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_user_operators_and_loss_in_every_kernel_on_card(cuda, custom_pair,
                                                         precision):
    """Every kernel over the custom pair, and B2 / B3 / B4 under a loss
    callable, against its plain version on the card (values at rtol 1e-5,
    B2 at 1e-4, B3 against its mirror, B4's loss B3's in every bit, B5 /
    B6 bit-equal to B1), launched from the user builds only."""
    ops = custom_pair
    dt = getattr(torch, precision)
    loss = lambda p, t: (p - t) ** 2  # noqa: E731
    gen = make_generator(4, cuda)
    trees = random_trees(
        gen, torch.randint(1, 21, (600,), device=cuda), 3, ops, L, cuda)
    X = (torch.randn(3, 333, device=cuda) * 1.5).to(dt)
    y = torch.randn(333, device=cuda).to(dt)
    for counts in (tke.USER_LAUNCHES, tkg.USER_LAUNCHES, tki.USER_LAUNCHES):
        counts.clear()
    before = sum(tke.LAUNCHES.values()) + sum(tkg.LAUNCHES.values())
    yk, okk = tke.eval_trees(trees, X, ops)
    yp, okp = tke.eval_trees_plain(trees, X, ops)
    assert torch.equal(okk, okp) and int(okk.sum()) > 0
    torch.testing.assert_close(yk[okk].float(), yp[okk].float(), rtol=1e-5,
                               atol=1e-6)
    for packed in (False, True):
        ik, iok = tki.eval_trees_instr(trees, X, ops, packed)
        assert torch.equal(iok, okk) and torch.equal(ik[okk], yk[okk])
    raw = tkg.stage_launch(trees, X, y, None, ops, True, 1, loss)
    l3, g3, b3 = raw(trees.cval)
    lm, gm, okm = tkg.eval_loss_grad_program_plain(trees, X, y, None, ops,
                                                   loss=loss)
    assert torch.equal((b3 == 0) & (trees.length > 0), okm)
    torch.testing.assert_close(l3[okm], lm[okm], rtol=1e-5, atol=0)
    fin = okm.unsqueeze(-1) & torch.isfinite(gm)
    torch.testing.assert_close(g3[fin], gm[fin], rtol=1e-4, atol=1e-4)
    l4, _, _ = tkg.stage_launch(trees, X, y, None, ops, False, 1, loss)(
        trees.cval)
    assert torch.equal(l4[okm], l3[okm])
    if dt == torch.float32:
        lk = tke.eval_loss_trees(trees, X, y, ops, loss)
        lp = tke.eval_loss_trees_plain(trees, X, y, ops, loss)
        f = torch.isfinite(lp)
        assert torch.equal(torch.isfinite(lk), f)
        torch.testing.assert_close(lk[f], lp[f], rtol=1e-4, atol=0)
    sfx = tke.STORAGE[dt][1]
    assert tke.USER_LAUNCHES[f"value{sfx}"] == 1
    assert tki.USER_LAUNCHES == {f"instr{sfx}": 1, f"instr_packed{sfx}": 1}
    assert tkg.USER_LAUNCHES == {f"loss_grad{sfx}": 1, f"loss{sfx}": 1}
    assert sum(tke.LAUNCHES.values()) + sum(tkg.LAUNCHES.values()) == before


@pytest.mark.gpu
@pytest.mark.parametrize("algo", ["NelderMead", "Newton"])
def test_nelder_mead_and_newton_on_card(cuda, custom_pair, algo):
    """A short search over the custom pair under the loss callable with
    each optimizer: its B4 (and Newton's B3) launches from the user build,
    the launch counts of one pass, and a finite hall of fame."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((2, 200)).astype(np.float32)
    y = (2.0 * (np.sin(X[0]) + np.cos(X[0])) + 0.5).astype(np.float32)
    tkg.USER_LAUNCHES.clear()
    res = sr.equation_search(
        X, y, binary_operators=["+", "*", "op2c"],
        unary_operators=["op3c", "cos"], npopulations=4, npop=40,
        ncycles_per_iteration=20, maxsize=10, niterations=1, seed=0,
        verbosity=0, optimizer_algorithm=algo, optimizer_iterations=4,
        loss=lambda p, t: (p - t) ** 2)
    assert np.isfinite(res.best_loss().loss)
    want = ({"loss": 1 + 3 * 4} if algo == "NelderMead"
            else {"loss_grad": 4, "loss": 4})
    assert tkg.USER_LAUNCHES == want


@pytest.mark.gpu
def test_reregistering_rebuilds_on_card(cuda, custom_pair):
    """Re-registering op3c with another function builds and loads another
    library (another header hash), whose values follow the new function."""
    ops = tops.make_operator_set(["+"], ["op3c"])
    X = torch.linspace(-3, 3, 64, device=cuda).reshape(1, 64)
    tree = encode_tree(parse_expression("op3c(x0)", ops), L,
                       device=cuda).map(lambda f: f.unsqueeze(0))
    first = tke.eval_trees(tree, X, ops)[0][0]
    key = tke.user_ops.user_build(ops).key
    tops.register_unary("op3c", lambda x: torch.sin(x) - torch.cos(x))
    assert tke.user_ops.user_build(ops).key != key
    second = tke.eval_trees(tree, X, ops)[0][0]
    torch.testing.assert_close(first, torch.sin(X[0]) + torch.cos(X[0]),
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(second, torch.sin(X[0]) - torch.cos(X[0]),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("max_len", [24, 512, 1024])
def test_float64_builds_bit_equal_to_plain_on_card(cuda, max_len):
    """The float64 builds of B1, the slot mode, B5, B6, B3 and B4 against
    their plain versions (which compute in float64 too) bit for bit, B5/B6
    against B1 and B3's loss against B4's, two launches the same bits; a
    value beyond float32's range stays finite, one beyond float64's and an
    invalid program are poisoned. At max_len 1,024 every kernel takes its
    narrow route."""
    dt = torch.float64
    ops = tops.make_operator_set(["+", "-", "*", "/"], ["cos", "exp"])
    gen = make_generator(3, cuda)
    trees = random_trees(
        gen, torch.randint(1, min(max_len, 24) - 1, (500,), device=cuda), 2,
        ops, max_len, cuda)
    edge = stack_trees([encode_tree(parse_expression(e, ops), max_len,
                                    device=cuda, dtype=dt)
                        for e in ("exp(x1 * 0.0 + 100.0)",
                                  "exp(x1 * 0.0 + 710.0)", "x0 / (x1 - x1)")])
    bad = edge[2:3]._replace(length=edge.length[2:3] + max_len)  # invalid
    trees = TreeBatch(*(torch.cat(z) for z in zip(
        edge, bad, trees._replace(cval=trees.cval.to(dt)))))
    if max_len > 24:
        deep = deep_trees(max_len, 2, device=cuda)
        trees = TreeBatch(*(torch.cat(z) for z in zip(
            trees, deep._replace(cval=deep.cval.to(dt)))))
    X = (torch.rand(2, 777, device=cuda, dtype=dt) * 4 - 2)
    y = torch.rand(777, device=cuda, dtype=dt) * 2
    w = torch.rand(777, device=cuda) + 0.5
    w[:40] = 0.0
    before = dict(tke.STORAGE_LAUNCHES)
    yk, okk = tke.eval_trees(trees, X, ops)
    assert yk.dtype == dt
    assert torch.equal(_bits(tke.eval_trees(trees, X, ops)[0]), _bits(yk))
    ym, badm = tke.eval_program_plain(trees, X, ops)
    assert torch.equal(okk, ~badm & (trees.length > 0))
    assert bool(okk[0]) and float(yk[0, 0]) > 1e43
    assert not okk[1:4].any()
    assert torch.equal(_bits(yk[okk]), _bits(ym[okk]))
    assert tke.STORAGE_LAUNCHES["value_f64"] == before["value_f64"] + 2
    X1 = X[:, :1]
    sk, oks = tke.eval_slot_values(trees, X1, ops)
    sp, okp = tke.eval_slot_values_plain(trees, X1, ops)
    fin = torch.isfinite(sp)
    assert torch.equal(torch.isfinite(sk), fin) and torch.equal(oks, okp)
    assert torch.equal(_bits(sk[fin]), _bits(sp[fin]))
    for packed in (False, True):
        yi, oki = tki.eval_trees_instr(trees, X, ops, packed)
        assert torch.equal(oki, okk)
        assert torch.equal(_bits(yi[okk]), _bits(yk[okk]))
        yip, okip = tki.eval_trees_instr_plain(trees, X, ops, packed)
        assert torch.equal(okip, okk)
        assert torch.equal(_bits(yi[okk]), _bits(yip[okk]))
    for weights in (None, w):
        raw = tkg.stage_launch(trees, X, y, weights, ops, True, 1)
        l3, g3, b3 = raw(trees.cval)
        assert l3.dtype == g3.dtype == dt
        l3b, g3b, _ = raw(trees.cval)
        assert torch.equal(_bits(l3b), _bits(l3))
        assert torch.equal(_bits(g3b), _bits(g3))
        lm, gm, okm = tkg.eval_loss_grad_program_plain(trees, X, y, weights, ops)
        assert torch.equal((b3 == 0) & (trees.length > 0), okm)
        assert torch.equal(_bits(l3[okm]), _bits(lm[okm]))
        assert torch.equal(_bits(g3[okm]), _bits(gm[okm]))
        for reps in (1, 8):
            fn = tkg.stage_launch(trees, X, y, weights, ops, False, reps)
            l4 = fn(trees.cval.repeat_interleave(reps, 0))[0]
            assert torch.equal(_bits(l4.reshape(-1, reps)),
                               _bits(l3.unsqueeze(-1).expand(-1, reps)))


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["float32", "float64"])
def test_cotangent_mode_on_card(cuda, precision):
    """B3's cotangent-seeded mode: bit-equal to its plain mirror and over
    two launches, and within the row-sum yardstick of the lockstep
    interpreter's autograd VJP on the same seeds; one launch, counted in
    VJP_LAUNCHES."""
    from symbolicregression_jl_tpu_torch.ops import interpreter as interp

    dt = getattr(torch, precision)
    ops = tops.make_operator_set(["+", "-", "*", "/"], ["cos", "exp"])
    gen = make_generator(5, cuda)
    trees = random_trees(
        gen, torch.randint(1, 22, (300,), device=cuda), 2, ops, L, cuda)
    trees = trees._replace(cval=trees.cval.to(dt))
    X = (torch.rand(2, 555, device=cuda, dtype=torch.float64) * 4 - 2).to(dt)
    g = (torch.rand(300, 555, device=cuda, dtype=torch.float64) * 2 - 1).to(dt)
    sfx = tke.STORAGE[dt][1]
    before = tkg.VJP_LAUNCHES["vjp" + sfx]
    vk, okk = tkg.eval_vjp_constants(trees, X, g, ops)
    assert tkg.VJP_LAUNCHES["vjp" + sfx] == before + 1
    assert vk.dtype == dt
    assert torch.equal(_bits(tkg.eval_vjp_constants(trees, X, g, ops)[0]),
                       _bits(vk))
    _, vm, okm = tkg.eval_loss_grad_program_plain(trees, X, None, None, ops,
                                                  cot=g)
    assert torch.equal(okk, okm) and 0 < int(okk.sum()) < 300
    assert torch.equal(_bits(vk[okk]), _bits(vm[okk]))
    _, pull = torch.func.vjp(
        lambda c: interp.eval_trees(trees._replace(cval=c), X, ops)[0],
        trees.cval)
    ref = pull(g)[0]
    dy = interp.eval_grad_constants(trees, X, ops)[2]
    yard = (g.unsqueeze(1) * dy).abs().sum(-1)
    m = okk.unsqueeze(-1) & torch.isfinite(ref) & torch.isfinite(yard)
    tol = 1e-5 if dt == torch.float32 else 1e-13
    assert bool(((vk - ref).abs()[m] <= tol * yard[m]).all())


@pytest.mark.gpu
def test_eval_tree_batching_rule_makes_one_launch_on_card(cuda):
    """A custom objective vmapped over 200 trees is one B1 launch;
    vmap(grad) of it one B1 and one cotangent launch, equal to the
    objective's gradient through the lockstep interpreter; eval_tree on one
    tree outside vmap one B1 launch (T = 1)."""
    from symbolicregression_jl_tpu_torch.ops import interpreter as interp

    ops = tops.make_operator_set(["+", "-", "*"], ["cos"])
    gen = make_generator(2, cuda)
    trees = random_trees(
        gen, torch.randint(1, 16, (200,), device=cuda), 2, ops, L, cuda)
    X = torch.rand(2, 300, device=cuda) * 4 - 2
    y = X[0] * X[1] - torch.cos(X[1])

    def objective(tree):
        pred, ok = sr.eval_tree(tree, X, ops)
        return torch.where(ok, ((pred - y) ** 2).mean(), torch.inf)

    def at(fields, c):
        return objective(TreeBatch(*fields[:3], c, fields[4]))

    before = tke.LAUNCHES["value"]
    loss = torch.func.vmap(objective)(trees)
    assert tke.LAUNCHES["value"] == before + 1
    vjp0 = tkg.VJP_LAUNCHES["vjp"]
    grad = torch.func.vmap(torch.func.grad(at, argnums=1))(tuple(trees),
                                                           trees.cval)
    assert tke.LAUNCHES["value"] == before + 2
    assert tkg.VJP_LAUNCHES["vjp"] == vjp0 + 1
    with interp.plain_eval_tree():
        loss_p = torch.func.vmap(objective)(trees)
        grad_p = torch.func.vmap(torch.func.grad(at, argnums=1))(
            tuple(trees), trees.cval)
    f = torch.isfinite(loss_p)
    assert torch.equal(torch.isfinite(loss), f)
    torch.testing.assert_close(loss[f], loss_p[f], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(grad[f], grad_p[f], rtol=1e-3, atol=1e-4)
    one = trees[0]
    pred, ok = sr.eval_tree(one, X, ops)
    assert tke.LAUNCHES["value"] == before + 3 and pred.shape == (300,)


@pytest.mark.gpu
def test_island_batches_in_the_captured_cycle_on_card(cuda):
    """Per-island minibatches: the captured cycle equals the eager loop bit
    for bit, with one scoring launch per island per cycle."""
    cg.clear_cache()
    o, X, y, st = _graph_case(cuda, dict(batching=True, batch_size=30,
                                         independent_island_batches=True))
    _zero_counts()
    a = tevolve.s_r_cycle_islands(st, 12, X, y, None, 1.5, o, ncycles=6)
    assert tke.LAUNCHES["fused"] == 4 * 6
    eager = [dict(c) for c in cg.LAUNCH_COUNTERS]
    _zero_counts()
    b = cg.s_r_cycle_islands_graph(st, 12, X, y, None, 1.5, o, ncycles=6)
    assert [dict(c) for c in cg.LAUNCH_COUNTERS] == eager
    for fa, fb in zip(cg._leaves(a), cg._leaves(b), strict=True):
        assert torch.equal(fa, fb)
    (g,) = cg._CACHE.values()
    assert g.captures == 1 and g.replays == 6
    cg.clear_cache()


@pytest.mark.gpu
def test_float64_and_custom_objective_searches_on_card(cuda):
    """A float64 search launches float64 builds only (its state float64,
    predict float64); a search under a custom objective scores through B1
    (one launch per scoring call, no B2) and fits constants through the
    cotangent mode; an objective that reads the card from the host fails
    at capture, naming the objective."""
    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, (2, 80))
    _zero_counts()
    res = sr.equation_search(X, X[0] * X[0] + 0.5, precision="float64",
                             niterations=1, ncycles_per_iteration=10,
                             return_state=True, **GRAPH_CFG)
    assert not any({**tke.LAUNCHES, **tkg.LAUNCHES, **tki.LAUNCHES}.values())
    assert tke.STORAGE_LAUNCHES["value_f64"] == 1 + 10 + 1
    assert res.state[0].island_states.pop.losses.dtype == torch.float64
    assert res.predict(X).dtype == np.float64

    def objective(tree, X_, y_, w_, options):
        pred, ok = sr.eval_tree(tree, X_, options.operators)
        return torch.where(ok, ((pred - y_) ** 2).mean(), torch.inf)

    Xf = X.astype(np.float32)
    _zero_counts()
    cg.clear_cache()
    res = sr.equation_search(Xf, Xf[0] * Xf[0] + 0.5, loss_function=objective,
                             niterations=1, ncycles_per_iteration=10,
                             **GRAPH_CFG)
    assert tke.LAUNCHES["fused"] == 0 and tkg.VJP_LAUNCHES["vjp"] > 0
    assert np.isfinite(res.best_loss().loss)

    def host_read(tree, X_, y_, w_, options):
        pred, ok = sr.eval_tree(tree, X_, options.operators)
        two = torch.tensor(2.0, device=X_.device)  # a copy from host memory
        return ((pred - y_) ** two).mean()

    cg.clear_cache()
    with pytest.raises(RuntimeError, match="host_read"):
        sr.equation_search(Xf, Xf[0], loss_function=host_read,
                           niterations=1, ncycles_per_iteration=3,
                           **GRAPH_CFG)
    cg.clear_cache()
    torch.cuda.synchronize()


def _draw_plan_cases(dtype):
    """The cycle's and init's draw plans at small widths in ``dtype``, and
    one plan over every kind of op (nested fan-outs, element axes, a
    device bound, kept keys): (plan, root keys, device bounds)."""
    from symbolicregression_jl_tpu_torch.utils import rng as keyrng

    g = np.random.default_rng(3)

    def keys(n):
        return torch.from_numpy(g.integers(0, 2 ** 32, (n, 2),
                                           dtype=np.uint64).astype(np.int64))

    p = keyrng.DrawPlan("mixed", axes=(4, 3))
    k = p.split(p.root, 3)
    f = p.fan(k[1], 1)
    p.keep("f", f)
    p.uniform("u", f, (5,), dtype, -0.75, 3.25)
    p.normal("n", p.child(f, 1), (2,), dtype, axis=2)
    p.gumbel("g", p.child(f, 2), (7,), dtype, axis=2)
    p.bits("b8", k[2], 8, (6,), axis=1)
    p.randint("rd", p.fan(p.child(f, 5), 2), (), -5, "hi")
    return [
        (p, keys(300), {"hi": 17}),
        (tevolve.proposal_plan(12, 200, 6, dtype), keys(8), {}),
        (tevolve.mutation_plan(2, 2, 4, 24, dtype), keys(96), {"hi": 13}),
        (tevolve.crossover_plan(24, dtype), keys(48), {}),
        (tmut.single_plan(tmut.random_tree_draws, 2, 2, 4, 24, dtype),
         keys(500), {}),
    ]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_draw_plans_bit_equal_on_card(cuda, dtype):
    """Each draw plan in one launch of the plan kernel (its float32 or
    float64 instantiation) is bit-equal to the per-call kernels' chain
    (the same epilogue) and to its plain version on the host, but a
    float64 normal or gumbel draw, whose log is CUDA's against the C
    library's: within 1e-11 there, relative to max(|value|, 1) (a last-bit
    difference of log is absolute where gumbel's value nears 0). A 2-byte
    plan is refused on the card."""
    from symbolicregression_jl_tpu_torch.utils import rng as keyrng

    for plan, keys, bounds in _draw_plan_cases(dtype):
        kd = keys.to(cuda)
        bd = {n: torch.tensor(v, device=cuda) for n, v in bounds.items()}
        before = tkr.PLAN_LAUNCHES.get(plan.name, 0)
        got = plan.run(kd, bd)
        assert tkr.PLAN_LAUNCHES[plan.name] == before + 1
        assert plan.compile().mask == (dtype == torch.float64)
        chain = plan.run_per_call(kd, bd)
        plain = plan.run(keys, {n: torch.tensor(v) for n, v in bounds.items()})
        for name in got.names():
            a, c, r = got[name].cpu(), chain[name].cpu(), plain[name]
            assert a.dtype == r.dtype and a.shape == r.shape, name
            view = {torch.float32: torch.int32,
                    torch.float64: torch.int64}.get(a.dtype)
            bits = (lambda t: t.view(view)) if view else (lambda t: t)
            assert torch.equal(bits(a), bits(c)), (plan.name, name)
            kind = plan._draws[plan._names[name]].kind
            if a.dtype == torch.float64 and kind in ("normal", "gumbel"):
                rel = ((a - r).abs() / r.abs().clamp_min(1.0)).max()
                assert float(rel) < 1e-11, (plan.name, name, float(rel))
            else:
                assert torch.equal(bits(a), bits(r)), (plan.name, name)
    half = keyrng.DrawPlan("half")
    half.uniform("u", half.root, (3,), torch.bfloat16)
    with pytest.raises(TypeError, match="float32 and float64 only"):
        half.run(torch.zeros(4, 2, dtype=torch.int64, device=cuda))


# ---------------------------------------------------------------------------
# The constant-fold kernel (simplify_tree in one launch)
# ---------------------------------------------------------------------------

_FOLD_SPECIAL = (0.0, -0.0, 1e30, float("inf"), float("nan"), 300.0,
                 70000.0, 0.1)


def _constant_heavy(trees, gen, dtype=torch.float32):
    """Most variables turned into constants (a tenth of them special
    values), so many subtrees fold, some to a value that is not finite;
    the constants in ``dtype``."""
    shape, dev = trees.kind.shape, trees.kind.device
    flip = (trees.kind == VAR) & (
        torch.rand(shape, generator=gen, device=dev) < 0.7)
    special = torch.tensor(_FOLD_SPECIAL, device=dev)[torch.randint(
        0, len(_FOLD_SPECIAL), shape, generator=gen, device=dev)]
    c = torch.where(torch.rand(shape, generator=gen, device=dev) < 0.1,
                    special, torch.randn(shape, generator=gen, device=dev) * 2)
    return trees._replace(kind=torch.where(flip, CONST, trees.kind),
                          feat=torch.where(flip, 0, trees.feat),
                          cval=torch.where(flip, c, trees.cval).to(dtype))


def _invalid_fold_programs(L, ops, device):
    """Underflow, unfinished, lengths beyond L and below 0, an operator
    outside the set, an unknown kind; then a PAD slot inside the length,
    which the fold reads as a constant 0."""
    rows = [([VAR, BIN], 2), ([CONST, CONST], 2), ([UNA], 1), ([CONST], L + 1),
            ([CONST], -1), ([CONST, CONST, BIN], 3), ([7], 1),
            ([CONST, 0, BIN], 3)]
    kind = torch.tensor([r + [0] * (L - len(r)) for r, _ in rows],
                        device=device)
    op = torch.zeros_like(kind)
    op[5, 2] = ops.n_binary
    return TreeBatch(kind, op, torch.zeros_like(kind),
                     torch.full(kind.shape, 0.75, device=device),
                     torch.tensor([n for _, n in rows], device=device))


def _assert_fold_bit_equal(trees, ops, chunk=4096):
    """The fold kernel against the plain fold on the same card tensors,
    every field and ``changed`` bit for bit, and two launches the same
    bits; returns the kernel's result."""
    got = tke.fold_trees(trees, ops)
    again = tke.fold_trees(trees, ops)
    parts = [tmut.simplify_tree_plain(trees[i:i + chunk], ops)
             for i in range(0, trees.length.shape[0], chunk)]
    ref = (TreeBatch(*(torch.cat(z) for z in zip(*(q[0] for q in parts)))),
           torch.cat([q[1] for q in parts]))
    for res in (again, ref):
        for a, b in zip((*got[0], got[1]), (*res[0], res[1])):
            assert a.dtype == b.dtype and a.shape == b.shape
            if a.is_floating_point():
                a, b = _bits(a), _bits(b)
            assert torch.equal(a, b)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64],
                         ids=["f32", "bf16", "f16", "f64"])
def test_fold_kernel_bit_equal_to_plain_on_card(cuda, dtype):
    """simplify_tree on the card: one launch of the fold kernel (counted
    as ``fold``), every field and ``changed`` bit-equal to the plain fold,
    invalid programs left as they were, the slot-values output bit-equal
    to its plain version where finite."""
    ops = tops.make_operator_set(["+", "-", "*", "/"], ["cos", "exp"])
    gen = make_generator(4, cuda)
    trees = random_trees(gen, torch.randint(1, 21, (3000,), device=cuda,
                                            generator=gen), 2, ops, L, cuda)
    bad = _invalid_fold_programs(L, ops, cuda)
    trees = TreeBatch(*(torch.cat(z) for z in zip(
        _constant_heavy(trees, gen, dtype), bad._replace(
            cval=bad.cval.to(dtype)))))
    key = "fold" + tke.STORAGE[dtype][1]
    counts = tke.LAUNCHES if dtype == torch.float32 else tke.STORAGE_LAUNCHES
    before = counts[key]
    folded, changed = _assert_fold_bit_equal(trees, ops)
    assert counts[key] == before + 2
    assert folded.cval.dtype == dtype
    assert 1500 < int(changed.sum()) < 3000
    assert not changed[-8:-1].any() and bool(changed[-1])
    X1 = torch.zeros((1, 1), dtype=dtype, device=cuda)
    sk, oks = tke.eval_slot_values(trees, X1, ops)
    sp, okp = tke.eval_slot_values_plain(trees, X1, ops)
    fin = torch.isfinite(sp)
    assert torch.equal(oks, okp) and torch.equal(torch.isfinite(sk), fin)
    assert torch.equal(_bits(sk[fin]), _bits(sp[fin]))


@pytest.mark.gpu
@pytest.mark.parametrize("max_len", [512, 1024, 2048])
def test_fold_kernel_long_programs_on_card(cuda, max_len):
    """Long programs: the arenas in shared memory at 512, in global
    memory above (the blocks looping over the trees), bit-equal to the
    plain fold at float32 and float64."""
    ops = tops.make_operator_set(["+", "-", "*", "/"], ["cos", "exp"])
    gen = make_generator(5, cuda)
    trees = random_trees(gen, torch.randint(1, max_len - 2, (48,), device=cuda,
                                            generator=gen), 1, ops, max_len,
                         cuda)
    trees = TreeBatch(*(torch.cat(z) for z in zip(
        trees, deep_trees(max_len, 1, device=cuda))))
    plan = tke.fold_launch_plan(trees.length.shape[0], max_len, torch.float32,
                                None, 0)
    assert (plan.scratch_bytes > 0) == (max_len > 512)
    for dtype in (torch.float32, torch.float64):
        _, changed = _assert_fold_bit_equal(
            _constant_heavy(trees, gen, dtype), ops, chunk=16)
        assert int(changed.sum()) > 24


@pytest.mark.gpu
def test_fold_kernel_with_user_operators_on_card(cuda, custom_pair):
    """The fold kernel's user instantiation (the generated header): the
    structure equal to the plain fold's and the constants within rtol
    1e-5 (the user operators' torch and CUDA bodies may differ in an
    ulp), counted in ``USER_LAUNCHES``."""
    gen = make_generator(6, cuda)
    trees = _constant_heavy(random_trees(
        gen, torch.randint(1, 21, (2000,), device=cuda, generator=gen), 3,
        custom_pair, L, cuda), gen)
    before = tke.USER_LAUNCHES.get("fold", 0)
    got = tke.fold_trees(trees, custom_pair)
    ref = tmut.simplify_tree_plain(trees, custom_pair)
    assert tke.USER_LAUNCHES.get("fold", 0) == before + 1
    for f in ("kind", "op", "feat", "length"):
        assert torch.equal(getattr(got[0], f), getattr(ref[0], f)), f
    assert torch.equal(got[1], ref[1]) and int(got[1].sum()) > 1000
    torch.testing.assert_close(got[0].cval, ref[0].cval, rtol=1e-5, atol=1e-6,
                               equal_nan=True)
