"""The PyTorch port on a CUDA card: the kernel in every mode against its
plain version, each operator the kernel carries on the edge grid, and a
short search. Marked ``gpu``; each skips without a card (decided in a
fixture, so every test worker collects the same tests).

This file imports neither JAX nor the JAX package, because the machine
with the card has no JAX; ``tests/conftest.py`` imports JAX, so run it
there without the conftest:

    python -m pytest tests/test_torch_gpu.py -m gpu -q --noconftest
"""

import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu_torch as sr
from symbolicregression_jl_tpu_torch.models import mutate_device as tmut
from symbolicregression_jl_tpu_torch.models.trees import BIN, UNA, VAR, TreeBatch
from symbolicregression_jl_tpu_torch.ops import kernel_eval as tke
from symbolicregression_jl_tpu_torch.ops import operators as tops
from symbolicregression_jl_tpu_torch.utils.rng import make_generator

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
    trees = tmut.gen_random_tree_fixed_size(
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
    before = tke.LAUNCHES["fused_l2"]
    res = sr.equation_search(
        X, y, binary_operators=["+", "-", "*"], should_optimize_constants=False,
        npopulations=16, npop=100, tournament_selection_n=6,
        ncycles_per_iteration=40, maxsize=12, niterations=2, seed=0,
        verbosity=0)
    assert tke.LAUNCHES["fused_l2"] - before >= 2 * 40
    assert res.candidates and np.isfinite(res.best_loss().loss)
