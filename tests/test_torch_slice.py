"""The PyTorch port's first slice as a whole: JAX search state carried
across with ``convert.py`` and advanced by both packages, invariants of the
stochastic modules over many draws, search-level recovery, and the port's
rules (no JAX imports, the card is the default device). The card-only
tests are in ``test_torch_gpu.py``."""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symbolicregression_jl_tpu.models import evolve as jevolve
from symbolicregression_jl_tpu.models import fitness as jfit
from symbolicregression_jl_tpu.models import population as jpop
from symbolicregression_jl_tpu.models.options import make_options as jmake
from symbolicregression_jl_tpu.parallel import migration as jmig
import symbolicregression_jl_tpu_torch as sr
from symbolicregression_jl_tpu_torch import convert
from symbolicregression_jl_tpu_torch.models import constraints as tcons
from symbolicregression_jl_tpu_torch.models import evolve as tevolve
from symbolicregression_jl_tpu_torch.models import fitness as tfit
from symbolicregression_jl_tpu_torch.models import mutate_device as tmut
from symbolicregression_jl_tpu_torch.models import population as tpop
from symbolicregression_jl_tpu_torch.models.trees import is_valid_postfix
from symbolicregression_jl_tpu_torch.ops import kernel_eval as tke
from symbolicregression_jl_tpu_torch.ops import kernel_grad as tkg
from symbolicregression_jl_tpu_torch.ops import kernel_instr as tki
from symbolicregression_jl_tpu_torch.ops import losses as tlosses
from symbolicregression_jl_tpu_torch.ops import operators as tops
from symbolicregression_jl_tpu_torch.parallel import migration as tmig
from symbolicregression_jl_tpu_torch.utils import rng as trng
from torch_port_helpers import island_keys, make_generator, random_trees

from torch_port_helpers import L, assert_trees_equal

REPO = pathlib.Path(__file__).resolve().parents[1]
CFG = dict(binary_operators=["+", "-", "*", "/"], unary_operators=["cos", "exp"],
           npopulations=2, npop=24, maxsize=20)


@pytest.fixture(scope="module")
def carried():
    """A JAX init_island_state (2 islands of 24), its data and options, and
    the same state carried across to the port."""
    rng = np.random.default_rng(4)
    X = rng.uniform(-2, 2, (3, 64)).astype(np.float32)
    y = (np.cos(X[0]) * X[1] - X[2]).astype(np.float32)
    baseline = float(np.mean((y - y.mean()) ** 2))
    jo = jmake(**CFG)
    to = sr.make_options(should_optimize_constants=False, **CFG)
    init = jax.jit(jax.vmap(lambda k: jevolve.init_island_state(
        k, jo, 3, jnp.asarray(X), jnp.asarray(y), None, baseline)))
    jstates = init(jax.random.split(jax.random.PRNGKey(3), 2))
    npstate = jax.tree_util.tree_map(np.asarray, jstates)._asdict()
    tstates = convert.island_state_from_numpy(npstate, "cpu")
    return X, y, baseline, jo, to, jstates, tstates


def _close_trees(ref, got):
    """Structure exact; constants folded through cos/exp may differ by an
    ulp or two between XLA's and torch's CPU math, so cval at rtol 1e-6."""
    for f in ("kind", "op", "feat", "length"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)),
                                      getattr(got, f).numpy(), err_msg=f)
    np.testing.assert_allclose(got.cval.numpy(), np.asarray(ref.cval), rtol=1e-6)


def test_carried_state_round_trips(carried):
    _, _, _, _, _, jstates, tstates = carried
    assert_trees_equal(jstates.pop.trees, tstates.pop.trees)
    np.testing.assert_array_equal(np.asarray(jstates.pop.losses),
                                  tstates.pop.losses.numpy())


@pytest.mark.parametrize("weighted", [False, True])
def test_score_trees_on_carried_population(carried, weighted):
    """Both packages rescore the whole carried population (unweighted:
    the fused-loss path; weighted: value mode + aggregate_loss): rtol 1e-5
    (the row reductions sum in different orders)."""
    X, y, baseline, jo, to, jstates, tstates = carried
    w = np.random.default_rng(9).uniform(0.1, 2.0, X.shape[1]).astype(np.float32)
    flat = jax.tree_util.tree_map(lambda x: x.reshape((-1,) + x.shape[2:]),
                                  jstates.pop.trees)
    s_j, l_j = jax.jit(lambda t: jfit.score_trees(
        t, jnp.asarray(X), jnp.asarray(y), jnp.asarray(w) if weighted else None,
        baseline, jo))(flat)
    s_t, l_t = tfit.score_trees(tstates.pop.trees.map(lambda x: x.reshape((-1,) + x.shape[2:])),
                                torch.tensor(X), torch.tensor(y),
                                torch.tensor(w) if weighted else None,
                                baseline, to)
    for ref, got in ((s_j, s_t), (l_j, l_t)):
        ref = np.asarray(ref)
        np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(ref))
        fin = np.isfinite(ref)
        np.testing.assert_allclose(got.numpy()[fin], ref[fin], rtol=1e-5)


def test_simplify_merge_pareto_on_carried_state(carried):
    X, y, baseline, jo, to, jstates, tstates = carried
    js = jax.jit(lambda s: jevolve.simplify_population_islands(
        s, jnp.int32(20), jnp.asarray(X), jnp.asarray(y), None, baseline, jo))(jstates)
    ts = tevolve.simplify_population_islands(
        tstates, 20, torch.tensor(X), torch.tensor(y), None, baseline, to)
    _close_trees(js.pop.trees, ts.pop.trees)
    for f in ("scores", "losses"):
        np.testing.assert_allclose(getattr(ts.pop, f).numpy(),
                                   np.asarray(getattr(js.pop, f)), rtol=1e-5)
    gj = jax.jit(jmig.merge_hofs_across_islands)(js.hof)
    gt = tmig.merge_hofs_across_islands(ts.hof)
    _close_trees(gj.trees, gt.trees)
    np.testing.assert_array_equal(np.asarray(gj.exists), gt.exists.numpy())
    fin = np.asarray(gj.exists)
    np.testing.assert_allclose(gt.losses.numpy()[fin], np.asarray(gj.losses)[fin],
                               rtol=1e-5)
    np.testing.assert_array_equal(
        np.asarray(jax.jit(jpop.calculate_pareto_frontier)(gj)),
        tpop.calculate_pareto_frontier(gt).numpy())


# ---------------------------------------------------------------------------
# Stochastic modules: invariants over many draws
# ---------------------------------------------------------------------------


def _assert_valid(trees, max_len=L):
    trees = trees.map(lambda x: x.reshape((-1,) + x.shape[trees.length.dim():]))
    n = trees.length
    assert int(n.max()) <= max_len and int(n.min()) >= 1
    pad = torch.arange(trees.max_len) >= n.unsqueeze(-1)
    assert (trees.kind[pad] == 0).all()
    for i in range(n.shape[0]):
        assert is_valid_postfix(trees[i]), i


@pytest.mark.parametrize("seed", [0, 1])
def test_mutations_and_crossover_yield_valid_programs(carried, seed):
    *_, to, _, tstates = carried
    ops = to.operators
    gen = make_generator(seed, "cpu")
    t = tstates.pop.trees.map(lambda x: x.reshape((-1,) + x.shape[2:]))
    base = island_keys(seed, t.kind.shape[0])
    for step in range(6):  # grow, then edit the grown trees
        k = trng.split(trng.fold_in(base, step), 7).unbind(-2)
        t, _ = tmut.append_random_op(k[0], t, 3, ops)
        outs = [
            tmut.mutate_constant(k[1], t, 1.0, 0.076, 0.01)[0],
            tmut.mutate_operator(k[2], t, ops)[0],
            tmut.insert_random_op(k[3], t, 3, ops, at_root=False)[0],
            tmut.insert_random_op(k[4], t, 3, ops, at_root=True)[0],
            tmut.delete_random_op(k[5], t, 3, ops)[0],
            tmut.simplify_tree(t, ops)[0],
            tmut.combine_operators(t, ops)[0],
            *tmut.crossover_trees(k[6], t, t.map(lambda x: x.flip(0)))[:2],
        ]
        for o in outs:
            _assert_valid(o)
    sizes = torch.randint(1, 21, (64,), generator=torch.Generator().manual_seed(seed))
    g = random_trees(gen, sizes, 3, ops, L, "cpu")
    _assert_valid(g)
    assert (g.length <= sizes).all()


def test_proposed_children_respect_maxsize_and_constraints(carried):
    X, y, baseline, _, _, _, tstates = carried
    opts = sr.make_options(should_optimize_constants=False,
                           constraints={"cos": 5, "/": (-1, 3)},
                           nested_constraints={"cos": {"cos": 0}}, **CFG)
    states = tstates
    Xt, yt = torch.tensor(X), torch.tensor(y)
    for _ in range(8):
        prop = tevolve._propose_children(states, 1.0, 9, 3, opts)
        changed = prop.was_mutated | prop.use_cross
        ok = tcons.check_constraints(prop.children, opts, 9)
        assert ok[changed].all()
        _assert_valid(prop.children)
        states = tevolve.reg_evol_cycle_islands(states, 1.0, 9, Xt, yt,
                                                None, baseline, opts)
    _assert_valid(states.pop.trees)


# ---------------------------------------------------------------------------
# Search level
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_equation_search_recovers_constant_free_target_on_cpu(seed):
    """Seeds 0-5 all reach loss 0 within 4 iterations on the CPU; three
    of them run here, each in ~10 s."""
    rng = np.random.default_rng(0)
    X = rng.integers(-3, 4, size=(5, 100)).astype(np.float32)
    y = X[0] * X[0] - X[1] * X[2]
    res = sr.equation_search(
        X, y, device="cpu", binary_operators=["+", "-", "*"],
        should_optimize_constants=False, npopulations=16, npop=100,
        tournament_selection_n=6, ncycles_per_iteration=40, maxsize=12,
        niterations=8, seed=seed,
        early_stop_condition=1e-6, verbosity=0)
    best = res.best_loss()
    assert best.loss < 1e-6, res
    np.testing.assert_allclose(res.predict(X, complexity=best.complexity), y,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "symbolicregression_jl_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    port = REPO / "symbolicregression_jl_tpu_torch"
    assert {port / "ops" / "kernel_grad.py", port / "ops" / "kernel_instr.py",
            port / "models" / "constant_opt.py"} <= set(files)
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "symbolicregression_jl_tpu"), (
                    f"{path} imports {name}")


def test_default_device_is_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.zeros((1, 8), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sr.equation_search(X, X[0], should_optimize_constants=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.trees_from_numpy({f: np.zeros((1, 4)) for f in
                                  ("kind", "op", "feat", "cval")} |
                                 {"length": np.ones(1)})


@pytest.mark.parametrize("kw", [dict(telemetry_every=2),
                                dict(recorder=True),
                                dict(should_optimize_constants=False, row_shards=2),
                                dict(should_optimize_constants=False,
                                     eval_backend="pallas")])
def test_unsupported_options_raise(kw):
    with pytest.raises(NotImplementedError):
        sr.make_options(**kw)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as lying on the card."""

    @property
    def is_cuda(self):
        return True


def test_cuda_tensor_never_takes_the_plain_path(monkeypatch):
    """On a CUDA tensor every wrapper launches its kernel or raises: with
    the library unavailable (checked without a card, on a tensor that
    says it lies on one) the scoring, constant-fold (``fold_trees``, and
    ``simplify_tree`` through it), constant-optimisation and
    instruction-program wrappers raise instead of falling back, under L2
    and under every other loss of the registry (the fused scoring mode,
    the gradient and loss-only kernels, and the scoring route of
    ``fitness``), over a user operator and under a traced loss callable
    too, and in the per-set form (X of several datasets, and per-island
    minibatches); an operator outside the registries has no kernel opcode
    and raises too, and so does a user operator or loss callable that the
    tracer cannot lower, before any launch."""
    ops = tops.make_operator_set(["+", "*"], ["cos", "erf"])
    trees = random_trees(
        make_generator(0, "cpu"), torch.full((6,), 7), 2, ops, L, "cpu")
    X = torch.randn(2, 40).as_subclass(_OnCard)
    y = torch.randn(40)
    # registered into copies of the registries, which the test's end undoes
    monkeypatch.setattr(tops, "UNARY_REGISTRY", dict(tops.UNARY_REGISTRY))
    monkeypatch.setattr(tops, "BINARY_REGISTRY", dict(tops.BINARY_REGISTRY))
    tops.register_binary("op2c", lambda x, y: x * x + 1.0 / (y * y + 0.1))
    tops.register_unary("opfft", lambda x: torch.fft.fft(x).real)
    user_ops_set = tops.make_operator_set(["+", "op2c"], ["cos"])
    user_trees = random_trees(
        make_generator(0, "cpu"), torch.full((6,), 7), 2, user_ops_set, L,
        "cpu")
    user_loss = lambda p, t: (p - t) ** 2  # noqa: E731
    on_card = lambda t: t._replace(cval=t.cval.as_subclass(_OnCard))  # noqa: E731

    def no_library(*args, **kwargs):
        raise RuntimeError("kernel launch attempted")

    def no_plain(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")

    for mod in (tke, tkg, tki):
        monkeypatch.setattr(mod, "_library", no_library)
    for mod, name in ((tke, "eval_trees_plain"), (tke, "eval_loss_trees_plain"),
                      (tke, "eval_slot_values_plain"),
                      (tmut, "simplify_tree_plain"),
                      (tkg, "_plain_loss_grad"),
                      (tki, "eval_trees_instr_plain")):
        monkeypatch.setattr(mod, name, no_plain)
    calls = [lambda: tke.eval_trees(trees, X, ops),
             lambda: tke.eval_loss_trees(trees, X, y, ops),
             lambda: tke.eval_slot_values(trees, X[:, :1], ops),
             lambda: tke.fold_trees(on_card(trees), ops),
             lambda: tmut.simplify_tree(on_card(trees), ops),
             lambda: tkg.eval_loss_grad(trees, X, y, None, ops),
             lambda: tkg.eval_loss(trees, X, y, None, ops),
             lambda: tki.eval_trees_instr(trees, X, ops, packed=False),
             lambda: tki.eval_trees_instr(trees, X, ops, packed=True)]
    for loss in (tlosses.huber_loss(1.0), tlosses.LOSS_REGISTRY["LogCoshLoss"],
                 tlosses.quantile_loss(0.3)):
        calls += [
            lambda loss=loss: tke.eval_loss_trees(trees, X, y, ops, loss),
            lambda loss=loss: tkg.eval_loss_grad(trees, X, y, None, ops,
                                                 loss=loss),
            lambda loss=loss: tkg.eval_loss(trees, X, y, None, ops, loss=loss),
            lambda loss=loss: tfit.eval_loss_trees(trees, X, y, None, ops,
                                                   loss)]
    # the per-set form: 3 datasets of 2 trees each, and the per-island
    # minibatches of one dataset
    X3 = torch.randn(3, 2, 40).as_subclass(_OnCard)
    y3, w3 = torch.randn(3, 40), torch.rand(3, 40)
    rows = torch.randint(0, 40, (3, 10))
    calls += [lambda: tke.eval_trees(trees, X3, ops),
              lambda: tke.eval_loss_trees(trees, X3, y3, ops),
              lambda: tkg.eval_loss_grad(trees, X3, y3, None, ops),
              lambda: tkg.eval_loss_grad(trees, X3, y3, w3, ops),
              lambda: tkg.eval_loss(trees, X3, y3, w3, ops),
              lambda: tfit.eval_loss_trees(trees, X3, y3, None, ops,
                                           "L2DistLoss"),
              lambda: tfit.eval_loss_trees(trees, X3, y3, w3, ops,
                                           "L2DistLoss"),
              lambda: tfit.eval_loss_trees(trees, X, y, None, ops,
                                           "L2DistLoss", row_idx=rows)]
    uo, ut = user_ops_set, user_trees
    calls += [lambda: tke.eval_trees(ut, X, uo),
              lambda: tke.eval_slot_values(ut, X[:, :1], uo),
              lambda: tke.fold_trees(on_card(ut), uo),
              lambda: tki.eval_trees_instr(ut, X, uo, packed=True)]
    for o, t in ((ops, trees), (uo, ut)):
        calls += [
            lambda o=o, t=t: tke.eval_loss_trees(t, X, y, o, user_loss),
            lambda o=o, t=t: tkg.eval_loss_grad(t, X, y, None, o,
                                                loss=user_loss),
            lambda o=o, t=t: tkg.eval_loss(t, X, y, None, o, loss=user_loss),
            lambda o=o, t=t: tfit.eval_loss_trees(t, X, y, None, o,
                                                  user_loss)]
    for call in calls:
        with pytest.raises(RuntimeError, match="kernel launch attempted"):
            call()
    with pytest.raises(NotImplementedError):
        tke.host_operator_ids(tops.OperatorSet(("my_op",), ("+",)))
    fft_ops = tops.make_operator_set(["+"], ["opfft"])
    with pytest.raises(NotImplementedError, match="fft"):
        tke.eval_trees(trees, X, fft_ops)
    bad_loss = lambda p, t: torch.fft.fft(p - t).real  # noqa: E731
    with pytest.raises(NotImplementedError, match="fft"):
        tkg.eval_loss(trees, X, y, None, ops, loss=bad_loss)
    # scoring under it takes the value route (B1), which needs its library
    with pytest.raises(RuntimeError, match="kernel launch attempted"):
        tfit.eval_loss_trees(trees, X, y, None, ops, bad_loss)
