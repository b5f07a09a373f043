"""Per-island minibatches (``Options.independent_island_batches``) on the
port against the JAX package: each island's children scored on its own
rows (``fitness.score_trees_islands``) against the reference's
``jax.vmap`` of ``score_trees`` over islands for the same (islands, batch)
``row_idx``, on the fused route and on the value route (within rtol 1e-6:
the gathered rows and each row's value are the same, the mean over a
minibatch is summed in another order); the cycle step's draw of one
minibatch per island in one generator call and its ``num_evals``
accounting (the reference's ``evolve.py:542``); the captured step equal to
the eager loop on the CPU; and the reference's
``tests/test_api.py::test_independent_island_batches`` body on
``device="cpu"``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symbolicregression_jl_tpu.models import fitness as jfit
from symbolicregression_jl_tpu.models.options import make_options as jmake
import symbolicregression_jl_tpu_torch as sr
from symbolicregression_jl_tpu_torch.models import cycle_graph as cg
from symbolicregression_jl_tpu_torch.models import evolve as tevolve
from symbolicregression_jl_tpu_torch.models import fitness as tfit
from symbolicregression_jl_tpu_torch.ops import kernel_eval as tke
from torch_port_helpers import island_keys, make_generator, random_trees

from torch_port_helpers import jax_trees, port_trees

KW = dict(binary_operators=["+", "-", "*", "/"], unary_operators=["cos"],
          verbosity=0, progress=False)
I, B, BATCH = 3, 12, 20


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    jops = jmake(**KW).operators
    jt = jax_trees(rng, jops, I * B, 2, max_size=14)
    children = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a).reshape((I, B) + a.shape[1:]), jt)
    X = rng.uniform(-2, 2, (2, 64)).astype(np.float32)
    y = (X[0] * X[0] - np.cos(X[1])).astype(np.float32)
    w = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    idx = rng.integers(0, 64, (I, BATCH)).astype(np.int32)
    tt = port_trees(jt).map(lambda f: f.reshape((I, B) + f.shape[1:]))
    return children, tt, X, y, w, idx


@pytest.mark.parametrize("route", ["fused", "value"])
def test_per_island_scoring_matches_jax(case, route):
    children, tt, X, y, w, idx = case
    weights = w if route == "value" else None  # a weighted call takes B1
    jo, to = jmake(**KW), sr.make_options(**KW)
    jw = None if weights is None else jnp.asarray(weights)
    js, jl = jax.vmap(lambda ch, ri: jfit.score_trees(
        ch, jnp.asarray(X), jnp.asarray(y), jw, 1.7, jo, ri))(
            children, jnp.asarray(idx))
    ts, tl = tfit.score_trees_islands(
        tt, torch.tensor(X), torch.tensor(y),
        None if weights is None else torch.tensor(weights), 1.7, to,
        torch.tensor(idx, dtype=torch.int64))
    assert ts.shape == tl.shape == (I, B)
    for got, ref in ((tl, jl), (ts, js)):
        got, ref = got.numpy(), np.asarray(ref)
        np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
        fin = np.isfinite(ref)
        assert fin.sum() > I * B // 2
        np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-6)
    # each island's losses are those of its own minibatch, scored alone
    for i in range(I):
        Xi, yi = torch.tensor(X)[:, idx[i]], torch.tensor(y)[idx[i]]
        wi = None if weights is None else torch.tensor(weights)[idx[i]]
        _, li = tfit.score_trees(tt[i], Xi, yi, wi, 1.7, to)
        assert torch.equal(li, tl[i])


def test_cycle_step_draws_a_minibatch_per_island():
    o = sr.make_options(npop=24, npopulations=I, batching=True,
                        batch_size=BATCH, independent_island_batches=True,
                        tournament_selection_n=6, maxsize=10, **KW)
    rng = np.random.default_rng(1)
    X = torch.tensor(rng.uniform(-2, 2, (2, 80)).astype(np.float32))
    y = X[0] * X[1]
    st = tevolve.init_island_state(island_keys(3, I), o, 2, X, y, None, 1.0)
    drawn = []
    real = tfit.next_minibatch

    def spy(*a, **k):
        out = real(*a, **k)
        drawn.append(out[0])
        return out

    scored = []
    real_score = tevolve.score_trees_islands

    def score_spy(trees, *a, **k):
        scored.append(trees.length.shape)
        return real_score(trees, *a, **k)

    tevolve.next_minibatch, tevolve.score_trees_islands = spy, score_spy
    try:
        new, _ = tevolve.cycle_step(st, tevolve.batch_key(st),
                                    torch.tensor(1.0), torch.tensor(10), X, y,
                                    None, torch.tensor(1.0),
                                    tevolve.bind_device_scalars(o, "cpu"))
    finally:
        tevolve.next_minibatch, tevolve.score_trees_islands = real, real_score
    assert len(drawn) == 1 and drawn[0].shape == (I, BATCH)
    assert int(drawn[0].min()) >= 0 and int(drawn[0].max()) < 80
    n_b = o.n_parallel_tournaments + o.n_parallel_tournaments % 2
    assert scored == [(I, n_b)]
    # the reference's accounting: batch_size / n_rows per child
    np.testing.assert_allclose((new.num_evals - st.num_evals).numpy(),
                               n_b * BATCH / 80, rtol=1e-6)


def test_captured_step_equals_the_eager_loop_on_cpu():
    o = sr.make_options(npop=24, npopulations=I, batching=True,
                        batch_size=BATCH, independent_island_batches=True,
                        tournament_selection_n=6, maxsize=10, **KW)
    rng = np.random.default_rng(2)
    X = torch.tensor(rng.uniform(-2, 2, (2, 80)).astype(np.float32))
    y = X[0] - torch.cos(X[1])
    st = tevolve.init_island_state(island_keys(0, I), o, 2, X, y, None, 1.0)
    cg.clear_cache()
    a = tevolve.s_r_cycle_islands(st, 10, X, y, None, 1.0, o, ncycles=4)
    b = cg.s_r_cycle_islands_graph(st, 10, X, y, None, 1.0, o, ncycles=4)
    cg.clear_cache()
    for fa, fb in zip(cg._leaves(a), cg._leaves(b), strict=True):
        assert torch.equal(fa, fb)
    assert not torch.equal(a.key, st.key)
    assert tke.LAUNCHES == {"value": 0, "fused": 0, "fold": 0}  # CPU


def test_independent_island_batches():
    """The reference's tests/test_api.py::test_independent_island_batches
    body (its make_data and TINY), on device="cpu"."""
    rng = np.random.default_rng(0)
    X = (rng.standard_normal((3, 60)) * 2).astype(np.float32)
    y = X[0] * X[0] + 2.0 * np.cos(X[2])
    res = sr.equation_search(
        X, y, niterations=2, batching=True, batch_size=20,
        independent_island_batches=True, seed=0, runtests=False,
        binary_operators=["+", "-", "*"], unary_operators=["cos"], npop=24,
        npopulations=2, ncycles_per_iteration=30, maxsize=12,
        should_optimize_constants=False, verbosity=0, progress=False,
        device="cpu")
    assert len(res.frontier()) > 0
    assert np.isfinite(res.best_loss().loss)
