"""The captured cycle (``models/cycle_graph.py``) on the CPU, where it
runs the captured step eagerly on its static buffers: bit-equal to the
eager ``s_r_cycle_islands`` for the same seed (every ``IslandState``
field, ``mut_counts`` included) under a ``curmaxsize`` curriculum and with
batching; a second search at the same widths reuses the cached buffers
and gives the hall of fame of that search run alone; and one eager cycle,
after warm-up, builds no tensor from Python data (each such build is a
copy from host memory, which waits for the card and cannot be captured).
The card's capture and replay are held in ``test_torch_gpu.py``."""

import collections

import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu_torch as sr
import symbolicregression_jl_tpu_torch.api as api
from symbolicregression_jl_tpu_torch.models import cycle_graph as cg
from symbolicregression_jl_tpu_torch.models import evolve as tevolve
from torch_port_helpers import island_keys, make_generator, random_trees

CFG = dict(binary_operators=["+", "-", "*", "/"], unary_operators=["cos"],
           npop=16, npopulations=3, tournament_selection_n=6, maxsize=10,
           should_optimize_constants=False, verbosity=0)


def _data(seed=0, n=30):
    rng = np.random.default_rng(seed)
    X = torch.tensor((rng.standard_normal((2, n)) * 2).astype("f4"))
    return X, X[0] * X[0] - X[1]


def _assert_states_equal(a, b):
    for fa, fb in zip(cg._leaves(a), cg._leaves(b), strict=True):
        assert fa.dtype == fb.dtype and torch.equal(fa, fb)


@pytest.mark.parametrize("kw", [
    dict(annealing=True),
    dict(batching=True, batch_size=8, annealing=True),
    dict(precision="bfloat16", kernel_program="instr"),
], ids=["annealing", "batching", "bf16-instr"])
def test_graph_step_is_the_eager_cycle(kw):
    """Two iterations of 5 cycles each at curmaxsize 4, then 10 (a
    curriculum): the graph path's state equals the eager loop's, field for
    field, the islands' keys included."""
    cg.clear_cache()
    o = sr.make_options(**CFG, **kw)
    X, y = (t.to(o.dtype) for t in _data())
    st0 = tevolve.init_island_state(island_keys(0, 3), o, 2, X, y, None,
                                    1.25)
    a = b = st0
    for cm in (4, 10):
        a = tevolve.s_r_cycle_islands(a, cm, X, y, None, 1.25, o, ncycles=5)
        b = cg.s_r_cycle_islands_graph(b, cm, X, y, None, 1.25, o, ncycles=5)
        _assert_states_equal(a, b)
        assert not torch.equal(a.key, st0.key)
    assert int(a.mut_counts.sum()) > 0
    assert len(cg._CACHE) == 1


def test_search_through_graph_equals_eager_search():
    """``equation_search`` (every cycle through the graph path) and the same
    search with the eager loop in its place, with a warmup_maxsize_by
    curriculum and batching: the same halls of fame and states."""
    X, y = (t.numpy() for t in _data(1, 40))
    kw = dict(CFG, niterations=3, ncycles_per_iteration=6,
              warmup_maxsize_by=0.6, batching=True, batch_size=10, seed=3,
              return_state=True)
    cg.clear_cache()
    a = sr.equation_search(X, y, device="cpu", **kw)
    graph_loop = api.s_r_cycle_islands_graph
    api.s_r_cycle_islands_graph = tevolve.s_r_cycle_islands
    try:
        b = sr.equation_search(X, y, device="cpu", **kw)
    finally:
        api.s_r_cycle_islands_graph = graph_loop
    assert [(c.complexity, c.loss, c.equation) for c in a.frontier()] == [
        (c.complexity, c.loss, c.equation) for c in b.frontier()]
    _assert_states_equal(a.state[0].island_states, b.state[0].island_states)


def test_second_search_reuses_the_graph_buffers():
    """A second search with other data and another alpha and parsimony
    takes the first search's cache entry, and its hall of fame equals that
    search run alone with a cleared cache; the first search's returned
    state is left as it was."""
    kw = dict(CFG, niterations=2, ncycles_per_iteration=5, seed=1,
              annealing=True)
    X1, y1 = (t.numpy() for t in _data(2))
    X2, y2 = (t.numpy() for t in _data(3))
    cg.clear_cache()
    r1 = sr.equation_search(X1, y1, device="cpu", return_state=True, **kw)
    kept = [t.clone() for t in cg._leaves(r1.state[0].island_states)]
    (g,) = cg._CACHE.values()
    r2 = sr.equation_search(X2, y2, device="cpu", alpha=0.4, parsimony=0.01,
                            **kw)
    assert list(cg._CACHE.values()) == [g]
    for t, k in zip(cg._leaves(r1.state[0].island_states), kept):
        assert torch.equal(t, k)
    cg.clear_cache()
    r3 = sr.equation_search(X2, y2, device="cpu", alpha=0.4, parsimony=0.01,
                            **kw)
    assert [(c.complexity, c.loss, c.equation) for c in r2.frontier()] == [
        (c.complexity, c.loss, c.equation) for c in r3.frontier()]


@pytest.mark.parametrize("kw", [
    dict(),
    dict(batching=True, batch_size=8, annealing=True,
         complexity_of_operators={"cos": 2}, kernel_program="instr"),
    dict(precision="float16", kernel_program="instr_packed"),
], ids=["default", "batching-custom-complexity", "f16-packed"])
def test_eager_cycle_builds_no_tensor_from_python_data(kw, monkeypatch):
    o = sr.make_options(**CFG, **kw)
    X, y = (t.to(o.dtype) for t in _data())
    st = tevolve.init_island_state(island_keys(0, 3), o, 2, X, y, None, 1.5)
    st = tevolve.s_r_cycle_islands(st, 10, X, y, None, 1.5, o,
                                   ncycles=1)  # warm-up: fills the tables
    calls = collections.Counter()
    for name in ("tensor", "as_tensor"):
        real = getattr(torch, name)

        def counted(data, *a, _real=real, _name=name, **k):
            if not isinstance(data, torch.Tensor):
                calls[_name] += 1
            return _real(data, *a, **k)

        monkeypatch.setattr(torch, name, counted)
    tevolve.s_r_cycle_islands(st, 10, X, y, None, 1.5, o, ncycles=1)
    assert not calls, dict(calls)
