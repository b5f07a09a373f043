"""``equation_search``'s solo surface on the port, on the CPU, at the
reference's TINY sizes (``tests/test_api.py``): the result shaped as the
JAX package's (``candidates[output][rank]``, a ``state`` list,
``on_iteration(output, iteration, candidates)``), multi-output searches
(output j bit-equal to the solo search at ``seed + 7919 * j``), resume
from ``return_state`` (bit-equal to the uninterrupted search) and its
recreate warning, the CSV checkpoint with its ``.out{j}`` variants and the
warm start from it, and the stop conditions; with the bodies of the
reference's ``test_multi_output`` and ``test_early_stop_and_callback`` run
against the port."""

import os
import warnings

import numpy as np
import pytest
import torch

import symbolicregression_jl_tpu_torch as sr
from symbolicregression_jl_tpu_torch.api import EquationSearchResult
from symbolicregression_jl_tpu_torch.models import cycle_graph as cg
from symbolicregression_jl_tpu_torch.utils.output import (
    Candidate, load_hof_csv,
)

TINY = dict(binary_operators=["+", "-", "*"], unary_operators=["cos"],
            npop=24, npopulations=2, ncycles_per_iteration=30, maxsize=12,
            should_optimize_constants=False, verbosity=0, progress=False,
            device="cpu")


def make_data(seed=0, n=60):
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((3, n)) * 2).astype(np.float32)
    y = X[0] * X[0] + 2.0 * np.cos(X[2])
    return X, y


def bits(cands):
    return [(c.complexity, c.loss, c.score, c.equation) for c in cands]


def test_reference_multi_output_body():
    """tests/test_api.py::test_multi_output, on the port."""
    X, y0 = make_data()
    y = np.stack([y0, X[1] * 2.0])
    res = sr.equation_search(X, y, niterations=2, seed=0, **TINY)
    assert len(res.candidates) == 2
    assert res.multi_output
    for out in (0, 1):
        assert len(res.frontier(out)) > 0
        res.predict(X, output=out)


def test_reference_early_stop_and_callback_body():
    """tests/test_api.py::test_early_stop_and_callback, on the port."""
    X, y = make_data()
    seen = []
    sr.equation_search(
        X, y, niterations=10, early_stop_condition=1e3,
        on_iteration=lambda j, it, cands: seen.append(it), seed=0, **TINY)
    assert len(seen) == 1


def test_output_j_is_the_solo_search_at_its_seed():
    """Each output draws from its own generator, seeded seed + 7919 * j,
    and every output replays the same cycle graph with its own data and
    state loaded: output j of a 2-output search equals the solo search at
    seed + 7919 * j bit for bit, and the callback sees the round robin."""
    X, y0 = make_data()
    y = np.stack([y0, np.cos(X[1]) * X[0]])
    calls = []
    cg.clear_cache()
    res = sr.equation_search(X, y, niterations=2, seed=4,
                             on_iteration=lambda j, it, c: calls.append((j, it)),
                             return_state=True, **TINY)
    assert len(cg._CACHE) == 1  # one graph key for both outputs
    assert calls == [(0, 0), (1, 0), (0, 1), (1, 1)]
    assert [s.iteration for s in res.state] == [2, 2]
    for j in range(2):
        solo = sr.equation_search(X, y[j], niterations=2, seed=4 + 7919 * j,
                                  **TINY)
        assert bits(res.frontier(j)) == bits(solo.frontier())
    assert res.num_evals > 0 and res.iterations == 2


def test_resume_continues_the_uninterrupted_search():
    """A 1-iteration search resumed for 1 more from its returned state
    (its generator state included) equals the 2-iteration search bit for
    bit; the saved state is not changed by the resumed search, so a second
    resume from it gives the same result again."""
    X, y = make_data()
    r1 = sr.equation_search(X, y, niterations=1, return_state=True, seed=1,
                            **TINY)
    assert r1.state is not None and len(r1.state) == 1
    assert r1.state[0].iteration == 1
    assert r1.state[0].rng_key.dtype == torch.int64
    assert r1.state[0].rng_key.shape == (2,)
    kept = [t.clone() for t in cg._leaves(r1.state[0].island_states)]
    full = sr.equation_search(X, y, niterations=2, seed=1, **TINY)
    r2 = sr.equation_search(X, y, niterations=1, saved_state=r1.state, seed=1,
                            **TINY)
    assert r2.state is None  # only returned when asked
    assert bits(r2.frontier()) == bits(full.frontier())
    for t, k in zip(cg._leaves(r1.state[0].island_states), kept):
        assert torch.equal(t, k)
    r3 = sr.equation_search(X, y, niterations=1, saved_state=r1.state, seed=1,
                            return_state=True, **TINY)
    assert bits(r3.frontier()) == bits(r2.frontier())
    assert r3.state[0].iteration == 2


def test_resume_mismatched_options_recreates():
    """A saved state whose npop no longer fits is recreated with a warning,
    keeping the saved hall of fame (tests/test_api.py's test of the same
    name); a saved state for another number of outputs raises."""
    X, y = make_data()
    r1 = sr.equation_search(X, y, niterations=1, return_state=True, seed=1,
                            **TINY)
    hof_best = min(c.loss for c in r1.frontier())
    with pytest.warns(UserWarning, match="recreating"):
        r2 = sr.equation_search(X, y, niterations=1, saved_state=r1.state,
                                seed=1, **{**TINY, "npop": 16})
    assert r2.frontier()
    assert min(c.loss for c in r2.frontier()) <= hof_best + 1e-6
    with pytest.raises(ValueError, match="output"):
        sr.equation_search(X, np.stack([y, y]), niterations=1,
                           saved_state=r1.state, **TINY)


def test_checkpoint_csv_and_warm_start(tmp_path):
    """output_file writes the frontier and its .bkup every iteration; the
    reload gives the same equations and complexities; a warm start from it
    keeps the search at least as good; save_to_file=False writes nothing."""
    X, y = make_data()
    path = str(tmp_path / "hof.csv")
    res = sr.equation_search(X, y, niterations=2, seed=1, output_file=path,
                             **TINY)
    assert os.path.exists(path) and os.path.exists(path + ".bkup")
    reloaded = load_hof_csv(path, res.options)
    assert [(c.complexity, c.equation) for c in reloaded] == [
        (c.complexity, c.equation) for c in res.frontier()]
    best1 = min(c.loss for c in res.frontier())
    res2 = sr.equation_search(X, y, niterations=1, warm_start_file=path,
                              seed=99, **TINY)
    assert min(c.loss for c in res2.frontier()) <= best1 + 1e-5
    off = str(tmp_path / "off.csv")
    sr.equation_search(X, y, niterations=1, seed=0, output_file=off,
                       save_to_file=False, **TINY)
    assert not os.path.exists(off) and not os.path.exists(off + ".bkup")
    unreadable = str(tmp_path / "dir.csv")
    os.mkdir(unreadable)
    with pytest.warns(UserWarning, match="could not load"):
        sr.equation_search(X, y, niterations=1, warm_start_file=unreadable,
                           **TINY)


def test_checkpoint_bkup_fallback(tmp_path):
    """A missing or torn main checkpoint falls back to the intact .bkup."""
    X, y = make_data()
    path = str(tmp_path / "hof.csv")
    res = sr.equation_search(X, y, niterations=1, seed=0, output_file=path,
                             **TINY)
    expect = [c.complexity for c in res.frontier()]
    body = open(path).read()
    os.remove(path)
    assert [c.complexity for c in load_hof_csv(path, res.options)] == expect
    with open(path, "w") as f:
        f.write(body[: len(body) // 2].rsplit("\n", 1)[0] + "\n(((")
    assert [c.complexity for c in load_hof_csv(path, res.options)] == expect


def test_multi_output_checkpoints_and_warm_start(tmp_path):
    """Several outputs write base.out{j}.ext, and a warm start reads the
    same names."""
    X, y0 = make_data()
    y = np.stack([y0, X[1] * 2.0])
    path = str(tmp_path / "hof.csv")
    res = sr.equation_search(X, y, niterations=1, seed=2, output_file=path,
                             **TINY)
    assert not os.path.exists(path)
    for j in range(2):
        p = str(tmp_path / f"hof.out{j}.csv")
        assert [(c.complexity, c.equation) for c in
                load_hof_csv(p, res.options)] == [
            (c.complexity, c.equation) for c in res.frontier(j)]
    warm = sr.equation_search(X, y, niterations=1, seed=50,
                              warm_start_file=path, **TINY)
    for j in range(2):
        assert (min(c.loss for c in warm.frontier(j))
                <= min(c.loss for c in res.frontier(j)) + 1e-5)


def test_stop_conditions_end_every_output():
    """The timeout ends the search after the first iteration; max_evals
    counts every output's evaluations; the early stop waits for every
    output to meet it."""
    X, y0 = make_data(n=40)
    y = np.stack([y0, X[1] * 2.0])
    its = []
    sr.equation_search(X, y0, niterations=50, seed=5, timeout_in_seconds=1e-3,
                       on_iteration=lambda j, it, c: its.append(it), **TINY)
    assert its == [0]
    calls = []
    sr.equation_search(X, y, niterations=50, seed=5, max_evals=1,
                       on_iteration=lambda j, it, c: calls.append(j), **TINY)
    assert calls == [0]  # stops as soon as the evaluations pass the cap
    calls = []
    r = sr.equation_search(X, y, niterations=3, seed=5,
                           early_stop_condition=lambda loss, c: False,
                           on_iteration=lambda j, it, c: calls.append(j),
                           **TINY)
    assert calls == [0, 1] * 3 and r.iterations == 3
    calls = []
    sr.equation_search(X, y, niterations=3, seed=5, early_stop_condition=1e9,
                       on_iteration=lambda j, it, c: calls.append(j), **TINY)
    assert calls == [0, 1]


def test_best_picks_score_column_and_result_shape():
    """best() by the score column, best_loss() by loss, per output; repr
    titles each output's table (tests/test_api.py's
    test_best_picks_score_column)."""
    cands = [
        Candidate(complexity=1, loss=1.0, score=0.0, equation="a", tree=None),
        Candidate(complexity=3, loss=0.01, score=2.30, equation="b", tree=None),
        Candidate(complexity=9, loss=0.008, score=0.037, equation="c",
                  tree=None),
    ]
    res = EquationSearchResult(candidates=[cands], options=None,
                               variable_names=None)
    assert res.best().equation == "b" and res.best_loss().equation == "c"
    assert not res.multi_output and res.state is None
    two = EquationSearchResult(candidates=[cands, cands[:1]], options=None,
                               variable_names=None)
    assert two.best(1).equation == "a" and "(output 1)" in repr(two)
    with pytest.raises(ValueError, match="complexity"):
        two._pick(0, 5)


def test_predict_warns_on_domain_violation():
    """tests/test_api.py::test_predict_warns_on_domain_violation, on the
    port's CPU path."""
    opts = sr.make_options(binary_operators=["+"], unary_operators=["log"],
                           maxsize=8)
    tree = sr.encode_tree(sr.parse_expression("log(x0)", opts.operators),
                          opts.max_len, device="cpu")
    cand = Candidate(complexity=2, loss=0.0, score=1.0, equation="log(x0)",
                     tree=tree)
    res = EquationSearchResult(candidates=[[cand]], options=opts,
                               variable_names=None, device=torch.device("cpu"))
    with pytest.warns(RuntimeWarning, match="NaN/Inf"):
        y = res.predict(np.array([[-1.0, 2.0]], dtype=np.float32))
    assert not np.isfinite(y).all()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        y2 = res.predict(np.array([[1.0, 2.0]], dtype=np.float32))
    assert np.isfinite(y2).all()


def test_entry_points_default_to_the_card():
    """Without a card the default device raises instead of running on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    X, y = make_data()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sr.equation_search(X, y, niterations=1,
                           **{k: v for k, v in TINY.items() if k != "device"})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sr.make_dataset(X, y)
