"""The port's symbolic export and import against the JAX package's
(``utils/export.py``): ``to_sympy`` and ``to_latex`` give the same strings,
``from_sympy`` and ``sympy_simplify_tree`` the same encodings, and
``to_callable`` the JAX interpreter's values (rtol 1e-6); the result's
``sympy()`` / ``latex()``; and importing the port does not import sympy."""

import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import sympy

import symbolicregression_jl_tpu as jsr
import symbolicregression_jl_tpu.utils.export as jexport
import symbolicregression_jl_tpu_torch as sr
import symbolicregression_jl_tpu_torch.utils.export as texport

BIN = ["+", "-", "*", "/", "^", "max", "mod"]
UNA = ["cos", "exp", "sqrt", "abs", "log", "square", "neg", "inv", "tanh",
       "sigmoid", "relu", "erf"]
EXPRS = ["2*cos(x3) + x0*x0 - 2", "x0/(x1 + 1.5)", "exp(-x2)*sqrt(abs(x0))",
         "max(x0, x1) - mod(x2, 2.5)", "square(tanh(x1)) ^ 2",
         "neg(inv(x0)) + log(sigmoid(x2))", "relu(x1 - 0.25)*erf(x0)",
         "x0 - x1*x2"]


def _both(s):
    jops = jsr.make_operator_set(BIN, UNA)
    tops = sr.make_operator_set(BIN, UNA)
    je = jsr.parse_expression(s, jops)
    te = sr.parse_expression(s, tops)
    return (jops, jsr.encode_tree(je, 24)), (
        tops, sr.encode_tree(te, 24, device="cpu"))


def _equal_encodings(t, j):
    for f in t._fields:
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)


@pytest.mark.parametrize("s", EXPRS)
def test_to_sympy_and_latex_equal_the_reference(s):
    (jops, jt), (tops, tt) = _both(s)
    assert str(texport.to_sympy(tt, tops)) == str(jexport.to_sympy(jt, jops))
    names = ["a", "b", "c", "d"]
    assert str(texport.to_sympy(tt, tops, names)) == str(
        jexport.to_sympy(jt, jops, names))
    assert texport.to_latex(tt, tops) == jexport.to_latex(jt, jops)


@pytest.mark.parametrize("s", EXPRS)
def test_from_sympy_and_simplify_encode_as_the_reference(s):
    (jops, jt), (tops, tt) = _both(s)
    sym = jexport.to_sympy(jt, jops)
    try:
        je = jexport.from_sympy(sym, jops)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:20]):
            texport.from_sympy(sym, tops)
    else:
        _equal_encodings(sr.encode_tree(texport.from_sympy(sym, tops), 64,
                                        device="cpu"),
                         jsr.encode_tree(je, 64))
    _equal_encodings(texport.sympy_simplify_tree(tt, tops, max_len=24),
                     jexport.sympy_simplify_tree(jt, jops, max_len=24))


def test_from_sympy_rewrites_and_refuses():
    tops = sr.make_operator_set(["+", "-", "*", "/"], ["sqrt"])
    jops = jsr.make_operator_set(["+", "-", "*", "/"], ["sqrt"])
    x0, x1 = sympy.symbols("x0 x1", real=True)
    for e in (x0 - 3 * x1, 1 / x0, x0 ** 3, sympy.sqrt(x1), x0 ** -2,
              sympy.Abs(x0)):
        _equal_encodings(
            sr.encode_tree(texport.from_sympy(e, tops), 24, device="cpu"),
            jsr.encode_tree(jexport.from_sympy(e, jops), 24))
    with pytest.raises(ValueError, match="operator"):
        texport.from_sympy(sympy.cos(x0), tops)


@pytest.mark.parametrize("s", EXPRS)
def test_to_callable_matches_the_jax_interpreter(s):
    """to_callable's values on the CPU (the scoring kernel's plain value
    mode) against the JAX package's eval_tree, rtol 1e-6; non-finite where
    the JAX values are."""
    import torch

    (jops, jt), (tops, tt) = _both(s)
    rng = np.random.default_rng(3)
    X = rng.uniform(0.2, 3.0, (4, 50)).astype(np.float32)
    got = texport.to_callable(tt, tops)(torch.tensor(X)).numpy()
    ref, _ = jsr.eval_tree(jax.tree_util.tree_map(jnp.asarray, jt),
                           jnp.asarray(X), jops)
    ref = np.asarray(ref)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-6, atol=1e-30)


def test_result_sympy_and_latex():
    rng = np.random.default_rng(0)
    X = (rng.standard_normal((2, 40)) * 2).astype(np.float32)
    res = sr.equation_search(
        X, X[0] * X[1], device="cpu", binary_operators=["+", "*"], npop=20,
        npopulations=2, ncycles_per_iteration=20, maxsize=8, niterations=2,
        should_optimize_constants=False, verbosity=0, progress=False,
        variable_names=["u", "v"], seed=0)
    best = res.best()
    assert res.sympy() == texport.to_sympy(best.tree, res.options, ["u", "v"])
    assert res.latex(complexity=best.complexity) == texport.to_latex(
        best.tree, res.options, ["u", "v"])
    f = texport.to_callable(best.tree, res.options, device="cpu")
    np.testing.assert_array_equal(f(X).numpy(), res.predict(X))


def test_to_callable_takes_an_array_to_the_card_by_default(monkeypatch):
    """An array goes to ``device`` (the card by default, which raises
    without one); a tensor keeps its own device."""
    import torch

    (_, _), (tops, tt) = _both(EXPRS[0])
    X = np.random.default_rng(5).uniform(0.2, 3.0, (4, 8)).astype("f4")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    f = texport.to_callable(tt, tops)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        f(X)
    np.testing.assert_array_equal(f(torch.tensor(X)).numpy(),
                                  texport.to_callable(tt, tops, "cpu")(X))


def test_importing_the_port_does_not_import_sympy():
    code = ("import sys, symbolicregression_jl_tpu_torch as s; "
            "from symbolicregression_jl_tpu_torch.utils import export; "
            "assert 'sympy' not in sys.modules and 'jax' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=pathlib.Path(__file__).resolve().parents[1])
