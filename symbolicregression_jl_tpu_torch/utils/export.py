"""Symbolic export and import (counterpart of
``symbolicregression_jl_tpu/utils/export.py``), host side, never on the
search's path:

    to_sympy(tree, options)        TreeBatch / Expr -> sympy expression
    from_sympy(expr, options)      sympy expression -> Expr (encodable)
    sympy_simplify_tree(tree, ...) round trip through sympy.simplify
    to_latex(tree, options)        LaTeX string
    to_callable(tree, options)     X -> y through the scoring kernel

sympy is imported inside the functions that use it, so importing this
package does not need it; ``to_callable`` does not use it.
"""

from __future__ import annotations

import importlib
from typing import Callable, Optional, Sequence, Union

import torch

from ..models.options import Options
from ..models.trees import (
    BIN, CONST, UNA, VAR, Expr, TreeBatch, decode_tree, encode_tree,
)
from ..ops.operators import OperatorSet
from .device import resolve_device


def _sympy():
    """sympy, imported at the first call that needs it."""
    try:
        return importlib.import_module("sympy")
    except ImportError as e:
        raise ImportError("sympy is required for symbolic export") from e


def _operators(opts: Union[Options, OperatorSet]) -> OperatorSet:
    return opts.operators if isinstance(opts, Options) else opts


def _sympy_tables(s):
    unary = {
        "cos": s.cos,
        "sin": s.sin,
        "tan": s.tan,
        "exp": s.exp,
        "log": s.log,
        "log2": lambda x: s.log(x, 2),
        "log10": lambda x: s.log(x, 10),
        "log1p": lambda x: s.log(x + 1),
        "sqrt": s.sqrt,
        "abs": s.Abs,
        "square": lambda x: x**2,
        "cube": lambda x: x**3,
        "neg": lambda x: -x,
        "relu": lambda x: s.Max(x, 0),
        "sinh": s.sinh,
        "cosh": s.cosh,
        "tanh": s.tanh,
        "asin": s.asin,
        "acos": s.acos,
        "atan": s.atan,
        "asinh": s.asinh,
        "acosh": s.acosh,
        "atanh": s.atanh,
        "erf": s.erf,
        "erfc": s.erfc,
        "gamma": s.gamma,
        "sigmoid": lambda x: 1 / (1 + s.exp(-x)),
        "gauss": lambda x: s.exp(-(x**2)),
        "inv": lambda x: 1 / x,
        "sign": s.sign,
        "identity": lambda x: x,
    }
    binary = {
        "+": lambda a, b: a + b,
        "-": lambda a, b: a - b,
        "*": lambda a, b: a * b,
        "/": lambda a, b: a / b,
        "^": lambda a, b: a**b,
        "pow": lambda a, b: a**b,
        "mod": s.Mod,
        "max": s.Max,
        "min": s.Min,
        "greater": lambda a, b: s.Piecewise((1.0, a > b), (0.0, True)),
        "logical_or": lambda a, b: s.Piecewise(
            (1.0, s.Or(a > 0, b > 0)), (0.0, True)
        ),
        "logical_and": lambda a, b: s.Piecewise(
            (1.0, s.And(a > 0, b > 0)), (0.0, True)
        ),
        "atan2": s.atan2,
    }
    return unary, binary


def to_sympy(tree: Union[TreeBatch, Expr],
             options: Union[Options, OperatorSet],
             variable_names: Optional[Sequence[str]] = None):
    """An expression as a sympy expression; variables are real symbols
    ``x0, x1, ...`` or ``variable_names``, an operator sympy lacks is an
    undefined ``sympy.Function`` of its name."""
    sympy = _sympy()
    ops = _operators(options)
    expr = tree if isinstance(tree, Expr) else decode_tree(tree)
    una_tab, bin_tab = _sympy_tables(sympy)
    names = (variable_names if variable_names is not None
             else [f"x{i}" for i in range(_max_feature(expr) + 1)])
    syms = [sympy.Symbol(n, real=True) for n in names]

    def rec(e: Expr):
        if e.kind == CONST:
            return sympy.Float(e.cval)
        if e.kind == VAR:
            return syms[e.feat]
        if e.kind == UNA:
            name = ops.unary_names[e.op]
            fn = una_tab.get(name) or sympy.Function(name)
            return fn(rec(e.children[0]))
        name = ops.binary_names[e.op]
        fn = bin_tab.get(name) or sympy.Function(name)
        return fn(rec(e.children[0]), rec(e.children[1]))

    return rec(expr)


def _max_feature(expr: Expr) -> int:
    m = expr.feat if expr.kind == VAR else 0
    for c in expr.children:
        m = max(m, _max_feature(c))
    return m


def from_sympy(
    sexpr,
    options: Union[Options, OperatorSet],
    variable_names: Optional[Sequence[str]] = None,
) -> Expr:
    """A sympy expression as an Expr over the operator set's operators
    only (Add with negative terms as ``-``, integer powers as products,
    ``x^-1`` as ``inv`` or ``1/x``, ...). Raises ValueError if the
    expression needs an operator outside the set."""
    sympy = _sympy()
    ops = _operators(options)

    def var_index(name: str) -> int:
        if variable_names is not None and name in variable_names:
            return list(variable_names).index(name)
        if name.startswith("x") and name[1:].isdigit():
            return int(name[1:])
        raise ValueError(f"Unknown variable {name!r}")

    def bin_idx(name: str) -> int:
        try:
            return ops.binary_index(name)
        except ValueError:
            raise ValueError(
                f"Expression requires binary operator {name!r} "
                f"not in operator set {ops.binary_names}"
            )

    def una_idx(name: str) -> int:
        try:
            return ops.unary_index(name)
        except ValueError:
            raise ValueError(
                f"Expression requires unary operator {name!r} "
                f"not in operator set {ops.unary_names}"
            )

    def fold_assoc(name: str, args) -> Expr:
        out = rec(args[0])
        for a in args[1:]:
            out = Expr.binary(bin_idx(name), out, rec(a))
        return out

    def negated(a):
        """If `a` is a negative term, return its positive counterpart."""
        if a.is_Number:
            return -a if a < 0 else None
        if a.is_Mul:
            coeff, rest = a.as_coeff_Mul()
            if coeff < 0:
                return (-coeff) * rest
        return None

    def negate(inner: Expr) -> Expr:
        if "neg" in ops.unary_names:
            return Expr.unary(una_idx("neg"), inner)
        if "-" in ops.binary_names:
            return Expr.binary(bin_idx("-"), Expr.const(0.0), inner)
        if "*" in ops.binary_names:
            return Expr.binary(bin_idx("*"), Expr.const(-1.0), inner)
        raise ValueError("Cannot express negation with operator set")

    def rec(e) -> Expr:
        if e.is_Number:
            return Expr.const(float(e))
        if e.is_Symbol:
            return Expr.var(var_index(str(e)))
        if e.func == sympy.Add:
            # Render negative terms as `a - b` when "-" is available, so
            # Add(x0, Mul(-1, x1)) doesn't require "*" in the set.
            pos, neg = [], []
            for a in e.args:
                nb = negated(a)
                if nb is not None and "-" in ops.binary_names:
                    neg.append(nb)
                else:
                    pos.append(a)
            out = negate(rec(neg.pop(0))) if not pos else fold_assoc("+", pos)
            for b in neg:
                out = Expr.binary(bin_idx("-"), out, rec(b))
            return out
        if e.func == sympy.Mul:
            coeff, rest = e.as_coeff_Mul()
            if coeff == -1 and "*" not in ops.binary_names:
                return negate(rec(rest))
            return fold_assoc("*", e.args)
        if e.func == sympy.Pow:
            base, expo = e.args
            # x^-1 -> inv or 1/x; x^0.5 -> sqrt; small int powers -> mults
            if expo == -1:
                if "inv" in ops.unary_names:
                    return Expr.unary(una_idx("inv"), rec(base))
                if "/" in ops.binary_names:
                    return Expr.binary(
                        bin_idx("/"), Expr.const(1.0), rec(base)
                    )
            if expo == sympy.Rational(1, 2):
                if "sqrt" in ops.unary_names:
                    return Expr.unary(una_idx("sqrt"), rec(base))
            if "^" in ops.binary_names:
                return Expr.binary(bin_idx("^"), rec(base), rec(expo))
            if (
                expo.is_Integer
                and 2 <= int(expo) <= 4
                and "*" in ops.binary_names
            ):
                out = rec(base)
                b = rec(base)
                for _ in range(int(expo) - 1):
                    out = Expr.binary(bin_idx("*"), out, b)
                return out
            if expo.is_Integer and int(expo) < 0 and "/" in ops.binary_names:
                inner = rec(base**(-expo))
                return Expr.binary(bin_idx("/"), Expr.const(1.0), inner)
            raise ValueError(f"Cannot express power {e} with operator set")
        name = e.func.__name__.lower()
        remap = {"abs": "abs", "max": "max", "min": "min"}
        name = remap.get(name, name)
        if len(e.args) == 1:
            # Rewrite fallbacks for operators absent from the set.
            if name == "abs" and "abs" not in ops.unary_names:
                if "sqrt" in ops.unary_names and "*" in ops.binary_names:
                    inner = rec(e.args[0])
                    return Expr.unary(
                        una_idx("sqrt"),
                        Expr.binary(bin_idx("*"), inner, inner),
                    )
            return Expr.unary(una_idx(name), rec(e.args[0]))
        if len(e.args) == 2:
            if name in ("max", "min"):
                return Expr.binary(bin_idx(name), rec(e.args[0]), rec(e.args[1]))
            return Expr.binary(bin_idx(name), rec(e.args[0]), rec(e.args[1]))
        if len(e.args) > 2 and name in ("max", "min"):
            return fold_assoc(name, e.args)
        raise ValueError(f"Cannot convert sympy node {e!r} (func={e.func})")

    return rec(sympy.sympify(sexpr))


def sympy_simplify_tree(tree: Union[TreeBatch, Expr],
                        options: Union[Options, OperatorSet],
                        variable_names: Optional[Sequence[str]] = None,
                        max_len: Optional[int] = None,
                        device=None) -> TreeBatch:
    """tree -> sympy.simplify -> tree; the original tree where the
    simplified form needs an operator outside the set or does not fit
    ``max_len``. The result lies on ``device``: by default a TreeBatch's
    own device, and the card for an Expr."""
    sympy = _sympy()
    ops = _operators(options)
    if max_len is None:
        max_len = (options.max_len if isinstance(options, Options)
                   else (tree.max_len if isinstance(tree, TreeBatch) else 64))
    if device is None:
        device = tree.kind.device if isinstance(tree, TreeBatch) else "cuda"
    orig = tree if isinstance(tree, Expr) else decode_tree(tree)
    try:
        simplified = sympy.simplify(to_sympy(orig, ops, variable_names))
        expr = from_sympy(simplified, ops, variable_names)
        if expr.size() > max_len:
            expr = orig
    except (ValueError, TypeError, OverflowError):
        expr = orig
    return encode_tree(expr, max_len, device=device)


def to_latex(tree: Union[TreeBatch, Expr],
             options: Union[Options, OperatorSet],
             variable_names: Optional[Sequence[str]] = None) -> str:
    """LaTeX form of an expression (sympy's printer)."""
    return _sympy().latex(to_sympy(tree, options, variable_names))


def to_callable(tree: TreeBatch, options: Union[Options, OperatorSet],
                device="cuda") -> Callable:
    """``f(X) -> y`` for a single tree, through the scoring kernel's value
    mode (``kernel_eval``): the CUDA kernel for a CUDA tensor, its plain
    version for a CPU one. X (nfeat, n) is a tensor, which keeps its own
    device and dtype, or an array, which goes to ``device`` in the tree's
    constant dtype; y (n,) lies on X's device in X's dtype."""
    from ..ops import kernel_eval

    ops = _operators(options)
    moved = {}

    def f(X):
        if not isinstance(X, torch.Tensor):
            X = torch.as_tensor(X, dtype=tree.cval.dtype,
                                device=resolve_device(device))
        key = (X.device, X.dtype)
        if key not in moved:
            moved[key] = tree.map(lambda x: x.to(X.device).unsqueeze(0))
            moved[key] = moved[key]._replace(cval=moved[key].cval.to(X.dtype))
        y, _ = kernel_eval.eval_trees(moved[key], X, ops)
        return y[0]

    return f
