"""Operators and losses of the user's own, from a torch callable to device
code: the port's counterpart of Mosaic lowering the user's ``jnp``
function into the Pallas kernels and of ``jax.vjp`` deriving its adjoint.

A user operator (``register_unary`` / ``register_binary``,
``operators.is_user_operator``) or an elementwise loss callable ``(pred,
target) -> elem`` is traced with ``torch.fx`` (``trace``) and lowered to a
straight-line program (``Program``) over a small table of primitives:

* arithmetic (``+ - * /``, unary minus) and the registry operators
  themselves (``torch.sin`` is ``sin``, ``torch.log`` the registry's
  NaN-guarded ``log``, the port's ``safe_*`` functions their names, ...),
  each computed on the card by the kernels' own device function
  (``csrc/operators.cuh``) and differentiated by its own rule
  (``UNARY_VJP`` / ``BINARY_VJP`` and their device twins);
* comparisons, ``torch.where``, ``logical_and`` / ``or`` / ``not``,
  ``isfinite`` / ``isnan``, ``clamp`` (a ``max`` then a ``min``, as
  ``jnp.clip``), casts (no-ops);
* Python constants, rounded to float32 as JAX rounds its weak-typed
  scalars (kept in double for the float64 build); integer powers
  ``x ** n``, expanded to products as ``lax.integer_pow`` expands them
  (``1 / x ** -n`` for n < 0).

The only new derivative rule is the reverse chain through the program
(``vjp_program``; a ``where`` sends the adjoint to the branch it took). A
primitive outside the table raises ``NotImplementedError`` naming it
(``TraceError``), as soon as a CUDA tensor would need the kernel: at the
operator-id lookup (``check_operators``) or where a loss is staged, never
inside a launch. The CPU path keeps calling the callable itself.

``UserBuild`` is one generated header (``header_text``) for an operator
set's user operators and, optionally, a user loss: it defines the X-macros
``SR_UNARY_USER`` / ``SR_BINARY_USER`` with the new opcodes (unary user
operator k has id ``USER_UNARY_BASE + k``, binary ``USER_BINARY_BASE +
k``, in the set's order), their forward and VJP device functions, and
``user_loss_elem`` / ``user_loss_seed``. The kernel sources include it
when built with ``-DSR_USER_OPS`` and its directory on the include path;
each source and working dtype then has its own library, named by the
header's hash and built at first use into ``build/`` (the wrappers'
``build_storage``). Equal code shares one build; re-registering a name
with another function gives another hash, so another library, another
operator-id table (``kernel_eval.host_operator_ids``) and another
``Options._graph_key`` (``operator_set_key``, ``user_loss_key``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import operator
import pathlib
import re
import threading
import types
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.fx

from . import operators as _ops
from .losses import ElementwiseLoss
from .operators import (
    BINARY_VJP, KERNEL_BINARY_IDS, KERNEL_UNARY_IDS, UNARY_VJP, OperatorSet,
    _BUILTIN_BINARY, _BUILTIN_UNARY, is_user_operator, kernel_fn_of,
)

USER_UNARY_BASE = 64  # kernel id of a set's first unary user operator
USER_BINARY_BASE = 128  # and of its first binary one
# csrc/losses.cuh kUser: the loss id after the registry's 21
USER_LOSS_KIND = 21
HEADER_NAME = "sr_user_ops.cuh"


class TraceError(NotImplementedError):
    """A callable the tracer cannot lower: ``primitive`` names what it
    met."""

    def __init__(self, what: str, primitive: str, why: str = ""):
        self.primitive = primitive
        super().__init__(
            f"{what} cannot run in the CUDA kernels: the tracer "
            f"(ops/user_ops.py) has no rule for {primitive}"
            + (f" ({why})" if why else "")
            + "; it runs on the CPU path only (device='cpu')")


# ---------------------------------------------------------------------------
# The program
# ---------------------------------------------------------------------------


class Node(NamedTuple):
    """One step: ``op`` is "in" (input ``index``), "const" (``value``, the
    Python float: float32's rounding of it in the float builds' code, the
    float itself in the float64 build's), "un" / "bin" (registry operator
    ``name``), "cmp" (``name`` one of gt lt ge le eq ne), "where" (cond,
    a, b), "not", "and", "or", "isfinite", "isnan"; ``args`` index
    earlier steps."""

    op: str
    args: Tuple[int, ...] = ()
    name: str = ""
    value: float = 0.0
    index: int = 0


@dataclasses.dataclass(frozen=True)
class Program:
    """A straight-line program of ``n_inputs`` float inputs and one
    output."""

    nodes: Tuple[Node, ...]
    out: int
    n_inputs: int


_CMP = {operator.gt: "gt", operator.lt: "lt", operator.ge: "ge",
        operator.le: "le", operator.eq: "eq", operator.ne: "ne",
        torch.gt: "gt", torch.lt: "lt", torch.ge: "ge", torch.le: "le",
        torch.eq: "eq", torch.ne: "ne", torch.greater: "gt",
        torch.less: "lt", torch.greater_equal: "ge", torch.less_equal: "le",
        torch.not_equal: "ne"}
_UNARY_EXTRA = {
    torch.log: "log", torch.log2: "log2", torch.log10: "log10",
    torch.log1p: "log1p", torch.sqrt: "sqrt", torch.square: "square",
    torch.neg: "neg", torch.negative: "neg", operator.neg: "neg",
    torch.relu: "relu", torch.asin: "asin", torch.arcsin: "asin",
    torch.acos: "acos", torch.arccos: "acos", torch.acosh: "acosh",
    torch.arccosh: "acosh", torch.arctan: "atan", torch.arcsinh: "asinh",
    torch.sign: "sign", torch.reciprocal: "inv", operator.abs: "abs",
    torch.absolute: "abs", torch.special.expit: "sigmoid",
    torch.special.erf: "erf", torch.special.erfc: "erfc",
}
_BINARY_EXTRA = {
    operator.add: "+", torch.add: "+", operator.sub: "-", torch.sub: "-",
    torch.subtract: "-", operator.mul: "*", torch.mul: "*",
    torch.multiply: "*", operator.truediv: "/", torch.div: "/",
    torch.true_divide: "/", torch.divide: "/", operator.mod: "mod",
    torch.remainder: "mod", torch.arctan2: "atan2",
}
_LOGIC = {operator.and_: "and", torch.logical_and: "and",
          operator.or_: "or", torch.logical_or: "or",
          operator.invert: "not", torch.logical_not: "not",
          torch.isfinite: "isfinite", torch.isnan: "isnan"}
_CASTS = {"float", "to", "type_as", "double", "contiguous"}
_PASS = {operator.pos: "identity", torch.positive: "identity"}


def _function_tables():
    """(unary, binary) maps from a function object's id to its registry
    name: the registry's own functions, then the torch spellings."""
    un = {id(f): n for n, f in _BUILTIN_UNARY.items()}
    un.update({id(f): n for f, n in _UNARY_EXTRA.items()})
    un.update({id(f): n for f, n in _PASS.items()})
    bi = {id(f): n for n, f in _BUILTIN_BINARY.items() if n != "pow"}
    bi.update({id(f): n for f, n in _BINARY_EXTRA.items()})
    return un, bi


_UN_IDS, _BIN_IDS = _function_tables()
_POW = {id(operator.pow), id(torch.pow), id(_ops.safe_pow)}
_MAXMIN = {id(torch.max): "max", id(torch.min): "min"}
_CLAMP = {id(torch.clamp), id(torch.clip)}


def _describe(target) -> str:
    if isinstance(target, str):
        return f"the tensor method .{target}()"
    mod = getattr(target, "__module__", None) or ""
    name = getattr(target, "__qualname__", None) or getattr(
        target, "__name__", repr(target))
    return f"{mod + '.' if mod else ''}{name}"


class _Lowering:
    """Builds the program's nodes, folding nothing: each traced call is
    one step (integer powers several)."""

    def __init__(self, what: str):
        self.what = what
        self.nodes = []

    def add(self, node: Node) -> int:
        self.nodes.append(node)
        return len(self.nodes) - 1

    def const(self, v) -> int:
        return self.add(Node("const", value=float(v)))

    def integer_pow(self, x: int, n: int) -> int:
        """``lax.integer_pow``'s expansion: square-and-multiply, then
        1 / acc for a negative exponent; x ** 0 is 1."""
        if n == 0:
            return self.const(1.0)
        recip, n = n < 0, abs(n)
        acc = None
        while n > 0:
            if n & 1:
                acc = x if acc is None else self.add(Node("bin", (acc, x), "*"))
            n >>= 1
            if n > 0:
                x = self.add(Node("bin", (x, x), "*"))
        return self.add(Node("bin", (self.const(1.0), acc), "/")) if recip else acc

    def fail(self, target, why=""):
        raise TraceError(self.what, _describe(target), why)

    def call(self, target, args, kwargs, env):
        """The step(s) of one traced call."""
        def val(a):
            if isinstance(a, torch.fx.Node):
                return env[a]
            if isinstance(a, (bool, int, float)):
                return self.const(float(a))
            self.fail(target, f"argument {a!r}")

        if isinstance(target, str):  # a tensor method: its torch function
            if target in _CASTS:
                return val(args[0])
            if target in ("clamp", "clip"):
                return self.clamp(val(args[0]), args[1:], kwargs, target, val)
            fn = getattr(torch, target, None)
            if fn is None:
                self.fail(target)
            return self.call(fn, args, kwargs, env)
        tid = id(target)
        if tid in _CLAMP:
            return self.clamp(val(args[0]), args[1:], kwargs, target, val)
        if kwargs:
            self.fail(target, f"keyword arguments {sorted(kwargs)}")
        if target in _CMP and len(args) == 2:
            return self.add(Node("cmp", (val(args[0]), val(args[1])),
                                 _CMP[target]))
        if target in _LOGIC:
            name = _LOGIC[target]
            return self.add(Node(name, tuple(val(a) for a in args)))
        if target is torch.where and len(args) == 3:
            return self.add(Node("where", tuple(val(a) for a in args)))
        if tid in _POW and len(args) == 2:
            e = args[1]
            if isinstance(e, int) and not isinstance(e, bool):
                return self.integer_pow(val(args[0]), e)
            return self.add(Node("bin", (val(args[0]), val(e)), "^"))
        if tid in _MAXMIN and len(args) == 2:
            return self.add(Node("bin", (val(args[0]), val(args[1])),
                                 _MAXMIN[tid]))
        if tid in _UN_IDS and len(args) == 1:
            name = _UN_IDS[tid]
            if name == "identity":
                return val(args[0])
            return self.add(Node("un", (val(args[0]),), name))
        if tid in _BIN_IDS and len(args) == 2:
            return self.add(Node("bin", (val(args[0]), val(args[1])),
                                 _BIN_IDS[tid]))
        self.fail(target)

    def clamp(self, x, rest, kwargs, target, val):
        """``clamp(x, lo, hi)``: ``min(max(x, lo), hi)``, as ``jnp.clip``."""
        lo = kwargs.get("min", rest[0] if len(rest) > 0 else None)
        hi = kwargs.get("max", rest[1] if len(rest) > 1 else None)
        if set(kwargs) - {"min", "max"}:
            self.fail(target, f"keyword arguments {sorted(kwargs)}")
        if lo is not None:
            x = self.add(Node("bin", (x, val(lo)), "max"))
        if hi is not None:
            x = self.add(Node("bin", (x, val(hi)), "min"))
        return x


class _Tracer(torch.fx.Tracer):
    """Keeps the registry's own Python functions (``safe_log``,
    ``square``, ...) as single calls, so each lowers to its operator."""

    def __init__(self):
        super().__init__(autowrap_modules=(math, _ops))


def trace(fn: Callable, n_inputs: int, what: str = "the callable") -> Program:
    """Lower ``fn`` of ``n_inputs`` tensors to a ``Program``; raises
    ``TraceError`` (a ``NotImplementedError``) naming the first primitive
    outside the table."""
    # a fixed signature for the tracer, whatever fn's own, in fn's module:
    # the tracer keeps the registry's functions named there as single calls
    template = ((lambda x0: fn(x0)) if n_inputs == 1
                else (lambda x0, x1: fn(x0, x1)))
    wrapper = types.FunctionType(
        template.__code__, getattr(fn, "__globals__", template.__globals__),
        "traced", None, template.__closure__)
    try:
        graph = _Tracer().trace(wrapper)
    except Exception as e:  # noqa: BLE001 - the tracer's own refusals
        raise TraceError(what, type(e).__name__ + ": " + str(e).split("\n")[0])
    low = _Lowering(what)
    env, out = {}, None
    k = 0
    for n in graph.nodes:
        if n.op == "placeholder":
            env[n] = low.add(Node("in", index=k))
            k += 1
        elif n.op in ("call_function", "call_method"):
            env[n] = low.call(n.target, n.args, n.kwargs, env)
        elif n.op == "output":
            res = n.args[0]
            if isinstance(res, (tuple, list)):
                raise TraceError(what, "a tuple output",
                                 "the callable must return one tensor")
            out = env[res] if isinstance(res, torch.fx.Node) else low.const(res)
        else:
            raise TraceError(what, f"{n.op} {n.target}")
    return Program(tuple(low.nodes), out, n_inputs)


# ---------------------------------------------------------------------------
# The program in PyTorch: its forward and reverse chain (the mirror of the
# generated device code; the tests hold it against jax.vjp)
# ---------------------------------------------------------------------------


_CMP_FN = {"gt": torch.gt, "lt": torch.lt, "ge": torch.ge, "le": torch.le,
           "eq": torch.eq, "ne": torch.ne}


def _forward(prog: Program, inputs):
    like = inputs[0]
    vals = []
    for nd in prog.nodes:
        a = [vals[i] for i in nd.args]
        if nd.op == "in":
            v = inputs[nd.index]
        elif nd.op == "const":
            v = torch.full_like(like, nd.value)
        elif nd.op == "un":
            v = _BUILTIN_UNARY[nd.name](a[0])
        elif nd.op == "bin":
            v = _BUILTIN_BINARY[nd.name](a[0], a[1])
        elif nd.op == "cmp":
            v = _CMP_FN[nd.name](a[0], a[1]).to(like.dtype)
        elif nd.op == "where":
            v = torch.where(a[0] != 0, a[1], a[2])
        elif nd.op == "not":
            v = (a[0] == 0).to(like.dtype)
        elif nd.op == "and":
            v = ((a[0] != 0) & (a[1] != 0)).to(like.dtype)
        elif nd.op == "or":
            v = ((a[0] != 0) | (a[1] != 0)).to(like.dtype)
        elif nd.op == "isfinite":
            v = torch.isfinite(a[0]).to(like.dtype)
        else:  # isnan
            v = torch.isnan(a[0]).to(like.dtype)
        vals.append(v)
    return vals


def vjp_program(prog: Program, inputs, w):
    """(value, adjoint of each input) for the output's adjoint ``w``: the
    reverse chain through the program with each operator's registry rule
    (``UNARY_VJP`` / ``BINARY_VJP``); a node's contributions add in the
    order the reverse walk meets them, the first one taken as it is."""
    vals = _forward(prog, inputs)
    adj = [None] * len(prog.nodes)
    adj[prog.out] = w

    def give(i, d):
        adj[i] = d if adj[i] is None else adj[i] + d

    for i in range(len(prog.nodes) - 1, -1, -1):
        nd, g = prog.nodes[i], adj[i]
        if g is None:
            continue
        if nd.op == "un":
            give(nd.args[0], UNARY_VJP[nd.name](vals[nd.args[0]], vals[i], g))
        elif nd.op == "bin":
            db, da = BINARY_VJP[nd.name](vals[nd.args[0]], vals[nd.args[1]],
                                         vals[i], g)
            give(nd.args[0], db)
            give(nd.args[1], da)
        elif nd.op == "where":
            take = vals[nd.args[0]] != 0
            give(nd.args[1], torch.where(take, g, torch.zeros_like(g)))
            give(nd.args[2], torch.where(take, torch.zeros_like(g), g))
    grads = []
    for k in range(prog.n_inputs):
        at = [i for i, nd in enumerate(prog.nodes)
              if nd.op == "in" and nd.index == k]
        g = adj[at[0]] if at and adj[at[0]] is not None else torch.zeros_like(w)
        grads.append(g)
    return vals[prog.out], grads


# ---------------------------------------------------------------------------
# Device code
# ---------------------------------------------------------------------------


def _lit(v: float, double: bool = False) -> str:
    if double:
        bits = int(np.float64(v).view(np.uint64))
        return f"__longlong_as_double(0x{bits:016x}LL)"
    bits = int(np.float32(v).view(np.uint32))
    return f"__int_as_float(0x{bits:08x})"  # exact, inf and NaN included


def _to_double(text: str) -> str:
    """The float64 build's form of generated device code: ``double`` for
    ``float``, the double round-to-nearest intrinsics, ``1.0`` / ``0.0``
    for ``1.f`` / ``0.f`` (its literals come from ``_lit(v, True)``)."""
    text = re.sub(r"\bfloat\b", "double", text)
    text = re.sub(r"__f(add|sub|mul|div)_rn", r"__d\1_rn", text)
    return re.sub(r"\b([01])\.f\b", r"\1.0", text)


_CMP_C = {"gt": ">", "lt": "<", "ge": ">=", "le": "<=", "eq": "==", "ne": "!="}
# the forward's arithmetic through round-to-nearest intrinsics, so that no
# multiply-add is contracted in any build (the plain versions round each
# operation)
_ARITH_C = {"+": "__fadd_rn", "-": "__fsub_rn", "*": "__fmul_rn",
            "/": "__fdiv_rn"}


def _forward_c(prog: Program, params, double: bool = False):
    """C statements computing every node into t<i>, inputs named by
    ``params`` (constants as ``double``'s literals; the rest is
    ``_to_double``'s)."""
    lines = []
    for i, nd in enumerate(prog.nodes):
        a = [f"t{j}" for j in nd.args]
        if nd.op == "in":
            e = params[nd.index]
        elif nd.op == "const":
            e = _lit(nd.value, double)
        elif nd.op == "un":
            e = f"registry_apply_unary<true>({KERNEL_UNARY_IDS[nd.name]}, {a[0]})"
        elif nd.op == "bin" and nd.name in _ARITH_C:
            e = f"{_ARITH_C[nd.name]}({a[0]}, {a[1]})"
        elif nd.op == "bin":
            e = (f"registry_apply_binary<true>({KERNEL_BINARY_IDS[nd.name]}, "
                 f"{a[0]}, {a[1]})")
        elif nd.op == "cmp":
            e = f"({a[0]} {_CMP_C[nd.name]} {a[1]}) ? 1.f : 0.f"
        elif nd.op == "where":
            e = f"{a[0]} != 0.f ? {a[1]} : {a[2]}"
        elif nd.op == "not":
            e = f"{a[0]} == 0.f ? 1.f : 0.f"
        elif nd.op == "and":
            e = f"({a[0]} != 0.f && {a[1]} != 0.f) ? 1.f : 0.f"
        elif nd.op == "or":
            e = f"({a[0]} != 0.f || {a[1]} != 0.f) ? 1.f : 0.f"
        elif nd.op == "isfinite":
            e = f"isfinite({a[0]}) ? 1.f : 0.f"
        else:
            e = f"{a[0]} != {a[0]} ? 1.f : 0.f"
        lines.append(f"  const float t{i} = {e};")
    return lines


def _reverse_c(prog: Program, w: str):
    """C statements of the reverse chain (``vjp_program``'s order) into
    g<i>; returns (lines, the adjoint expression of each input)."""
    lines = [f"  float g{prog.out} = {w};"]
    have = {prog.out}

    def give(i, d):
        if i in have:
            lines.append(f"  g{i} = __fadd_rn(g{i}, {d});")
        else:
            lines.append(f"  float g{i} = {d};")
            have.add(i)

    for i in range(len(prog.nodes) - 1, -1, -1):
        nd = prog.nodes[i]
        if i not in have:
            continue
        t = [f"t{j}" for j in nd.args]
        if nd.op == "un":
            lines.append(f"  const float d{i} = registry_unary_vjp<true>("
                         f"{KERNEL_UNARY_IDS[nd.name]}, {t[0]}, t{i}, g{i});")
            give(nd.args[0], f"d{i}")
        elif nd.op == "bin":
            lines.append(f"  float dl{i}, dr{i};")
            lines.append(f"  registry_binary_vjp<true>({KERNEL_BINARY_IDS[nd.name]}, "
                         f"{t[0]}, {t[1]}, t{i}, g{i}, &dl{i}, &dr{i});")
            give(nd.args[0], f"dl{i}")
            give(nd.args[1], f"dr{i}")
        elif nd.op == "where":
            give(nd.args[1], f"({t[0]} != 0.f ? g{i} : 0.f)")
            give(nd.args[2], f"({t[0]} != 0.f ? 0.f : g{i})")
    outs = []
    for k in range(prog.n_inputs):
        at = [i for i, nd in enumerate(prog.nodes)
              if nd.op == "in" and nd.index == k]
        outs.append(f"g{at[0]}" if at and at[0] in have else "0.f")
    return lines, outs


def _unary_c(k: int, name: str, prog: Program, double: bool) -> str:
    fwd = _forward_c(prog, ["a"], double)
    rev, (da,) = _reverse_c(prog, "w")
    return "\n".join([
        f"// unary user operator {name!r}",
        f"__device__ __forceinline__ float user_unary_{k}(float a) {{",
        *fwd, f"  return t{prog.out};", "}",
        f"__device__ __forceinline__ float user_unary_vjp_{k}(float a, float, "
        "float w) {", *fwd, *rev, f"  return {da};", "}"])


def _binary_c(k: int, name: str, prog: Program, double: bool) -> str:
    # b = left operand (second stack entry), a = right operand (top), as
    # apply_binary / binary_vjp take them: the callable's (left, right)
    fwd = _forward_c(prog, ["b", "a"], double)
    rev, (db, da) = _reverse_c(prog, "w")
    return "\n".join([
        f"// binary user operator {name!r}",
        f"__device__ __forceinline__ float user_binary_{k}(float b, float a) {{",
        *fwd, f"  return t{prog.out};", "}",
        f"__device__ __forceinline__ void user_binary_vjp_{k}(float b, float a, "
        "float, float w, float* db, float* da) {", *fwd, *rev,
        f"  *db = {db};", f"  *da = {da};", "}"])


def _loss_c(prog: Program, double: bool) -> str:
    fwd = _forward_c(prog, ["p", "t"], double)
    rev, (dp, _) = _reverse_c(prog, "1.f")
    return "\n".join([
        "// the loss: elem(pred, target) and d elem / d pred",
        "__device__ __forceinline__ float user_loss_elem(float p, float t) {",
        *fwd, f"  return t{prog.out};", "}",
        "__device__ __forceinline__ float user_loss_seed(float p, float t) {",
        *fwd, *rev, f"  return {dp};", "}"])


def header_text(unary, binary, loss: Optional[Program],
                double: bool = False) -> str:
    """The generated header for the user operators ``unary`` / ``binary``
    (lists of (name, Program), in the set's order) and the loss program
    (or None). csrc/operators.cuh includes it after the registry's device
    functions, csrc/losses.cuh reads its loss. ``double``: the float64
    build's header, whose device code computes in double."""
    parts = [
        "// Generated by symbolicregression_jl_tpu_torch/ops/user_ops.py from",
        "// traced torch callables: included by csrc/operators.cuh in a build",
        "// with -DSR_USER_OPS.",
        "#pragma once",
        f"#define SR_USER_NUNARY {len(unary)}",
        f"#define SR_USER_NBINARY {len(binary)}",
        f"#define SR_USER_LOSS {1 if loss is not None else 0}",
        "namespace srops {",
        f"constexpr int kUserUnaryBase = {USER_UNARY_BASE};",
        f"constexpr int kUserBinaryBase = {USER_BINARY_BASE};",
    ]
    code = [_unary_c(k, n, p, double) for k, (n, p) in enumerate(unary)]
    code += [_binary_c(k, n, p, double) for k, (n, p) in enumerate(binary)]
    if loss is not None:
        code.append(_loss_c(loss, double))
    parts += [_to_double(c) for c in code] if double else code
    parts.append("}  // namespace srops")

    def xmacro(kind, base, n):
        cases = " ".join(f"X({base + k})" for k in range(n))
        return f"#define SR_{kind}_USER(X) {cases}"

    parts.append(xmacro("UNARY", USER_UNARY_BASE, len(unary)))
    parts.append(xmacro("BINARY", USER_BINARY_BASE, len(binary)))
    parts.append("#define SR_USER_UNARY_CASES "
                 + " ".join(f"case {USER_UNARY_BASE + k}: return "
                            f"user_unary_{k}(a);" for k in range(len(unary))))
    parts.append("#define SR_USER_UNARY_VJP_CASES "
                 + " ".join(f"case {USER_UNARY_BASE + k}: return "
                            f"user_unary_vjp_{k}(a, v, w);"
                            for k in range(len(unary))))
    parts.append("#define SR_USER_BINARY_CASES "
                 + " ".join(f"case {USER_BINARY_BASE + k}: return "
                            f"user_binary_{k}(b, a);"
                            for k in range(len(binary))))
    parts.append("#define SR_USER_BINARY_VJP_CASES "
                 + " ".join(f"case {USER_BINARY_BASE + k}: "
                            f"user_binary_vjp_{k}(b, a, v, w, db, da); return;"
                            for k in range(len(binary))))
    return "\n".join(parts) + "\n"


# ---------------------------------------------------------------------------
# Operators, losses and builds
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_TRACES: Dict[tuple, object] = {}  # (arity, name, fn) -> Program | TraceError
_LOSSES: Dict[object, object] = {}  # callable -> UserLoss | TraceError
_BUILDS: Dict[tuple, "UserBuild"] = {}


_KEYS: Dict[int, tuple] = {}  # id of a Program -> (the Program, its hash)


def _program_key(prog: Program) -> str:
    """The hash of a program's text, memoised (the entry holds the
    program, so its id stays its own)."""
    got = _KEYS.get(id(prog))
    if got is None or got[0] is not prog:
        got = (prog, hashlib.sha256(repr(prog).encode()).hexdigest()[:16])
        _KEYS[id(prog)] = got
    return got[1]


def operator_program(arity: int, name: str) -> Program:
    """The traced program of user operator ``name`` (cached per callable;
    raises ``TraceError``)."""
    fn = kernel_fn_of(arity, name)
    key = (arity, name, fn)
    with _lock:
        got = _TRACES.get(key)
        if got is None:
            try:
                got = trace(fn, arity, f"user operator {name!r}")
            except TraceError as e:
                got = e
            _TRACES[key] = got
    if isinstance(got, TraceError):
        raise got
    return got


def user_operators(operators: OperatorSet):
    """(unary, binary): the set's user operators as (name, arity) in the
    set's order."""
    return ([n for n in operators.unary_names if is_user_operator(1, n)],
            [n for n in operators.binary_names if is_user_operator(2, n)])


def operator_set_key(operators: OperatorSet) -> tuple:
    """What the set's user operators compile to: each one's program hash,
    or its callable's token where it does not trace. Empty for a set of
    registry operators. Part of ``Options._graph_key``."""
    from ..models.options import callable_token

    un, bi = user_operators(operators)
    key = []
    for arity, names in ((1, un), (2, bi)):
        for n in names:
            try:
                key.append((arity, n, _program_key(operator_program(arity, n))))
            except TraceError:
                key.append((arity, n, "untraceable",
                            callable_token(kernel_fn_of(arity, n))))
    return tuple(key)


def check_operators(operators: OperatorSet) -> None:
    """Raise ``TraceError`` for the first user operator of the set that the
    tracer cannot lower (before any launch on a CUDA tensor)."""
    un, bi = user_operators(operators)
    for arity, names in ((1, un), (2, bi)):
        for n in names:
            operator_program(arity, n)


@dataclasses.dataclass(frozen=True, eq=False)
class UserLoss:
    """An elementwise loss callable ``fn(pred, target)`` that traces: the
    kernels run its ``program`` as the loss kind ``USER_LOSS_KIND``; on
    the CPU it is ``fn`` itself, its seed ``torch.func.vjp`` of ``fn``
    (the plain versions' counterpart of ``jax.vjp``). ``program`` is None
    for a callable that does not trace (``plain_loss``: the plain versions
    only)."""

    fn: Callable
    program: Optional[Program]

    kind = USER_LOSS_KIND
    constants = (0.0, 0.0, 0.0)
    name = "UserLoss"

    def constants_of(self, dtype):
        return self.constants

    def __call__(self, pred, target):
        return self.fn(pred, target)

    def seed(self, pred, target):
        """d elem / d pred with cotangent 1."""
        out, pull = torch.func.vjp(lambda p: self.fn(p, target), pred)
        return pull(torch.ones_like(out))[0]

    def __repr__(self):
        return f"UserLoss({self.fn!r})"


def kernel_loss(loss):
    """The loss as the kernels take it: an ``ElementwiseLoss`` or a
    ``UserLoss`` as it is, a traceable callable as its ``UserLoss``
    (cached per callable), an untraceable one as None."""
    if isinstance(loss, (ElementwiseLoss, UserLoss)):
        return loss
    got = _user_loss(loss)
    return None if isinstance(got, TraceError) else got


def require_kernel_loss(loss):
    """``kernel_loss``, raising ``TraceError`` where it would be None."""
    if isinstance(loss, (ElementwiseLoss, UserLoss)):
        return loss
    got = _user_loss(loss)
    if isinstance(got, TraceError):
        raise got
    return got


def plain_loss(loss):
    """The loss as the plain versions take it: ``kernel_loss``, or for a
    callable the tracer cannot lower a ``UserLoss`` without a program (it
    is called, and its seed is ``torch.func.vjp`` of it, as for any
    other)."""
    got = kernel_loss(loss)
    return UserLoss(loss, None) if got is None else got


def _user_loss(fn):
    with _lock:
        got = _LOSSES.get(fn)
        if got is None:
            try:
                got = UserLoss(fn, trace(fn, 2, f"the loss {fn!r}"))
            except TraceError as e:
                got = e
            _LOSSES[fn] = got
    return got


def user_loss_key(loss) -> Optional[str]:
    """The program hash of a traceable loss callable, else None."""
    got = kernel_loss(loss)
    return _program_key(got.program) if isinstance(got, UserLoss) else None


@dataclasses.dataclass(frozen=True, eq=False)
class UserBuild:
    """One generated header: its text and ``key``, the hash that names
    its libraries."""

    key: str
    header: str

    def __hash__(self):
        return hash(self.key)

    def __eq__(self, other):
        return isinstance(other, UserBuild) and other.key == self.key

    def flags(self, build_dir: pathlib.Path) -> Tuple[str, ...]:
        """nvcc's flags for this build, its header written under
        ``build_dir`` (never into csrc/) at first use."""
        d = build_dir / "user" / self.key
        path = d / HEADER_NAME
        if not path.exists() or path.read_text() != self.header:
            d.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{threading.get_ident()}.tmp")
            tmp.write_text(self.header)
            tmp.replace(path)
        return ("-DSR_USER_OPS", "-I", str(d))


def user_build(operators: OperatorSet, loss=None,
               double: bool = False) -> Optional[UserBuild]:
    """The build the kernels need for ``operators`` and ``loss`` (its
    ``kernel_loss``): None when the set has no user operator and the loss
    is a registry one; raises ``TraceError`` for a user operator or loss
    the tracer cannot lower. ``double``: the float64 build's header (its
    own text, so its own hash and libraries)."""
    un, bi = user_operators(operators)
    prog = loss.program if isinstance(loss, UserLoss) else None
    if not un and not bi and prog is None:
        return None
    unary = [(n, operator_program(1, n)) for n in un]
    binary = [(n, operator_program(2, n)) for n in bi]
    ck = (tuple((n, _program_key(p)) for n, p in unary),
          tuple((n, _program_key(p)) for n, p in binary),
          None if prog is None else _program_key(prog), double)
    with _lock:
        got = _BUILDS.get(ck)
        if got is None:
            text = header_text(unary, binary, prog, double)
            got = UserBuild(hashlib.sha256(text.encode()).hexdigest()[:16],
                            text)
            _BUILDS[ck] = got
    return got
