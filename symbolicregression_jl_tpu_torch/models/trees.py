"""Flat postfix expression encoding, on torch tensors.

Counterpart of ``symbolicregression_jl_tpu/models/trees.py``. An
expression is a fixed-width postfix program; every subtree is a contiguous
span ``[i - size(i) + 1, i]``. The node codes ``PAD/CONST/VAR/UNA/BIN`` and
the operator numbering are the JAX package's, so trees carry across the two
packages unchanged.

Integer fields are int64 (torch's index type); ``cval`` is in the
working dtype (``Options.dtype``: float32, bfloat16 or float16). The
device-side queries (``subtree_sizes``, ``node_depths``) are written as
whole-tensor comparisons over the (slot, slot) square instead of a scan
over slots, so each is a handful of launches for any batch size.
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.operators import INFIX, OperatorSet
from ..utils.device import resolve_device, table

PAD = 0
CONST = 1
VAR = 2
UNA = 3
BIN = 4

ARITY = np.array([0, 0, 0, 1, 2], dtype=np.int64)  # indexed by kind


class TreeBatch(NamedTuple):
    """A batch of postfix trees. kind/op/feat: (..., L) int64; cval:
    (..., L) in the working dtype; length: (...,) int64."""

    kind: torch.Tensor
    op: torch.Tensor
    feat: torch.Tensor
    cval: torch.Tensor
    length: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.kind.shape[-1]

    def __getitem__(self, idx) -> "TreeBatch":
        return TreeBatch(*(f[idx] for f in self))

    def map(self, fn) -> "TreeBatch":
        return TreeBatch(*(fn(f) for f in self))


def where_trees(cond: torch.Tensor, a: TreeBatch, b: TreeBatch) -> TreeBatch:
    """Per-tree select: ``cond`` has the trees' batch shape."""
    c2 = cond.unsqueeze(-1)
    return TreeBatch(
        torch.where(c2, a.kind, b.kind),
        torch.where(c2, a.op, b.op),
        torch.where(c2, a.feat, b.feat),
        torch.where(c2, a.cval, b.cval),
        torch.where(cond, a.length, b.length),
    )


def empty_trees(batch_shape: Tuple[int, ...], max_len: int,
                device="cuda", dtype: torch.dtype = torch.float32) -> TreeBatch:
    """Empty trees, constants in ``dtype``."""
    dev = resolve_device(device)
    shape = tuple(batch_shape) + (max_len,)
    z = torch.zeros(shape, dtype=torch.int64, device=dev)
    return TreeBatch(z, z.clone(), z.clone(),
                     torch.zeros(shape, dtype=dtype, device=dev),
                     torch.zeros(tuple(batch_shape), dtype=torch.int64,
                                 device=dev))


def stack_trees(trees: Sequence[TreeBatch]) -> TreeBatch:
    return TreeBatch(*(torch.stack(fs) for fs in zip(*trees)))


# ---------------------------------------------------------------------------
# Host-side expression objects (construction, printing, tests)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Expr:
    kind: int
    op: int = 0
    feat: int = 0
    cval: float = 0.0
    children: Tuple["Expr", ...] = ()

    @staticmethod
    def const(v: float) -> "Expr":
        return Expr(kind=CONST, cval=float(v))

    @staticmethod
    def var(i: int) -> "Expr":
        return Expr(kind=VAR, feat=int(i))

    @staticmethod
    def unary(op: int, child: "Expr") -> "Expr":
        return Expr(kind=UNA, op=int(op), children=(child,))

    @staticmethod
    def binary(op: int, left: "Expr", right: "Expr") -> "Expr":
        return Expr(kind=BIN, op=int(op), children=(left, right))

    def size(self) -> int:
        return 1 + sum(c.size() for c in self.children)

    def postfix(self) -> List["Expr"]:
        out: List[Expr] = []
        for c in self.children:
            out.extend(c.postfix())
        out.append(self)
        return out


def encode_tree(expr: Expr, max_len: int, device="cuda",
                dtype: torch.dtype = torch.float32) -> TreeBatch:
    """Expr -> single postfix TreeBatch (batch shape ()), its constants
    float32 (float64 with ``dtype`` float64)."""
    dev = resolve_device(device)
    nodes = expr.postfix()
    n = len(nodes)
    if n > max_len:
        raise ValueError(f"Expression size {n} exceeds max_len {max_len}")
    kind = np.zeros(max_len, np.int64)
    op = np.zeros(max_len, np.int64)
    feat = np.zeros(max_len, np.int64)
    cval = np.zeros(max_len, np.float64 if dtype == torch.float64
                    else np.float32)
    for i, nd in enumerate(nodes):
        kind[i], op[i], feat[i], cval[i] = nd.kind, nd.op, nd.feat, nd.cval
    return TreeBatch(
        torch.from_numpy(kind).to(dev), torch.from_numpy(op).to(dev),
        torch.from_numpy(feat).to(dev), torch.from_numpy(cval).to(dev),
        torch.tensor(n, dtype=torch.int64, device=dev),
    )


def decode_tree(tree: TreeBatch) -> Expr:
    """Single postfix TreeBatch (batch shape ()) -> Expr. Validates arity."""
    kind, op, feat, cval = (np.asarray(torch.as_tensor(f).cpu())
                            for f in (tree.kind, tree.op, tree.feat,
                                      torch.as_tensor(tree.cval).double()))
    n = int(tree.length)
    stack: List[Expr] = []
    for i in range(n):
        k = int(kind[i])
        if k == CONST:
            stack.append(Expr.const(float(cval[i])))
        elif k == VAR:
            stack.append(Expr.var(int(feat[i])))
        elif k == UNA:
            if not stack:
                raise ValueError(f"Invalid postfix: unary at {i} with empty stack")
            stack.append(Expr.unary(int(op[i]), stack.pop()))
        elif k == BIN:
            if len(stack) < 2:
                raise ValueError(f"Invalid postfix: binary at {i} with stack<2")
            b = stack.pop()
            a = stack.pop()
            stack.append(Expr.binary(int(op[i]), a, b))
        elif k == PAD:
            raise ValueError(f"PAD inside valid region at slot {i}")
        else:
            raise ValueError(f"Bad kind {k} at slot {i}")
    if len(stack) != 1:
        raise ValueError(f"Invalid postfix: stack size {len(stack)} at end")
    return stack[0]


def is_valid_postfix(tree: TreeBatch) -> bool:
    try:
        decode_tree(tree)
        return True
    except ValueError:
        return False


def _format_const(v: float) -> str:
    return f"{v:.6g}"


def expr_to_string(expr: Expr, operators: OperatorSet,
                   variable_names: Optional[Sequence[str]] = None) -> str:
    def vname(i: int) -> str:
        return variable_names[i] if variable_names is not None else f"x{i}"

    def rec(e: Expr) -> str:
        if e.kind == CONST:
            return _format_const(e.cval)
        if e.kind == VAR:
            return vname(e.feat)
        if e.kind == UNA:
            return f"{operators.unary_names[e.op]}({rec(e.children[0])})"
        name = operators.binary_names[e.op]
        l, r = rec(e.children[0]), rec(e.children[1])
        if name in INFIX:
            return f"({l} {name} {r})"
        return f"{name}({l}, {r})"

    return rec(expr)


def tree_to_string(tree: TreeBatch, operators: OperatorSet,
                   variable_names: Optional[Sequence[str]] = None) -> str:
    return expr_to_string(decode_tree(tree), operators, variable_names)


def parse_expression(s: str, operators: OperatorSet,
                     variable_names: Optional[Sequence[str]] = None) -> Expr:
    """Infix string -> Expr: ``+ - * / ^`` with standard precedence,
    function calls, unary minus, floats and variable names (default
    ``x0, x1, ...``) — the grammar ``expr_to_string`` prints."""
    tokens = re.findall(r"[A-Za-z_][A-Za-z_0-9]*|\d+\.?\d*(?:[eE][+-]?\d+)?|\S", s)
    pos = 0

    def peek() -> Optional[str]:
        return tokens[pos] if pos < len(tokens) else None

    def take() -> str:
        nonlocal pos
        t = tokens[pos]
        pos += 1
        return t

    def var_index(name: str) -> Optional[int]:
        if variable_names is not None and name in variable_names:
            return list(variable_names).index(name)
        m = re.fullmatch(r"x(\d+)", name)
        if m and variable_names is None:
            return int(m.group(1))
        return None

    def expect(tok: str) -> None:
        got = take() if pos < len(tokens) else "<eof>"
        if got != tok:
            raise ValueError(f"Expected {tok!r}, got {got!r} in {s!r}")

    def parse_primary() -> Expr:
        if pos >= len(tokens):
            raise ValueError(f"Unexpected end of expression in {s!r}")
        t = take()
        if t == "(":
            e = parse_sum()
            expect(")")
            return e
        if t == "-":
            child = parse_primary()
            if child.kind == CONST:
                return Expr.const(-child.cval)
            try:
                return Expr.unary(operators.unary_index("neg"), child)
            except ValueError:
                return Expr.binary(operators.binary_index("-"),
                                   Expr.const(0.0), child)
        if re.fullmatch(r"\d+\.?\d*(?:[eE][+-]?\d+)?", t):
            return Expr.const(float(t))
        if peek() == "(":
            take()
            args = [parse_sum()]
            while peek() == ",":
                take()
                args.append(parse_sum())
            expect(")")
            if len(args) == 1:
                return Expr.unary(operators.unary_index(t), args[0])
            return Expr.binary(operators.binary_index(t), args[0], args[1])
        vi = var_index(t)
        if vi is None:
            raise ValueError(f"Unknown identifier {t!r}")
        return Expr.var(vi)

    def parse_power() -> Expr:
        base = parse_primary()
        if peek() == "^":
            take()
            return Expr.binary(operators.binary_index("^"), base, parse_power())
        return base

    def parse_product() -> Expr:
        e = parse_power()
        while peek() in ("*", "/"):
            t = take()
            e = Expr.binary(operators.binary_index(t), e, parse_power())
        return e

    def parse_sum() -> Expr:
        e = parse_product()
        while peek() in ("+", "-"):
            t = take()
            e = Expr.binary(operators.binary_index(t), e, parse_product())
        return e

    out = parse_sum()
    if pos != len(tokens):
        raise ValueError(f"Trailing tokens: {tokens[pos:]}")
    return out


# ---------------------------------------------------------------------------
# Device-side structural queries (batched over leading dims, no host sync)
# ---------------------------------------------------------------------------


def _arity(kind: torch.Tensor) -> torch.Tensor:
    return table(tuple(ARITY.tolist()), kind.device)[kind]


def subtree_starts(kind: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """First slot of the subtree rooted at each slot: ``s_i`` is the last
    ``j <= i`` whose stack depth before it is below the depth after ``i``
    (every slot strictly inside the span sits at least one level higher).
    (..., L) int64; -1 on PAD slots."""
    L = kind.shape[-1]
    idx = torch.arange(L, device=kind.device)
    valid = idx < length.unsqueeze(-1)
    delta = torch.where(valid, 1 - _arity(kind), 0)
    after = torch.cumsum(delta, dim=-1)
    before = after - delta
    cand = (idx.unsqueeze(-1) >= idx) & (
        before.unsqueeze(-2) < after.unsqueeze(-1)
    )  # [..., i, j]: j <= i and depth before j < depth after i
    start = torch.amax(torch.where(cand, idx, -1), dim=-1)
    return torch.where(valid, start, -1)


def subtree_sizes(kind: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """Per-slot subtree sizes (..., L) int64; PAD slots get 0."""
    idx = torch.arange(kind.shape[-1], device=kind.device)
    start = subtree_starts(kind, length)
    return torch.where(start >= 0, idx - start + 1, 0)


def node_depths(kind: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """Per-slot subtree height (..., L) int64; PAD slots get 0. A node's
    level is its number of ancestors; the height at ``i`` is one more than
    the largest level difference inside ``i``'s span."""
    idx = torch.arange(kind.shape[-1], device=kind.device)
    start = subtree_starts(kind, length)
    # inside[..., i, j]: slot j lies in the span of slot i
    inside = (start.unsqueeze(-1) <= idx) & (idx <= idx.unsqueeze(-1)) & (
        start.unsqueeze(-1) >= 0
    )
    level = inside.sum(dim=-2) - (start >= 0).to(torch.int64)  # ancestors
    diff = torch.where(inside, level.unsqueeze(-2) - level.unsqueeze(-1), -1)
    height = torch.amax(diff, dim=-1) + 1
    return torch.where(start >= 0, height, 0)


def tree_depth(kind: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    depths = node_depths(kind, length)
    root = torch.clamp_min(length - 1, 0).unsqueeze(-1)
    return torch.gather(depths, -1, root).squeeze(-1)


def valid_mask(tree: TreeBatch) -> torch.Tensor:
    idx = torch.arange(tree.max_len, device=tree.kind.device)
    return idx < tree.length.unsqueeze(-1)


def count_constants(tree: TreeBatch) -> torch.Tensor:
    return torch.sum((tree.kind == CONST) & valid_mask(tree), dim=-1)


def get_constants(tree: TreeBatch) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cval, is_const_mask): the constants stay in place in ``cval``; the
    mask selects the live CONST slots."""
    return tree.cval, (tree.kind == CONST) & valid_mask(tree)


def set_constants(tree: TreeBatch, cval: torch.Tensor) -> TreeBatch:
    """``tree`` with its live constants taken from ``cval`` (same shape);
    every other slot keeps its value."""
    _, mask = get_constants(tree)
    return tree._replace(cval=torch.where(mask, cval, tree.cval))


def tree_hash(tree: TreeBatch) -> np.ndarray:
    """Content hash of the program(s), host side: blake2b (8 bytes) over
    the length and the live slots' fields, with the fields a node's kind
    ignores zeroed, so padded tails and ``max_len`` do not change it. A
    single tree gives a 0-d uint64 array, a batch one hash per tree; the
    JAX package's ``tree_hash`` gives the same bits."""
    import hashlib

    def host(x, dtype):
        return torch.as_tensor(x).detach().cpu().to(dtype).contiguous().numpy()

    kind = host(tree.kind, torch.int32)
    # leaf and unary slots: the op / feat fields their kind ignores are noise
    op = np.where(kind >= UNA, host(tree.op, torch.int32), 0).astype(np.int32)
    feat = np.where(kind == VAR, host(tree.feat, torch.int32),
                    0).astype(np.int32)
    cval = np.where(kind == CONST, host(tree.cval, torch.float64), 0.0)
    length = host(tree.length, torch.int32)

    flat_shape = kind.shape[:-1]
    out = np.empty(flat_shape, dtype=np.uint64)
    for i in np.ndindex(flat_shape):
        n = int(length[i])
        h = hashlib.blake2b(digest_size=8)
        h.update(np.int32(n).tobytes())
        h.update(kind[i][:n].tobytes())
        h.update(op[i][:n].tobytes())
        h.update(feat[i][:n].tobytes())
        h.update(cval[i][:n].tobytes())
        out[i] = np.frombuffer(h.digest(), dtype=np.uint64)[0]
    return out[()] if flat_shape == () else out
