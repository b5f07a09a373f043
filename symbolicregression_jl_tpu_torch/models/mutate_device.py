"""Tree surgery on the device: mutations, crossover, random generation,
simplification (counterpart of
``symbolicregression_jl_tpu/models/mutate_device.py``).

The JAX functions act on one tree and are vmapped; here every function
takes a flat batch (fields ``(N, L)``, per-tree scalars ``(N,)``) and draws
its random numbers for the whole batch at once through ``utils/rng.py``.
Each edit is the one ``splice`` primitive (replace a postfix span by a
donor span) written as an index-mapped gather. Functions return
``(tree', ok)``; where ``ok`` is False the tree is returned unchanged.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.operators import OperatorSet
from ..utils import rng
from .trees import (
    BIN,
    CONST,
    PAD,
    UNA,
    VAR,
    TreeBatch,
    subtree_sizes,
    subtree_starts,
    valid_mask,
    where_trees,
)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[n, idx[n]] for a (N, L) tensor and (N,) indices."""
    return torch.gather(x, -1, idx.unsqueeze(-1)).squeeze(-1)


def _is_leaf(tree: TreeBatch) -> torch.Tensor:
    return ((tree.kind == CONST) | (tree.kind == VAR)) & valid_mask(tree)


def _is_op(tree: TreeBatch) -> torch.Tensor:
    return ((tree.kind == UNA) | (tree.kind == BIN)) & valid_mask(tree)


def make_random_leaf(gen, n: int, nfeatures: int, device,
                     dtype: torch.dtype = torch.float32):
    """50/50 constant (standard normal, drawn in float32 and cast to
    ``dtype``) / feature leaf, for n trees. Returns (kind, op, feat, cval),
    each (n,)."""
    is_const = rng.bernoulli(gen, 0.5, (n,), device)
    feat = rng.randint(gen, (n,), 0, nfeatures, device)
    cval = rng.normal(gen, (n,), device).to(dtype)
    kind = torch.where(is_const, CONST, VAR)
    return kind, torch.zeros_like(kind), torch.where(is_const, 0, feat), cval


# ---------------------------------------------------------------------------
# The splice primitive
# ---------------------------------------------------------------------------


def splice(tree: TreeBatch, start, end, dk, do, df, dc, d_start, d_len):
    """Replace tree[start:end) by donor[d_start : d_start+d_len) for every
    tree. Donor fields are (N, DL); positions are (N,) tensors or ints.
    ok=False (tree unchanged) where the result would not fit."""
    N, L = tree.kind.shape
    dev = tree.kind.device
    col = lambda v: v.reshape(-1, 1) if isinstance(v, torch.Tensor) else v
    start, end, d_start, d_len = col(start), col(end), col(d_start), col(d_len)
    DL = dk.shape[-1]
    new_len = tree.length.unsqueeze(-1) - (end - start) + d_len
    ok = ((new_len <= L) & (new_len >= 1)).squeeze(-1)
    i = torch.arange(L, device=dev).unsqueeze(0)
    in_donor = (i >= start) & (i < start + d_len)
    src_tree = torch.where(i < start, i,
                           (i - (start + d_len) + end).clamp(0, L - 1))
    src_tree = src_tree.expand(N, L)
    src_donor = (d_start + i - start).clamp(0, DL - 1).expand(N, L)
    live = i < new_len

    def pick(tf, df_, pad):
        out = torch.where(in_donor, torch.gather(df_, -1, src_donor),
                          torch.gather(tf, -1, src_tree))
        return torch.where(live, out, pad)

    new = TreeBatch(
        pick(tree.kind, dk, PAD), pick(tree.op, do, 0),
        pick(tree.feat, df, 0), pick(tree.cval, dc, 0.0),
        new_len.squeeze(-1),
    )
    return where_trees(ok, new, tree), ok


def _node_span(idx, sizes):
    return idx - _take(sizes, idx) + 1, idx + 1


# ---------------------------------------------------------------------------
# Mutations
# ---------------------------------------------------------------------------


def mutate_constant(gen, tree: TreeBatch, temperature, perturbation_factor,
                    probability_negate):
    """Multiplicative perturbation + occasional negation of one constant.
    ``temperature`` and the two Options scalars are Python numbers or
    0-dim device tensors (a captured cycle reads them from the card)."""
    N = tree.kind.shape[0]
    dev = tree.kind.device
    mask = (tree.kind == CONST) & valid_mask(tree)
    idx = rng.choice_mask(gen, mask)
    ok = mask.any(dim=-1)
    max_change = perturbation_factor * temperature + 1.1
    factor = max_change ** rng.uniform(gen, (N,), dev)
    bigger = rng.bernoulli(gen, 0.5, (N,), dev)
    factor = torch.where(bigger, factor, 1.0 / factor)
    negate = rng.bernoulli(gen, probability_negate, (N,), dev)
    new_val = _take(tree.cval, idx) * factor * torch.where(negate, -1.0, 1.0)
    new_cval = tree.cval.scatter(-1, idx.unsqueeze(-1),
                                 new_val.to(tree.cval.dtype).unsqueeze(-1))
    return tree._replace(cval=torch.where(ok.unsqueeze(-1), new_cval,
                                          tree.cval)), ok


def mutate_operator(gen, tree: TreeBatch, operators: OperatorSet):
    """Swap one operator for a random operator of the same arity."""
    N = tree.kind.shape[0]
    dev = tree.kind.device
    mask = _is_op(tree)
    idx = rng.choice_mask(gen, mask)
    ok = mask.any(dim=-1)
    is_una = _take(tree.kind, idx) == UNA
    op_u = rng.randint(gen, (N,), 0, max(operators.n_unary, 1), dev)
    op_b = rng.randint(gen, (N,), 0, max(operators.n_binary, 1), dev)
    new_op = tree.op.scatter(-1, idx.unsqueeze(-1),
                             torch.where(is_una, op_u, op_b).unsqueeze(-1))
    return tree._replace(op=torch.where(ok.unsqueeze(-1), new_op,
                                        tree.op)), ok


def _choose_unary(gen, n: int, operators: OperatorSet, device):
    if operators.n_unary == 0:
        return torch.zeros(n, dtype=torch.bool, device=device)
    if operators.n_binary == 0:
        return torch.ones(n, dtype=torch.bool, device=device)
    return rng.bernoulli(gen, 0.5, (n,), device)


def _random_op_donor(gen, use_unary, nfeatures: int, operators: OperatorSet,
                     dtype: torch.dtype):
    """Donor [leaf, OP] (unary, d_len=2) or [leaf, leaf, OP] (binary,
    d_len=3) with fresh random leaves, constants in ``dtype``; fields
    (N, 4)."""
    N = use_unary.shape[0]
    dev = use_unary.device
    lk1, _, lf1, lc1 = make_random_leaf(gen, N, nfeatures, dev, dtype)
    lk2, _, lf2, lc2 = make_random_leaf(gen, N, nfeatures, dev, dtype)
    op_u = rng.randint(gen, (N,), 0, max(operators.n_unary, 1), dev)
    op_b = rng.randint(gen, (N,), 0, max(operators.n_binary, 1), dev)
    z = torch.zeros_like(lk1)
    zf = torch.zeros_like(lc1)
    u = use_unary.unsqueeze(-1)
    dk = torch.where(u, torch.stack([lk1, z + UNA, z, z], -1),
                     torch.stack([lk1, lk2, z + BIN, z], -1))
    do = torch.where(u, torch.stack([z, op_u, z, z], -1),
                     torch.stack([z, z, op_b, z], -1))
    df = torch.where(u, torch.stack([lf1, z, z, z], -1),
                     torch.stack([lf1, lf2, z, z], -1))
    dc = torch.where(u, torch.stack([lc1, zf, zf, zf], -1),
                     torch.stack([lc1, lc2, zf, zf], -1))
    return dk, do, df, dc, torch.where(use_unary, 2, 3)


def append_random_op(gen, tree: TreeBatch, nfeatures: int,
                     operators: OperatorSet):
    """Replace a random leaf by a random operator over fresh leaves."""
    N = tree.kind.shape[0]
    mask = _is_leaf(tree)
    idx = rng.choice_mask(gen, mask)
    any_leaf = mask.any(dim=-1)
    use_unary = _choose_unary(gen, N, operators, tree.kind.device)
    dk, do, df, dc, d_len = _random_op_donor(gen, use_unary, nfeatures,
                                             operators, tree.cval.dtype)
    new, fit = splice(tree, idx, idx + 1, dk, do, df, dc, 0, d_len)
    ok = any_leaf & fit
    return where_trees(ok, new, tree), ok


def insert_random_op(gen, tree: TreeBatch, nfeatures: int,
                     operators: OperatorSet, at_root):
    """Make a node the child of a new random operator; a binary operator
    gets a fresh leaf as its other child, on a random side. ``at_root``
    (bool, or an (N,) bool tensor) picks the root instead of a random node
    (the JAX package's prepend_random_op)."""
    N = tree.kind.shape[0]
    dev = tree.kind.device
    sizes = subtree_sizes(tree.kind, tree.length)
    vmask = valid_mask(tree)
    at_root = (at_root.expand(N) if isinstance(at_root, torch.Tensor)
               else torch.full((N,), bool(at_root), device=dev))
    idx = torch.where(at_root, torch.clamp_min(tree.length - 1, 0),
                      rng.choice_mask(gen, vmask))
    any_node = torch.where(at_root, tree.length > 0, vmask.any(dim=-1))
    s, e = _node_span(idx, sizes)
    use_unary = _choose_unary(gen, N, operators, dev)
    as_left = rng.bernoulli(gen, 0.5, (N,), dev)
    op_u = rng.randint(gen, (N,), 0, max(operators.n_unary, 1), dev)
    op_b = rng.randint(gen, (N,), 0, max(operators.n_binary, 1), dev)
    lk, _, lf, lc = make_random_leaf(gen, N, nfeatures, dev, tree.cval.dtype)
    z = torch.zeros_like(lk)
    zf = torch.zeros_like(lc)
    op_kind = torch.where(use_unary, UNA, BIN)
    op_idx = torch.where(use_unary, op_u, op_b)

    # unary: insert [OP] at e; binary with the subtree as left child:
    # insert [leaf, OP] at e; as right child: [OP] at e, then [leaf] at s
    tail_leaf_op = (~use_unary & as_left).unsqueeze(-1)
    dk_t = torch.where(tail_leaf_op, torch.stack([lk, op_kind, z, z], -1),
                       torch.stack([op_kind, z, z, z], -1))
    do_t = torch.where(tail_leaf_op, torch.stack([z, op_idx, z, z], -1),
                       torch.stack([op_idx, z, z, z], -1))
    df_t = torch.where(tail_leaf_op, torch.stack([lf, z, z, z], -1),
                       torch.stack([z, z, z, z], -1))
    dc_t = torch.where(tail_leaf_op, torch.stack([lc, zf, zf, zf], -1),
                       torch.stack([zf, zf, zf, zf], -1))
    tail_len = torch.where(tail_leaf_op.squeeze(-1), 2, 1)
    new, ok1 = splice(tree, e, e, dk_t, do_t, df_t, dc_t, 0, tail_len)
    front = torch.stack([lk, z, z, z], -1), torch.stack([z, z, z, z], -1), \
        torch.stack([lf, z, z, z], -1), torch.stack([lc, zf, zf, zf], -1)
    front_len = torch.where(~use_unary & ~as_left, 1, 0)
    new2, ok2 = splice(new, s, s, *front, 0, front_len)
    ok = any_node & ok1 & ok2
    return where_trees(ok, new2, tree), ok


def delete_random_op(gen, tree: TreeBatch, nfeatures: int,
                     operators: OperatorSet):
    """Replace a random operator node by one of its children; a lone leaf
    is replaced by a fresh random leaf."""
    N = tree.kind.shape[0]
    dev = tree.kind.device
    sizes = subtree_sizes(tree.kind, tree.length)
    mask = _is_op(tree)
    idx = rng.choice_mask(gen, mask)
    any_op = mask.any(dim=-1)
    s, e = _node_span(idx, sizes)
    r_size = _take(sizes, torch.clamp_min(idx - 1, 0))
    r_start = idx - r_size
    l_root = idx - 1 - r_size
    l_start = l_root - _take(sizes, torch.clamp_min(l_root, 0)) + 1
    is_una = _take(tree.kind, idx) == UNA
    keep_right = rng.bernoulli(gen, 0.5, (N,), dev) | is_una
    c_start = torch.where(keep_right, r_start, l_start)
    c_end = torch.where(keep_right, idx, l_root + 1)
    new, fit = splice(tree, s, e, tree.kind, tree.op, tree.feat, tree.cval,
                      c_start, c_end - c_start)
    ok = any_op & fit

    lk, _, lf, lc = make_random_leaf(gen, N, nfeatures, dev, tree.cval.dtype)
    first = (torch.arange(tree.max_len, device=dev) == 0).unsqueeze(0)
    leaf_tree = TreeBatch(
        torch.where(first, lk.unsqueeze(-1), 0),
        torch.zeros_like(tree.op),
        torch.where(first, lf.unsqueeze(-1), 0),
        torch.where(first, lc.unsqueeze(-1), 0.0),
        torch.ones_like(tree.length),
    )
    leaf_only = tree.length == 1
    out = where_trees(leaf_only, leaf_tree, where_trees(ok, new, tree))
    return out, ok | leaf_only


def gen_random_tree_fixed_size(gen, target_size, nfeatures: int,
                               operators: OperatorSet, max_len: int,
                               device, dtype: torch.dtype = torch.float32
                               ) -> TreeBatch:
    """Grow random trees to ~target_size nodes (one per element of the
    (N,) tensor ``target_size``) by repeatedly replacing a random leaf
    with a random operator over fresh leaves; constants in ``dtype``."""
    N = target_size.shape[0]
    lk, _, lf, lc = make_random_leaf(gen, N, nfeatures, device, dtype)
    first = (torch.arange(max_len, device=device) == 0).unsqueeze(0)
    tree = TreeBatch(
        torch.where(first, lk.unsqueeze(-1), 0),
        torch.zeros((N, max_len), dtype=torch.int64, device=device),
        torch.where(first, lf.unsqueeze(-1), 0),
        torch.where(first, lc.unsqueeze(-1), 0.0),
        torch.ones(N, dtype=torch.int64, device=device),
    )
    target = torch.clamp_max(target_size, max_len)
    for _ in range(max_len // 2 + 1):
        remaining = target - tree.length
        if operators.n_unary > 0 and operators.n_binary > 0:
            use_unary = (remaining == 1) | rng.bernoulli(gen, 0.5, (N,), device)
        else:
            use_unary = torch.full((N,), operators.n_unary > 0, device=device)
        mask = _is_leaf(tree)
        idx = rng.choice_mask(gen, mask)
        dk, do, df, dc, d_len = _random_op_donor(gen, use_unary, nfeatures,
                                                 operators, dtype)
        new, fit = splice(tree, idx, idx + 1, dk, do, df, dc, 0, d_len)
        grow = (tree.length < target) & mask.any(dim=-1) & fit
        tree = where_trees(grow, new, tree)
    return tree


def crossover_trees(gen, a: TreeBatch, b: TreeBatch):
    """Swap random subtrees between paired trees. Returns (a', b', ok);
    ok=False (both unchanged) where either result would overflow."""
    va, vb = valid_mask(a), valid_mask(b)
    sizes_a = subtree_sizes(a.kind, a.length)
    sizes_b = subtree_sizes(b.kind, b.length)
    ia = rng.choice_mask(gen, va)
    ib = rng.choice_mask(gen, vb)
    sa, ea = _node_span(ia, sizes_a)
    sb, eb = _node_span(ib, sizes_b)
    a2, fit_a = splice(a, sa, ea, b.kind, b.op, b.feat, b.cval, sb, eb - sb)
    b2, fit_b = splice(b, sb, eb, a.kind, a.op, a.feat, a.cval, sa, ea - sa)
    ok = va.any(dim=-1) & vb.any(dim=-1) & fit_a & fit_b
    return where_trees(ok, a2, a), where_trees(ok, b2, b), ok


# ---------------------------------------------------------------------------
# Simplification: constant folding
# ---------------------------------------------------------------------------


def _const_fold(tree: TreeBatch, operators: OperatorSet):
    """Per-node (is_const, folded_value, parent_is_const). A node is
    constant when its subtree holds no variable and every value in it is
    finite; values come from one evaluation of every slot (the kernel's
    slot-values mode on the card) with variables read as 0, which cannot
    matter because a subtree with a variable is never folded. The values
    are computed at the constants' dtype (that dtype's build of the
    kernel), as the JAX package folds."""
    from ..ops.kernel_eval import eval_slot_values

    L = tree.max_len
    dev = tree.kind.device
    zero_x = torch.zeros((1, 1), dtype=tree.cval.dtype, device=dev)
    vals, _ = eval_slot_values(tree._replace(feat=torch.zeros_like(tree.feat)),
                               zero_x, operators)
    vals = vals.to(tree.cval.dtype)
    live = valid_mask(tree)
    start = subtree_starts(tree.kind, tree.length)
    blocker = (live & ((tree.kind == VAR) | ~torch.isfinite(vals))).to(torch.int64)
    prefix = torch.cat([torch.zeros_like(blocker[:, :1]),
                        torch.cumsum(blocker, dim=-1)], dim=-1)
    idx = torch.arange(L, device=dev).expand_as(tree.kind)
    n_block = (torch.gather(prefix, -1, idx + 1)
               - torch.gather(prefix, -1, start.clamp_min(0)))
    is_const = live & (n_block == 0)
    # strict ancestors of j: slots i > j whose span starts at or before j
    anc = (start.unsqueeze(-1) <= idx.unsqueeze(-2)) & (
        idx.unsqueeze(-1) > idx.unsqueeze(-2))  # [n, i, j]
    parent_const = (anc & is_const.unsqueeze(-1)).any(dim=-2)
    return is_const, vals, parent_const


def _compact(tree_fields, keep: torch.Tensor, L: int):
    """Scatter the kept slots of each tree to the front, preserving order;
    dropped slots land in an overflow column that is cut off."""
    pos = torch.cumsum(keep.to(torch.int64), dim=-1) - 1
    tgt = torch.where(keep, pos, L)
    out = []
    for src, fill in tree_fields:
        buf = torch.full((src.shape[0], L + 1), fill, dtype=src.dtype,
                         device=src.device)
        out.append(buf.scatter(-1, tgt, src)[:, :L])
    return out, keep.sum(dim=-1)


def simplify_tree(tree: TreeBatch, operators: OperatorSet):
    """Fold maximal constant subtrees into single CONST leaves and compact
    the survivors. Returns (tree', changed)."""
    L = tree.max_len
    is_const, fold_val, parent_const = _const_fold(tree, operators)
    fold_root = is_const & ~parent_const
    keep = valid_mask(tree) & (~is_const | fold_root)
    (kind, op, feat, cval), n_new = _compact([
        (torch.where(fold_root, CONST, tree.kind), PAD),
        (torch.where(fold_root, 0, tree.op), 0),
        (torch.where(fold_root, 0, tree.feat), 0),
        (torch.where(fold_root, fold_val, tree.cval), 0.0),
    ], keep, L)
    changed = n_new < tree.length
    return where_trees(changed, TreeBatch(kind, op, feat, cval, n_new),
                       tree), changed


# ---------------------------------------------------------------------------
# Operator combining: (x op c1) op c2 -> x op (c1 op' c2), and constant
# left children of commutative operators moved to the right
# ---------------------------------------------------------------------------


def _binop_idx(operators: OperatorSet, name: str) -> int:
    return (operators.binary_names.index(name)
            if name in operators.binary_names else -1)


def _combine_fold_table(operators: OperatorSet):
    """(inner_op, outer_op, fold, result_op) rules for the postfix window
    [c1, inner, c2, outer]: (L inner c1) outer c2."""
    p, m, t, d = (_binop_idx(operators, n) for n in "+-*/")
    add = lambda a, b: a + b
    sub_ = lambda a, b: a - b
    mul = lambda a, b: a * b
    div_ = lambda a, b: a / b
    rules = []
    if p >= 0:
        rules.append((p, p, add, p))
    if p >= 0 and m >= 0:
        rules.append((p, m, sub_, p))
        rules.append((m, p, sub_, m))
    if m >= 0:
        rules.append((m, m, add, m))
    if t >= 0:
        rules.append((t, t, mul, t))
    if t >= 0 and d >= 0:
        rules.append((t, d, div_, t))
        rules.append((d, t, div_, d))
    if d >= 0:
        rules.append((d, d, mul, d))
    return rules


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    return torch.argmax(mask.to(torch.int32), dim=-1)


def _combine_pass(tree: TreeBatch, operators: OperatorSet):
    """One combining step per tree: at most one constant-chain fold and one
    commutative rotation, lowest slot first. Returns (tree', changed)."""
    L = tree.max_len
    dev = tree.kind.device
    i = torch.arange(L, device=dev).unsqueeze(0)
    live = valid_mask(tree)
    kind, op, cval = tree.kind, tree.op, tree.cval
    rules = _combine_fold_table(operators)
    changed = torch.zeros(kind.shape[0], dtype=torch.bool, device=dev)
    if rules:
        sh = lambda a, k: torch.roll(a, k, dims=-1)
        win = (live & (kind == BIN) & (sh(kind, 1) == CONST)
               & (sh(kind, 2) == BIN) & (sh(kind, 3) == CONST) & (i >= 3))
        c1, c2, inner = sh(cval, 3), sh(cval, 1), sh(op, 2)
        fold_ok = torch.zeros_like(win)
        fold_val = torch.zeros_like(cval)
        fold_op = torch.zeros_like(op)
        for op_in, op_out, fold, res_op in rules:
            v = fold(c1, c2)
            match = win & (inner == op_in) & (op == op_out) & torch.isfinite(v)
            fold_ok = fold_ok | match
            fold_val = torch.where(match, v, fold_val)
            fold_op = torch.where(match, res_op, fold_op)
        u = _first_true(fold_ok).unsqueeze(-1)
        do_fold = fold_ok.any(dim=-1)
        df = do_fold.unsqueeze(-1)
        cval = torch.where(df & (i == u - 3), torch.gather(fold_val, -1, u), cval)
        op = torch.where(df & (i == u - 2), torch.gather(fold_op, -1, u), op)
        keep = ~(df & ((i == u - 1) | (i == u))) & live
        (fk, fo, ff, fc), n_new = _compact(
            [(kind, PAD), (op, 0), (tree.feat, 0), (cval, 0.0)], keep, L)
        tree = where_trees(do_fold, TreeBatch(fk, fo, ff, fc, n_new),
                           tree._replace(op=op, cval=cval))
        changed = changed | do_fold

    comm = [x for x in (_binop_idx(operators, "+"), _binop_idx(operators, "*"))
            if x >= 0]
    if comm:
        live = valid_mask(tree)
        sizes = subtree_sizes(tree.kind, tree.length)
        is_comm = torch.zeros_like(live)
        for cidx in comm:
            is_comm = is_comm | (tree.op == cidx)
        ii = i.expand_as(tree.kind)
        r_root = (ii - 1).clamp(0, L - 1)
        size_r = torch.gather(sizes, -1, r_root)
        l_root = (ii - 1 - size_r).clamp(0, L - 1)
        rot = (live & (tree.kind == BIN) & is_comm
               & (torch.gather(tree.kind, -1, l_root) == CONST)
               & (torch.gather(tree.kind, -1, r_root) != CONST) & (i >= 2))
        u = _first_true(rot).unsqueeze(-1)
        do_rot = rot.any(dim=-1).unsqueeze(-1)
        p = (u - 1 - torch.gather(sizes, -1, (u - 1).clamp(0, L - 1))).clamp(0, L - 1)
        src = torch.where((i >= p) & (i < u - 1), i + 1,
                          torch.where(i == u - 1, p, i)).clamp(0, L - 1)
        rotate = lambda a: torch.where(do_rot, torch.gather(a, -1, src), a)
        tree = tree._replace(kind=rotate(tree.kind), op=rotate(tree.op),
                             feat=rotate(tree.feat), cval=rotate(tree.cval))
        changed = changed | do_rot.squeeze(-1)
    return tree, changed


def combine_operators(tree: TreeBatch, operators: OperatorSet):
    """Repeat ``_combine_pass`` until no tree changes (at most max_len
    passes per tree, as in the JAX package). A pass leaves a tree that did
    not change untouched, so trees that converged early are unaffected by
    the extra passes the others need. Synchronises once per pass."""
    t, ch = _combine_pass(tree, operators)
    changed = ch
    n = 1
    while n < tree.max_len and bool(ch.any()):
        t2, ch2 = _combine_pass(t, operators)
        t = where_trees(ch, t2, t)
        ch = ch & ch2
        changed = changed | ch
        n += 1
    return t, changed
