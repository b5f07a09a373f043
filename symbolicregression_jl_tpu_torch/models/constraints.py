"""Constraint checking on flat postfix trees (counterpart of
``symbolicregression_jl_tpu/models/constraints.py``): size and depth caps,
per-operator subtree-size caps and nested-operator caps, all as integer
tensor ops batched over any leading dims."""

from __future__ import annotations

import torch

from ..ops.operators import canonical_name
from .complexity import compute_complexity
from .options import Options
from .trees import BIN, UNA, TreeBatch, subtree_sizes, tree_depth, valid_mask


def _op_occurrence_mask(tree: TreeBatch, kind: int, op_idx: int):
    return (tree.kind == kind) & (tree.op == op_idx) & valid_mask(tree)


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, -1, idx)


def check_constraints(trees: TreeBatch, options: Options,
                      curmaxsize) -> torch.Tensor:
    """Bool per tree (batch shape of ``trees``)."""
    ops = options.operators
    L = trees.max_len
    ok = compute_complexity(trees, options) <= curmaxsize
    ok &= tree_depth(trees.kind, trees.length) <= options.maxdepth
    ok &= trees.length >= 1
    if not (options.constraints or options.nested_constraints):
        return ok
    sizes = subtree_sizes(trees.kind, trees.length)
    idx = torch.arange(L, device=trees.kind.device).expand_as(trees.kind)

    for name, caps in options.constraints:
        cname = canonical_name(name)
        if cname in ops.binary_names:
            if isinstance(caps, int):
                caps = (caps, caps)
            l_cap, r_cap = caps
            mask = _op_occurrence_mask(trees, BIN, ops.binary_names.index(cname))
            r_size = _gather(sizes, torch.clamp_min(idx - 1, 0))
            l_root = idx - 1 - r_size
            l_size = _gather(sizes, l_root.clamp(0, L - 1))
            viol = torch.zeros_like(mask)
            if l_cap is not None and l_cap >= 0:
                viol |= mask & (l_size > l_cap)
            if r_cap is not None and r_cap >= 0:
                viol |= mask & (r_size > r_cap)
            ok &= ~viol.any(dim=-1)
        elif cname in ops.unary_names:
            cap = caps if isinstance(caps, int) else caps[0]
            if cap is not None and cap >= 0:
                mask = _op_occurrence_mask(trees, UNA, ops.unary_names.index(cname))
                c_size = _gather(sizes, torch.clamp_min(idx - 1, 0))
                ok &= ~(mask & (c_size > cap)).any(dim=-1)

    for outer_name, inner_rules in options.nested_constraints:
        o_name = canonical_name(outer_name)
        if o_name in ops.binary_names:
            o_kind, o_idx = BIN, ops.binary_names.index(o_name)
        elif o_name in ops.unary_names:
            o_kind, o_idx = UNA, ops.unary_names.index(o_name)
        else:
            continue
        outer_mask = _op_occurrence_mask(trees, o_kind, o_idx)
        span_start = idx - sizes + 1
        for inner_name, max_count in inner_rules:
            i_name = canonical_name(inner_name)
            if i_name in ops.binary_names:
                i_kind, i_idx = BIN, ops.binary_names.index(i_name)
            elif i_name in ops.unary_names:
                i_kind, i_idx = UNA, ops.unary_names.index(i_name)
            else:
                continue
            occ = _op_occurrence_mask(trees, i_kind, i_idx).to(torch.int64)
            prefix = torch.cat([torch.zeros_like(occ[..., :1]),
                                torch.cumsum(occ, dim=-1)], dim=-1)
            count = (_gather(prefix, idx)
                     - _gather(prefix, span_start.clamp(0, L)))
            ok &= ~(outer_mask & (count > max_count)).any(dim=-1)
    return ok
