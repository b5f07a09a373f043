"""Expression complexity: node count, or a weighted sum with custom
mappings (counterpart of ``symbolicregression_jl_tpu/models/complexity.py``)."""

from __future__ import annotations

import torch

from ..utils.device import table
from .options import Options
from .trees import CONST, UNA, VAR, TreeBatch, valid_mask


def compute_complexity(trees: TreeBatch, options: Options) -> torch.Tensor:
    """Complexity per tree; shape = batch shape of ``trees``."""
    cm = options.complexity_mapping
    if not cm.use:
        return trees.length
    dev = trees.kind.device
    bin_t = table(cm.binop_complexities or (1,), dev)
    una_t = table(cm.unaop_complexities or (1,), dev)
    per_node = torch.where(
        trees.kind == CONST, cm.constant_complexity,
        torch.where(
            trees.kind == VAR, cm.variable_complexity,
            torch.where(
                trees.kind == UNA,
                una_t[trees.op.clamp(0, una_t.shape[0] - 1)],
                bin_t[trees.op.clamp(0, bin_t.shape[0] - 1)],
            ),
        ),
    )
    return torch.sum(torch.where(valid_mask(trees), per_node, 0), dim=-1)
