"""Expression complexity: node count, or a weighted sum with custom
mappings (counterpart of ``symbolicregression_jl_tpu/models/complexity.py``)."""

from __future__ import annotations

import torch

from .options import Options
from .trees import CONST, UNA, VAR, TreeBatch, valid_mask


def compute_complexity(trees: TreeBatch, options: Options) -> torch.Tensor:
    """Complexity per tree; shape = batch shape of ``trees``."""
    use, bin_c, una_c, var_c, const_c = options.complexity_arrays()
    if not use:
        return trees.length
    dev = trees.kind.device
    bin_t = torch.as_tensor(bin_c if len(bin_c) else [1], device=dev)
    una_t = torch.as_tensor(una_c if len(una_c) else [1], device=dev)
    per_node = torch.where(
        trees.kind == CONST, const_c,
        torch.where(
            trees.kind == VAR, var_c,
            torch.where(
                trees.kind == UNA,
                una_t[trees.op.clamp(0, una_t.shape[0] - 1)],
                bin_t[trees.op.clamp(0, bin_t.shape[0] - 1)],
            ),
        ),
    )
    return torch.sum(torch.where(valid_mask(trees), per_node, 0), dim=-1)
