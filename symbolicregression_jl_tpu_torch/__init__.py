"""PyTorch/CUDA port of symbolicregression_jl_tpu.

The search runs on one NVIDIA card (``device="cuda"``, the default) and
scores every candidate through the hand-written CUDA kernel in
``csrc/postfix_eval.cu``; ``device="cpu"`` runs the kernel's plain
PyTorch version. This package imports ``torch`` and never ``jax``.
"""

from .api import EquationSearchResult, SearchState, equation_search
from .models.options import MutationWeights, Options, make_options
from .models.trees import (
    Expr,
    TreeBatch,
    decode_tree,
    encode_tree,
    parse_expression,
    tree_to_string,
)
from .ops.operators import OperatorSet, make_operator_set
from .utils.output import Candidate

__all__ = [
    "Candidate", "EquationSearchResult", "Expr", "MutationWeights",
    "OperatorSet", "Options", "SearchState", "TreeBatch", "decode_tree",
    "encode_tree", "equation_search", "make_operator_set", "make_options",
    "parse_expression", "tree_to_string",
]
