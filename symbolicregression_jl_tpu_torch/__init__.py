"""PyTorch/CUDA port of symbolicregression_jl_tpu.

The search runs on one NVIDIA card (``device="cuda"``, the default) and
scores every candidate through the hand-written CUDA kernels under
``csrc/``; ``device="cpu"`` runs the kernels' plain PyTorch versions. This
package imports ``torch`` and never ``jax``; ``to_sympy``, ``from_sympy``,
``to_latex``, ``sympy_simplify_tree`` and ``result.sympy()`` /
``result.latex()`` import sympy when they are called.
"""

from .api import (
    EquationSearch, EquationSearchResult, SearchState, equation_search,
)
from .models.complexity import compute_complexity
from .models.dataset import (
    Dataset,
    DatasetDiagnostics,
    HostileDatasetError,
    load_csv_dataset,
    make_dataset,
    sanitize_dataset,
    update_baseline_loss,
    validate_dataset,
)
from .models.evolve import s_r_cycle
from .models.mutate_device import (
    combine_operators,
    gen_random_tree_fixed_size,
    simplify_tree,
)
from .models.options import (
    GRAPH_FIELDS,
    ORCHESTRATION_FIELDS,
    TRACED_SCALAR_FIELDS,
    ComplexityMapping,
    MutationWeights,
    Options,
    callable_token,
    make_options,
)
from .models.population import (
    HallOfFame,
    Population,
    calculate_pareto_frontier,
    init_hall_of_fame,
    init_population,
)
from .models.trees import (
    Expr,
    TreeBatch,
    decode_tree,
    encode_tree,
    get_constants,
    parse_expression,
    set_constants,
    tree_hash,
    tree_to_string,
)
from .ops.interpreter import (
    eval_diff_tree,
    eval_grad_constants,
    eval_grad_variables,
    eval_loss_trees_fused,
    eval_tree,
    eval_trees,
)
from .ops.losses import LOSS_REGISTRY, contain_nonfinite, pairwise_sum
from .ops.operators import (
    OperatorSet, make_operator_set, register_binary, register_unary,
)
from .utils.export import (
    from_sympy,
    sympy_simplify_tree,
    to_callable,
    to_latex,
    to_sympy,
)
from .serving import (
    JobResult, JobServer, batched_equation_search, pad_to_ladder,
)
from .utils.output import Candidate, load_hof_csv, save_hof_csv

__all__ = [
    "Candidate", "ComplexityMapping", "Dataset", "DatasetDiagnostics",
    "EquationSearch", "EquationSearchResult", "Expr", "GRAPH_FIELDS",
    "HallOfFame", "HostileDatasetError", "JobResult", "JobServer",
    "LOSS_REGISTRY", "MutationWeights",
    "ORCHESTRATION_FIELDS", "OperatorSet", "Options", "Population",
    "SearchState", "TRACED_SCALAR_FIELDS", "TreeBatch",
    "batched_equation_search", "calculate_pareto_frontier",
    "callable_token", "combine_operators",
    "compute_complexity", "contain_nonfinite", "decode_tree", "encode_tree",
    "equation_search", "eval_diff_tree", "eval_grad_constants",
    "eval_grad_variables", "eval_loss_trees_fused", "eval_tree",
    "eval_trees", "from_sympy", "gen_random_tree_fixed_size",
    "get_constants", "init_hall_of_fame", "init_population",
    "load_csv_dataset", "load_hof_csv", "make_dataset", "make_operator_set",
    "make_options", "pad_to_ladder", "pairwise_sum", "parse_expression",
    "register_binary",
    "register_unary", "s_r_cycle",
    "sanitize_dataset", "save_hof_csv", "set_constants", "simplify_tree",
    "sympy_simplify_tree", "to_callable", "to_latex", "to_sympy",
    "tree_hash", "tree_to_string", "update_baseline_loss",
    "validate_dataset",
]
