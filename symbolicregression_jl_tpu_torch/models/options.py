"""Options / MutationWeights — the immutable search configuration.

Counterpart of ``symbolicregression_jl_tpu/models/options.py``: the field
names and defaults of every field this package reads are the JAX
package's. Fields the port cannot honour yet raise ``NotImplementedError``
at construction, naming the slice that brings them; they are never
silently ignored. The TPU-only levers of the JAX package (kernel tile
sizes, dispatch shapes, bucket ladders, the tune cache) are not fields
here at all.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..ops.losses import ElementwiseLoss, resolve_loss
from ..ops.operators import OperatorSet, canonical_name, make_operator_set

# Mutation kind indices (MutationWeights order)
MUTATE_CONSTANT = 0
MUTATE_OPERATOR = 1
ADD_NODE = 2
INSERT_NODE = 3
DELETE_NODE = 4
SIMPLIFY = 5
RANDOMIZE = 6
DO_NOTHING = 7
OPTIMIZE = 8
N_MUTATIONS = 9


@dataclasses.dataclass(frozen=True)
class MutationWeights:
    mutate_constant: float = 0.048
    mutate_operator: float = 0.47
    add_node: float = 0.79
    insert_node: float = 5.1
    delete_node: float = 1.7
    simplify: float = 0.0020
    randomize: float = 0.00023
    do_nothing: float = 0.21
    optimize: float = 0.0

    def as_tuple(self) -> Tuple[float, ...]:
        return dataclasses.astuple(self)


_DEPRECATED_KWARGS = {
    "hofMigration": "hof_migration",
    "shouldOptimizeConstants": "should_optimize_constants",
    "perturbationFactor": "perturbation_factor",
    "batchSize": "batch_size",
    "crossoverProbability": "crossover_probability",
    "warmupMaxsizeBy": "warmup_maxsize_by",
    "useFrequency": "use_frequency",
    "useFrequencyInTournament": "use_frequency_in_tournament",
    "fractionReplaced": "fraction_replaced",
    "fractionReplacedHof": "fraction_replaced_hof",
    "ns": "tournament_selection_n",
    "probPickFirst": "tournament_selection_p",
    "earlyStopCondition": "early_stop_condition",
}

_LATER_OPTIMIZERS = "Nelder-Mead and Newton come with a later slice of the port"

# JAX Options fields this slice does not honour, with the value that means
# "off" and the slice that brings them. Passing anything else raises.
_UNSUPPORTED = {
    "optimizer_algorithm": ("BFGS", _LATER_OPTIMIZERS),
    "optimizer_backend": ("auto", "'jnp' and 'pallas' are the JAX package's "
                          "routing levers; the port routes by device"),
    "recorder": (False, "the lineage recorder comes with the host subsystems slice"),
    "cache_fitness": (False, "the evaluation memo bank comes with the cache/ slice"),
    "telemetry": (False, "telemetry comes with the telemetry/ slice"),
    "telemetry_dir": (None, "telemetry comes with the telemetry/ slice"),
    "snapshot_path": (None, "snapshots come with the resilience slice"),
    "snapshot_every_dispatches": (0, "snapshots come with the resilience slice"),
    "row_shards": (1, "row sharding comes with the multi-GPU slice"),
    "tenants": (1, "tenant-batched serving comes with the serving/ slice"),
    "loss_function": (None, "custom full-tree objectives come with a later slice"),
    "independent_island_batches": (False, "per-island minibatches come with a later slice"),
}
KERNEL_PROGRAMS = ("auto", "postfix", "instr", "instr_packed")
# the working dtype of each precision the port runs
PRECISIONS = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "float16": torch.float16}
# TPU levers of the JAX package that the port does not carry at all
_TPU_LEVERS = (
    "eval_backend", "kernel_leaf_skip", "eval_bucket_ladder",
    "eval_rows_per_tile", "max_cycles_per_dispatch", "cache_device_slots",
    "cache_capacity", "island_axis", "row_axis", "tenant_axis", "turbo",
)


# --- the compile-identity contract (the JAX package's options.py) -------
# Every Options field is in exactly one of the three classes below, the
# class it has in the JAX package.
#
#   GRAPH_FIELDS          baked into a captured cycle graph (shapes, branch
#                         structure, kernel arguments passed by value): part
#                         of _graph_key and of hash / eq, so changing one
#                         captures a new graph (models/cycle_graph.py).
#   TRACED_SCALAR_FIELDS  read by the graph from device scalars
#                         (traced_scalars / bind_scalars): absent from the
#                         key, so a sweep over them replays one graph. Every
#                         use site is tensor math, never Python control flow
#                         (fitness.loss_to_score, evolve._accept_mutation,
#                         mutate_device.mutate_constant,
#                         population.tournament_winner, migration.migrate).
#   ORCHESTRATION_FIELDS  read on the host between iterations only: absent
#                         from the key.
TRACED_SCALAR_FIELDS = (
    "parsimony",
    "alpha",
    "perturbation_factor",
    "probability_negate_constant",
    "adaptive_parsimony_scaling",
    "tournament_selection_p",
    "fraction_replaced",
    "fraction_replaced_hof",
)

GRAPH_FIELDS = (
    "binary_operators",
    "unary_operators",
    "npopulations",
    "npop",
    "ncycles_per_iteration",
    "tournament_selection_n",
    "topn",
    "maxsize",
    "maxdepth",
    "max_len",
    "loss",
    "loss_function",
    "annealing",
    "use_frequency",
    "use_frequency_in_tournament",
    "mutation_weights",
    "crossover_probability",
    "migration",
    "hof_migration",
    "should_optimize_constants",
    "optimizer_algorithm",
    "optimizer_probability",
    "optimizer_nrestarts",
    "optimizer_iterations",
    "optimizer_backend",
    "batching",
    "batch_size",
    "independent_island_batches",
    "constraints",
    "nested_constraints",
    "complexity_of_operators",
    "complexity_of_constants",
    "complexity_of_variables",
    "recorder",
    "cache_fitness",
    "n_parallel_tournaments",
    "kernel_program",
    "row_shards",
    "precision",
    "tenants",
)

ORCHESTRATION_FIELDS = (
    "warmup_maxsize_by",
    "early_stop_condition",
    "timeout_in_seconds",
    "max_evals",
    "seed",
    "verbosity",
    "telemetry",
    "telemetry_dir",
    "snapshot_path",
    "snapshot_every_dispatches",
)

# Process-lifetime identity tokens for callable config values: an id() is
# reused once its object is collected, so the registry pins each callable
# and hands it a token that no other callable gets in this process.
_CALLABLE_TOKENS: Dict[int, int] = {}
_CALLABLE_REFS: list = []


def callable_token(fn: Callable) -> int:
    """A token for ``fn`` that no other callable gets in this process."""
    tok = _CALLABLE_TOKENS.get(id(fn))
    if tok is None:
        tok = len(_CALLABLE_REFS)
        _CALLABLE_TOKENS[id(fn)] = tok
        _CALLABLE_REFS.append(fn)
    return tok


def _key_of(value):
    """A hashable key of a config value: a callable that is not a
    registry loss is keyed by its token."""
    if value is None or isinstance(value, (str, ElementwiseLoss)):
        return value
    return callable_token(value) if callable(value) else value


def scalar_tensor(value, device, dtype: torch.dtype = torch.float32):
    """``value`` as a 0-dim tensor on ``device``: a tensor is moved and
    cast, a Python number is filled in (a fill kernel, no copy from host
    memory, so no wait for the card)."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=dtype)
    return torch.full((), value, dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True, eq=False)
class Options:
    # --- operators ---
    binary_operators: Tuple[str, ...] = ("+", "-", "*", "/")
    unary_operators: Tuple[str, ...] = ()
    # --- population / search shape ---
    npopulations: int = 15
    npop: int = 33
    ncycles_per_iteration: int = 550
    tournament_selection_n: int = 12
    tournament_selection_p: float = 0.86
    topn: int = 12
    # --- size limits ---
    maxsize: int = 20
    maxdepth: Optional[int] = None
    # --- loss / scoring ---
    loss: Union[str, Callable] = "L2DistLoss"
    parsimony: float = 0.0032
    alpha: float = 0.100000
    annealing: bool = False
    use_frequency: bool = True
    use_frequency_in_tournament: bool = True
    adaptive_parsimony_scaling: float = 20.0
    # --- mutation ---
    mutation_weights: MutationWeights = MutationWeights()
    crossover_probability: float = 0.066
    perturbation_factor: float = 0.076
    probability_negate_constant: float = 0.01
    # --- migration ---
    migration: bool = True
    hof_migration: bool = True
    fraction_replaced: float = 0.00036
    fraction_replaced_hof: float = 0.035
    # --- constant optimisation (BFGS, any loss of the registry) ---
    should_optimize_constants: bool = True
    optimizer_algorithm: str = "BFGS"
    optimizer_probability: float = 0.14
    optimizer_nrestarts: int = 2
    optimizer_iterations: int = 8
    optimizer_backend: str = "auto"
    # --- batching ---
    batching: bool = False
    batch_size: int = 50
    independent_island_batches: bool = False
    # --- constraints ---
    constraints: Tuple[Tuple[str, Any], ...] = ()
    nested_constraints: Tuple[Tuple[str, Tuple[Tuple[str, int], ...]], ...] = ()
    complexity_of_operators: Tuple[Tuple[str, int], ...] = ()
    complexity_of_constants: int = 1
    complexity_of_variables: int = 1
    # --- schedule / stopping ---
    warmup_maxsize_by: float = 0.0
    early_stop_condition: Optional[Union[float, Callable]] = None
    timeout_in_seconds: Optional[float] = None
    max_evals: Optional[int] = None
    # --- misc ---
    seed: int = 0
    verbosity: int = 1
    recorder: bool = False
    cache_fitness: bool = False
    telemetry: bool = False
    telemetry_dir: Optional[str] = None
    snapshot_path: Optional[str] = None
    snapshot_every_dispatches: int = 0
    loss_function: Optional[Callable] = None
    n_parallel_tournaments: int = 0  # 0 => npop // tournament_selection_n
    kernel_program: str = "auto"
    row_shards: int = 1
    precision: str = "float32"
    tenants: int = 1
    max_len: int = 0  # 0 => round_up(maxsize + 2, 8)

    def __post_init__(self):
        if self.maxdepth is None:
            object.__setattr__(self, "maxdepth", self.maxsize)
        if self.max_len == 0:
            object.__setattr__(self, "max_len", -(-(self.maxsize + 2) // 8) * 8)
        if self.n_parallel_tournaments == 0:
            object.__setattr__(self, "n_parallel_tournaments",
                               max(1, self.npop // self.tournament_selection_n))
        for f in ("binary_operators", "unary_operators"):
            v = getattr(self, f)
            if not isinstance(v, tuple):
                object.__setattr__(self, f, tuple(v))
        for f in ("constraints", "nested_constraints", "complexity_of_operators"):
            v = getattr(self, f)
            if isinstance(v, dict):
                object.__setattr__(self, f, tuple(
                    (k, tuple(sorted(val.items())) if isinstance(val, dict) else val)
                    for k, val in sorted(v.items())
                ))
        if self.precision == "float64":
            raise NotImplementedError(
                "precision='float64' is not supported by the PyTorch port "
                "yet: it needs double-precision builds of the operator and "
                "loss libraries (csrc/operators.cuh, csrc/losses.cuh), which "
                "come with the float64 kernel slice (ROADMAP.md)")
        if self.precision not in PRECISIONS:
            raise ValueError(
                "precision must be one of float32/float64/bfloat16/float16")
        for name, (off, why) in _UNSUPPORTED.items():
            value = getattr(self, name)
            if value != off:
                raise NotImplementedError(
                    f"{name}={value!r} is not supported by the PyTorch port "
                    f"yet: {why}"
                )
        optimizes = ((self.should_optimize_constants
                      and self.optimizer_probability > 0)
                     or self.mutation_weights.optimize > 0)
        if optimizes and not isinstance(resolve_loss(self.loss),
                                        ElementwiseLoss):
            raise NotImplementedError(
                f"constant optimisation with loss={self.loss!r}: the "
                "constant-optimisation kernels compute the registry's losses "
                "(a name of LOSS_REGISTRY or an ElementwiseLoss); a callable "
                "of your own needs its CUDA source spliced into the kernels, "
                "which comes with custom operators and objectives (ROADMAP.md "
                "section A.6). Pass should_optimize_constants=False (and no "
                "optimize mutation) to search without it"
            )
        if not 0 < self.tournament_selection_p <= 1:
            raise ValueError("tournament_selection_p must be in (0, 1]")
        if self.kernel_program not in KERNEL_PROGRAMS:
            raise ValueError(
                "kernel_program must be one of "
                "auto/postfix/instr/instr_packed"
            )
        if self.tournament_selection_n > self.npop:
            raise ValueError("tournament_selection_n must be <= npop")
        object.__setattr__(self, "_operators", make_operator_set(
            self.binary_operators, self.unary_operators))
        resolve_loss(self.loss)

    @property
    def operators(self) -> OperatorSet:
        return self._operators  # type: ignore[attr-defined]

    @property
    def dtype(self) -> torch.dtype:
        """The working dtype of X, y, the constants, losses and scores."""
        return PRECISIONS[self.precision]

    @property
    def elementwise_loss(self) -> Callable:
        return resolve_loss(self.loss)

    @property
    def actual_maxsize(self) -> int:
        return self.maxsize + 2

    def complexity_arrays(self):
        """(use_custom, binop_c, unaop_c, var_c, const_c), numpy tables
        aligned with the operator set."""
        ops = self.operators
        custom = {canonical_name(k): v for k, v in self.complexity_of_operators}
        use = (bool(custom) or self.complexity_of_constants != 1
               or self.complexity_of_variables != 1)
        bin_c = np.array([int(custom.get(n, 1)) for n in ops.binary_names], np.int64)
        una_c = np.array([int(custom.get(n, 1)) for n in ops.unary_names], np.int64)
        return (use, bin_c, una_c, int(self.complexity_of_variables),
                int(self.complexity_of_constants))

    def early_stop_fn(self) -> Optional[Callable]:
        cond = self.early_stop_condition
        if cond is None:
            return None
        if callable(cond):
            return cond
        thresh = float(cond)
        return lambda loss, complexity: loss < thresh

    def _graph_key(self) -> tuple:
        """The GRAPH_FIELDS' values: what a captured cycle graph bakes in.
        Hash and eq use only these, so Options that differ in a traced
        scalar or an orchestration field share a captured graph; the
        traced scalars reach the graph through ``bind_scalars``, never
        through the cached graph's own Options."""
        return tuple(
            self.mutation_weights.as_tuple() if f == "mutation_weights"
            else _key_of(getattr(self, f)) for f in GRAPH_FIELDS)

    def traced_scalars(self, device) -> Tuple[torch.Tensor, ...]:
        """The TRACED_SCALAR_FIELDS as float32 0-dim tensors on
        ``device``, in that order."""
        return tuple(scalar_tensor(getattr(self, f), device)
                     for f in TRACED_SCALAR_FIELDS)

    def bind_scalars(self, scalars) -> "Options":
        """Shallow copy whose TRACED_SCALAR_FIELDS read ``scalars``
        (typically device tensors); every use site is tensor math."""
        new = copy.copy(self)
        for f, v in zip(TRACED_SCALAR_FIELDS, scalars):
            object.__setattr__(new, f, v)
        return new

    def __hash__(self):
        return hash(self._graph_key())

    def __eq__(self, other):
        if not isinstance(other, Options):
            return NotImplemented
        return self._graph_key() == other._graph_key()


def make_options(**kwargs) -> Options:
    """Kwarg constructor accepting the JAX package's deprecated camelCase
    names and the ``elementwise_loss`` / ``una_constraints`` /
    ``bin_constraints`` spellings."""
    remapped = {}
    for k, v in kwargs.items():
        if k in _TPU_LEVERS:
            raise NotImplementedError(
                f"{k} is a TPU lever of the JAX package; the PyTorch port "
                "routes by device and carries no such knob"
            )
        k2 = _DEPRECATED_KWARGS.get(k, k)
        if k2 in remapped:
            raise ValueError(f"Duplicate kwarg {k2!r}")
        remapped[k2] = v
    if "elementwise_loss" in remapped:
        if "loss" in remapped:
            raise ValueError("Pass either loss= or elementwise_loss=, not both")
        remapped["loss"] = remapped.pop("elementwise_loss")
    for k in ("una_constraints", "bin_constraints"):
        if k in remapped:
            extra = remapped.pop(k)
            if extra is None:
                continue
            if not isinstance(extra, dict):
                raise ValueError(f"{k} must be a dict of operator-name -> constraint")
            merged = dict(remapped.get("constraints") or {})
            for op, spec in extra.items():
                if op in merged:
                    raise ValueError(
                        f"operator {op!r} constrained in both constraints= and {k}="
                    )
                merged[op] = spec
            remapped["constraints"] = merged
    mw = remapped.get("mutation_weights")
    if isinstance(mw, (list, tuple)):
        remapped["mutation_weights"] = MutationWeights(*mw)
    elif isinstance(mw, dict):
        remapped["mutation_weights"] = MutationWeights(**mw)
    return Options(**remapped)
