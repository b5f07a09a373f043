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

import torch

from ..ops.losses import ElementwiseLoss, resolve_loss
from ..ops.operators import OperatorSet, canonical_name, make_operator_set
from ..ops.user_ops import operator_set_key, require_kernel_loss, user_loss_key

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
class ComplexityMapping:
    """Per-operator, variable and constant complexity weights, aligned with
    the operator set; with ``use`` False complexity is the node count.
    ``Options.complexity_mapping`` builds it from the ``complexity_of_*``
    fields."""

    use: bool = False
    binop_complexities: Tuple[int, ...] = ()
    unaop_complexities: Tuple[int, ...] = ()
    variable_complexity: int = 1
    constant_complexity: int = 1


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

OPTIMIZER_ALGORITHMS = ("BFGS", "NelderMead", "Newton")

# JAX Options fields this slice does not honour, with the value that means
# "off" and the slice that brings them. Passing anything else raises.
_UNSUPPORTED = {
    "optimizer_backend": ("auto", "'jnp' and 'pallas' are the JAX package's "
                          "routing levers; the port routes by device"),
    "recorder": (False, "the lineage recorder comes with the host subsystems slice"),
    "cache_fitness": (False, "the evaluation memo bank comes with the cache/ slice"),
    "telemetry": (False, "telemetry comes with the telemetry/ slice"),
    "telemetry_dir": (None, "telemetry comes with the telemetry/ slice"),
    "snapshot_path": (None, "snapshots come with the resilience slice"),
    "snapshot_every_dispatches": (0, "snapshots come with the resilience slice"),
    "row_shards": (1, "row sharding comes with the multi-GPU slice"),
    "recorder_file": ("pysr_recorder.json", "the lineage recorder comes with "
                      "the host subsystems slice (ROADMAP.md section A.10)"),
    "telemetry_every": (1, "telemetry comes with the telemetry/ slice "
                        "(ROADMAP.md section A.11)"),
    "telemetry_run_id": (None, "telemetry comes with the telemetry/ slice "
                         "(ROADMAP.md section A.11)"),
    "telemetry_attempt": (None, "telemetry comes with the telemetry/ slice "
                          "(ROADMAP.md section A.11)"),
    "profile_trace_dir": (None, "profile traces come with the telemetry/ "
                          "slice (ROADMAP.md section A.11)"),
}
KERNEL_PROGRAMS = ("auto", "postfix", "instr", "instr_packed")
# the working dtype of each precision the port runs
PRECISIONS = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "float16": torch.float16, "float64": torch.float64}
# TPU levers of the JAX package that the port does not carry at all
_TPU_LEVERS = (
    "eval_backend", "kernel_leaf_skip", "eval_bucket_ladder",
    "eval_rows_per_tile", "max_cycles_per_dispatch", "cache_device_slots",
    "cache_capacity", "island_axis", "row_axis", "tenant_axis",
)
# what a tenant-batched search (tenants > 1) does not run yet, each queued
# under ROADMAP.md section A.12
_TENANT_REFUSED = "is not supported with tenants > 1 yet (ROADMAP.md section A.12)"


class TenantIsolationError(ValueError):
    """Options combination that cannot keep tenants isolated in a
    tenant-batched search (``Options.tenants > 1``, serving/batched.py):
    a knob that funnels per-run host-side output into one shared location
    (a snapshot file, a hall-of-fame CSV, the lineage recorder's one JSON
    document) would interleave tenants. ``.fields`` names the conflicting
    Options fields and ``.conflicts`` maps each to its reason (the JAX
    package's error, field for field)."""

    def __init__(self, conflicts):
        self.conflicts = dict(conflicts)
        self.fields = tuple(self.conflicts)
        detail = "; ".join(
            f"{name}: {reason}" for name, reason in conflicts
        )
        super().__init__(
            f"tenants > 1 conflicts with field(s) "
            f"{', '.join(self.fields)} — {detail}"
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
    "skip_mutation_failures",
    "fast_cycle",
    "warmup_maxsize_by",
    "early_stop_condition",
    "timeout_in_seconds",
    "max_evals",
    "seed",
    "deterministic",
    "verbosity",
    "progress",
    "output_file",
    "save_to_file",
    "terminal_width",
    "define_helper_functions",
    "recorder_file",
    "telemetry",
    "telemetry_dir",
    "telemetry_every",
    "telemetry_run_id",
    "telemetry_attempt",
    "profile_trace_dir",
    "snapshot_path",
    "snapshot_every_dispatches",
    "data_policy",
)

DATA_POLICIES = ("reject", "mask", "repair")

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
    registry loss is keyed by its token and, where it traces, by the hash
    of the device code generated from it (``ops/user_ops.py``)."""
    if value is None or isinstance(value, (str, ElementwiseLoss)):
        return value
    if callable(value):
        return (callable_token(value), user_loss_key(value))
    return value


def _objective_key(fn: Optional[Callable]):
    """The key of a custom full-tree objective (``loss_function``): its
    token, as the JAX package keys it; None without one."""
    return None if fn is None else callable_token(fn)


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
    # accepted for drop-in migration and without effect: a mutation that
    # fails is always skipped (the JAX package's default), and the cycle
    # is always batched over tournaments and islands (fast_cycle)
    skip_mutation_failures: bool = True
    fast_cycle: bool = False
    # --- migration ---
    migration: bool = True
    hof_migration: bool = True
    fraction_replaced: float = 0.00036
    fraction_replaced_hof: float = 0.035
    # --- constant optimisation (BFGS, NelderMead or Newton; any loss of
    # the registry or a traceable callable) ---
    should_optimize_constants: bool = True
    optimizer_algorithm: str = "BFGS"
    optimizer_probability: float = 0.14
    optimizer_nrestarts: int = 2
    optimizer_iterations: int = 8
    optimizer_backend: str = "auto"
    # --- batching ---
    batching: bool = False
    batch_size: int = 50
    # True: a minibatch per island per cycle (each island's children
    # scored on its own rows, one scoring call per island); False: one
    # minibatch per cycle that every island shares
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
    # accepted without effect: a seed gives the same search on one card
    deterministic: bool = True
    verbosity: int = 1
    progress: bool = True
    output_file: Optional[str] = None
    # False keeps output_file configured but writes nothing
    save_to_file: bool = True
    terminal_width: Optional[int] = None  # progress bar width; None = 40
    # what the front door does with non-finite cells (models/dataset.py):
    # raise, drop their rows through zero weights, or impute X cells
    data_policy: str = "reject"
    # accepted without effect: operators are Python callables already
    define_helper_functions: bool = True
    recorder: bool = False
    recorder_file: str = "pysr_recorder.json"
    cache_fitness: bool = False
    telemetry: bool = False
    telemetry_dir: Optional[str] = None
    telemetry_every: int = 1
    telemetry_run_id: Optional[str] = None
    telemetry_attempt: Optional[int] = None
    profile_trace_dir: Optional[str] = None
    snapshot_path: Optional[str] = None
    snapshot_every_dispatches: int = 0
    # a custom full-tree objective (tree, X, y, weights, options) -> loss
    # that calls ``eval_tree`` on the one tree it gets (ops/interpreter.py)
    # and replaces ``loss`` in scoring and constant optimisation; the
    # search vmaps it over the population (models/fitness.py). On the card
    # it must be capturable in a CUDA graph: tensor math, no host read
    loss_function: Optional[Callable] = None
    n_parallel_tournaments: int = 0  # 0 => npop // tournament_selection_n
    kernel_program: str = "auto"
    row_shards: int = 1
    precision: str = "float32"
    # tenants > 1: the per-tenant Options of a tenant-batched search
    # (serving/batched.py), checked here against the knobs that break
    # per-tenant isolation; equation_search refuses it
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
        if self.precision not in PRECISIONS:
            raise ValueError(
                "precision must be one of float32/float64/bfloat16/float16")
        self._check_tenants()
        for name, (off, why) in _UNSUPPORTED.items():
            value = getattr(self, name)
            if value != off:
                raise NotImplementedError(
                    f"{name}={value!r} is not supported by the PyTorch port "
                    f"yet: {why}"
                )
        if self.optimizer_algorithm not in OPTIMIZER_ALGORITHMS:
            raise ValueError(
                f"optimizer_algorithm {self.optimizer_algorithm!r} not in "
                f"{list(OPTIMIZER_ALGORITHMS)}")
        optimizes = ((self.should_optimize_constants
                      and self.optimizer_probability > 0)
                     or self.mutation_weights.optimize > 0)
        if optimizes and self.loss_function is None:
            # a callable of the user's own is traced into the kernels' loss
            # (ops/user_ops.py); one the tracer cannot follow raises here,
            # naming what it met
            require_kernel_loss(resolve_loss(self.loss))
        if not 0 < self.tournament_selection_p <= 1:
            raise ValueError("tournament_selection_p must be in (0, 1]")
        if self.kernel_program not in KERNEL_PROGRAMS:
            raise ValueError(
                "kernel_program must be one of "
                "auto/postfix/instr/instr_packed"
            )
        if self.tournament_selection_n > self.npop:
            raise ValueError("tournament_selection_n must be <= npop")
        if self.data_policy not in DATA_POLICIES:
            raise ValueError(
                "data_policy must be one of reject/mask/repair, got "
                f"{self.data_policy!r}")
        object.__setattr__(self, "_operators", make_operator_set(
            self.binary_operators, self.unary_operators))
        resolve_loss(self.loss)

    def _check_tenants(self) -> None:
        """The JAX package's per-tenant isolation contract for tenants > 1
        (its ``__post_init__``, check for check), then the options the
        port's tenant-batched search does not run yet."""
        if self.tenants < 1:
            raise ValueError("tenants must be >= 1")
        if self.tenants == 1:
            return
        if self.row_shards > 1:
            raise ValueError(
                "tenants > 1 is incompatible with row_shards > 1: "
                "the device mesh is (tenants, islands) in batched "
                "serving — shard rows in solo searches only"
            )
        conflicts = []
        if self.recorder:
            conflicts.append((
                "recorder",
                "the lineage recorder materializes ONE run's "
                "populations into one JSON document; there is no "
                "per-tenant recorder — run the job solo",
            ))
        if (self.snapshot_path is not None
                and "{tenant}" not in str(self.snapshot_path)):
            conflicts.append((
                "snapshot_path",
                "a shared snapshot file would interleave tenants; "
                "use a per-tenant template such as "
                "'snaps/tenant{tenant}.npz'",
            ))
        if (self.output_file is not None
                and "{tenant}" not in str(self.output_file)):
            conflicts.append((
                "output_file",
                "a shared hall-of-fame CSV would interleave "
                "tenants; use a per-tenant template such as "
                "'hof_tenant{tenant}.csv'",
            ))
        if conflicts:
            raise TenantIsolationError(conflicts)
        if self.kernel_program in ("instr", "instr_packed"):
            raise NotImplementedError(
                f"kernel_program={self.kernel_program!r} {_TENANT_REFUSED}: "
                "the instruction-program kernels have no per-dataset launch")
        if self.loss_function is not None:
            raise NotImplementedError(f"loss_function {_TENANT_REFUSED}")
        if self.optimizer_algorithm == "Newton":
            raise NotImplementedError(
                f"optimizer_algorithm='Newton' {_TENANT_REFUSED}: its "
                "Hessian runs the lockstep interpreter on one dataset")

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

    @property
    def complexity_mapping(self) -> ComplexityMapping:
        ops = self.operators
        custom = {canonical_name(k): v for k, v in self.complexity_of_operators}
        return ComplexityMapping(
            use=(bool(custom) or self.complexity_of_constants != 1
                 or self.complexity_of_variables != 1),
            binop_complexities=tuple(int(custom.get(n, 1))
                                     for n in ops.binary_names),
            unaop_complexities=tuple(int(custom.get(n, 1))
                                     for n in ops.unary_names),
            variable_complexity=int(self.complexity_of_variables),
            constant_complexity=int(self.complexity_of_constants))

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
            else _objective_key(self.loss_function) if f == "loss_function"
            else _key_of(getattr(self, f)) for f in GRAPH_FIELDS) + (
                operator_set_key(self.operators),)

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
    # the reference's SIMD knob: turbo=True is the default routing (the
    # hand-written kernels on the card); turbo=False would pin the JAX
    # package's portable interpreter, a routing lever the port lacks
    if kwargs.pop("turbo", True) is not True:
        raise NotImplementedError(
            "turbo=False pins the JAX package's portable interpreter; the "
            "PyTorch port routes by device and carries no such knob")
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
