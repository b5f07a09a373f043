"""``equation_search``: the search loop on one device (counterpart of
``symbolicregression_jl_tpu/api.py`` for one output).

One iteration = the cycle loop on every island (each cycle scores all
islands' children in one kernel call), simplify + full-data rescore,
constant optimisation (the ``should_optimize_constants`` pass, then the
``optimize``-mutation pass), hall-of-fame merge across islands,
migration. Between iterations the host reads the merged hall of fame
once and checks the stop conditions.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from .models.evolve import (
    IslandState,
    expected_optimize_count,
    init_island_state,
    optimize_islands_constants,
    s_r_cycle_islands,
    simplify_population_islands,
)
from .models.options import Options, make_options
from .models.population import HallOfFame
from .models.trees import VAR
from .ops import kernel_eval
from .ops.losses import resolve_loss
from .parallel.migration import merge_hofs_across_islands, migrate
from .utils.device import resolve_device
from .utils.output import Candidate, hof_to_candidates, pareto_table
from .utils.rng import make_generator


@dataclasses.dataclass
class SearchState:
    island_states: IslandState  # leading (I,)
    global_hof: HallOfFame
    iteration: int = 0


@dataclasses.dataclass
class EquationSearchResult:
    candidates: List[Candidate]
    options: Options
    variable_names: Optional[Sequence[str]]
    device: torch.device
    state: Optional[SearchState] = None
    num_evals: float = 0.0
    search_time_s: float = 0.0
    iterations: int = 0

    def frontier(self) -> List[Candidate]:
        return self.candidates

    def best(self) -> Candidate:
        """Best trade-off frontier member by the score column; ties broken
        by lower loss."""
        if not self.candidates:
            raise ValueError("Search produced no valid equations")
        return max(self.candidates, key=lambda c: (c.score, -c.loss))

    def best_loss(self) -> Candidate:
        if not self.candidates:
            raise ValueError("Search produced no valid equations")
        return min(self.candidates, key=lambda c: c.loss)

    def predict(self, X, complexity: Optional[int] = None) -> np.ndarray:
        """Evaluate the selected equation on X (nfeatures, n) through the
        kernel's value mode on the search's device, at the search's working
        dtype (``Options.dtype``). The values come back as float16 numpy at
        float16 and as float32 numpy at float32 and at bfloat16, which
        numpy has no type for (float32 holds every bfloat16 value)."""
        if complexity is None:
            cand = self.best()
        else:
            matches = [c for c in self.candidates if c.complexity == complexity]
            if not matches:
                raise ValueError(f"No frontier member at complexity {complexity}")
            cand = matches[0]
        X = np.asarray(X, np.float32)
        n_used = int(torch.where(cand.tree.kind == VAR, cand.tree.feat, -1).max()) + 1
        if X.ndim != 2 or X.shape[0] < n_used:
            raise ValueError(f"X must be (nfeatures >= {n_used}, n), got {X.shape}")
        Xt = torch.as_tensor(X, device=self.device).to(self.options.dtype)
        tree = cand.tree.map(lambda x: x.to(self.device).unsqueeze(0))
        y, ok = kernel_eval.eval_trees(tree, Xt, self.options.operators)
        if y.dtype == torch.bfloat16:
            y = y.to(torch.float32)
        if not bool(ok[0]):
            import warnings

            warnings.warn("predict: equation evaluation hit NaN/Inf on this "
                          "input; output contains non-finite values",
                          RuntimeWarning, stacklevel=2)
        return y[0].cpu().numpy()

    def __repr__(self):
        return pareto_table(self.candidates)


def _curmaxsize(options: Options, iteration: int, niterations: int) -> int:
    """Maxsize warm-up: with warmup_maxsize_by=w > 0 the size cap ramps
    3 -> maxsize over the first w fraction of iterations."""
    if options.warmup_maxsize_by <= 0:
        return options.maxsize
    frac = iteration / max(niterations * options.warmup_maxsize_by, 1e-9)
    return min(3 + int((options.maxsize - 3) * min(frac, 1.0)), options.maxsize)


def _baseline_loss(X: torch.Tensor, y: torch.Tensor, weights, options) -> float:
    """Loss of the constant predictor mean(y), computed in y's dtype (the
    working dtype); 1.0 if not finite and positive."""
    loss_fn = resolve_loss(options.loss)
    avg = y.mean() if weights is None else (y * weights).sum() / weights.sum()
    elem = loss_fn(torch.full_like(y, float(avg)), y)
    base = float(elem.mean() if weights is None
                 else (elem * weights).sum() / weights.sum())
    return base if np.isfinite(base) and base > 0 else 1.0


def equation_search(X, y, *, weights=None,
                    variable_names: Optional[Sequence[str]] = None,
                    options: Optional[Options] = None, niterations: int = 10,
                    on_iteration=None, device="cuda",
                    **option_kwargs) -> EquationSearchResult:
    """Search for expressions f(X) ~= y on one device.

    X: (nfeatures, n); y: (n,); weights optional (n,). Extra kwargs build
    the Options. ``on_iteration(iteration, candidates)`` is called after
    every iteration. The search runs on ``device`` (default the CUDA card;
    raises when there is none) — pass ``device="cpu"`` for the plain
    PyTorch path. The data is checked in float32, then held on the device
    in the working dtype (``Options.precision``: float32, bfloat16 or
    float16), as the JAX package's ``make_dataset`` holds it."""
    dev = resolve_device(device)
    if options is None:
        options = make_options(**option_kwargs)
    elif option_kwargs:
        raise ValueError("Pass either options= or option kwargs, not both")
    X = np.asarray(X, np.float32)
    y = np.asarray(y, np.float32)
    if X.ndim != 2:
        raise ValueError("X must be (nfeatures, n)")
    if y.ndim != 1:
        raise NotImplementedError(
            "multi-output y comes with a later slice of the PyTorch port")
    if y.shape[0] != X.shape[1]:
        raise ValueError(f"y rows {y.shape[0]} must match X columns {X.shape[1]}")
    if not (np.isfinite(X).all() and np.isfinite(y).all()):
        raise ValueError("X and y must be finite (the data_policy front door "
                         "is not ported yet)")
    dtype = options.dtype
    Xt = torch.as_tensor(X, device=dev).to(dtype)
    yt = torch.as_tensor(y, device=dev).to(dtype)
    wt = None if weights is None else torch.as_tensor(
        np.asarray(weights, np.float32), device=dev).to(dtype)
    over = 0 if dtype == torch.float32 else int(
        (~torch.isfinite(Xt)).sum() + (~torch.isfinite(yt)).sum())
    if over:
        raise ValueError(
            f"{over} finite value(s) overflowed the precision="
            f"'{options.precision}' cast (|value| beyond the working dtype's "
            "range): rescale the data or use a wider precision")
    baseline = _baseline_loss(Xt, yt, wt, options)
    nfeatures = X.shape[0]
    I = options.npopulations

    t_start = time.time()
    gen = make_generator(options.seed, dev)
    states = init_island_state(gen, options, nfeatures, Xt, yt, wt, baseline, I)
    ghof = merge_hofs_across_islands(states.hof)
    early_stop = options.early_stop_fn()
    # the `optimize` mutation: one iteration-level pass sized to the
    # expected number of sampled optimize slots
    n_opt_mut = expected_optimize_count(options)
    cands: List[Candidate] = []
    it = -1
    for it in range(niterations):
        cm = _curmaxsize(options, it, niterations)
        states = s_r_cycle_islands(gen, states, cm, Xt, yt, wt, baseline,
                                   options)
        states = simplify_population_islands(states, cm, Xt, yt, wt,
                                             baseline, options)
        if options.should_optimize_constants and options.optimizer_probability > 0:
            states = optimize_islands_constants(gen, states, Xt, yt, wt,
                                                baseline, options)
        if n_opt_mut > 0:
            states = optimize_islands_constants(
                gen, states, Xt, yt, wt, baseline, options,
                probability=min(1.0, n_opt_mut / options.npop),
                count_optimize_telemetry=True)
        ghof = merge_hofs_across_islands(states.hof)
        states = migrate(gen, states, ghof, options)
        cands = hof_to_candidates(ghof, options, variable_names)
        if options.verbosity > 0:
            best = min((c.loss for c in cands), default=float("inf"))
            print(f"iteration {it + 1}/{niterations}: best loss {best:.6g}, "
                  f"{time.time() - t_start:.1f} s", flush=True)
        if on_iteration is not None:
            on_iteration(it, cands)
        if (options.timeout_in_seconds is not None
                and time.time() - t_start > options.timeout_in_seconds):
            break
        if (options.max_evals is not None
                and float(states.num_evals.sum()) > options.max_evals):
            break
        if early_stop is not None and any(
                early_stop(c.loss, c.complexity) for c in cands):
            break
    if it < 0:
        cands = hof_to_candidates(ghof, options, variable_names)
    return EquationSearchResult(
        candidates=cands,
        options=options,
        variable_names=variable_names,
        device=dev,
        state=SearchState(states, ghof, it + 1),
        num_evals=float(states.num_evals.sum()),
        search_time_s=time.time() - t_start,
        iterations=it + 1,
    )
