"""``equation_search``: the search loop on one device (counterpart of
``symbolicregression_jl_tpu/api.py``'s solo front door).

The front door runs on the host first: the data is cast to the working
dtype, counted (``models/dataset.validate_dataset``) and treated by
``Options.data_policy`` (``sanitize_dataset``), before any tensor reaches
the device. Every output row of ``y`` then gets its dataset, its master
threefry key (``PRNGKey(seed + 7919 * j)``, so output j of a joint search
is the solo search at that seed), its island state (fresh, resumed from
``saved_state`` or seeded from a ``warm_start_file``) and its merged hall
of fame, and the outputs take turns, one iteration each per round. Every
key is split as the JAX package's search splits it (``utils/rng.py``), so
a search draws the reference's random stream; a float64 search draws it
as the reference's ``jax_enable_x64`` mode does (its seed as an int64,
its default-dtype draws in float64: ``rng.key(..., x64=True)`` and
``rng.draw_dtype``).

One iteration = the cycle loop on every island (each cycle scores all
islands' children in one kernel call; on the card each cycle is one
replay of a captured CUDA graph, ``models/cycle_graph.py``, shared by
every output with the same data shapes; on the CPU the same step runs
eagerly), simplify + full-data rescore, constant optimisation (the
``should_optimize_constants`` pass, then the ``optimize``-mutation pass),
hall-of-fame merge across islands, migration. Between iterations the host
reads the merged hall of fame once, writes the CSV checkpoint and the
progress line, calls ``on_iteration(j, iteration, candidates)`` and checks
the stop conditions.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
import warnings
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .models.cycle_graph import s_r_cycle_islands_graph
from .models.dataset import (
    make_dataset,
    sanitize_dataset,
    update_baseline_loss,
    validate_dataset,
)
from .models.evolve import (
    IslandState,
    _map_tensors,
    expected_optimize_count,
    init_island_state,
    optimize_islands_constants,
    simplify_population_islands,
)
from .models.fitness import score_trees
from .models.options import Options, make_options
from .models.population import (
    HallOfFame,
    init_hall_of_fame,
    update_hall_of_fame,
)
from .models.trees import VAR, stack_trees
from .ops import kernel_eval
from .parallel.migration import merge_hofs_across_islands, migrate
from .utils.device import resolve_device
from .utils.output import (
    Candidate, hof_to_candidates, load_hof_csv, pareto_table, save_hof_csv,
)
from .utils.progress import (
    ProgressBar, QuitWatcher, ResourceMonitor, SearchProgress,
)
from .utils import rng


@dataclasses.dataclass
class SearchState:
    """One output's resumable state. ``rng_key`` is that output's master
    threefry key ((2,) int64) when the state was taken, the reference's
    ``SearchState.rng_key``, so a resumed search continues its key chain;
    None keeps the key derived from ``Options.seed``."""

    island_states: IslandState  # leading (I,)
    global_hof: HallOfFame
    iteration: int = 0
    rng_key: Optional[torch.Tensor] = None


@dataclasses.dataclass
class EquationSearchResult:
    """Hall of fame and Pareto frontier per output."""

    candidates: List[List[Candidate]]  # [output][rank]
    options: Options
    variable_names: Optional[Sequence[str]]
    state: Optional[List[SearchState]] = None  # with return_state=True
    num_evals: float = 0.0
    search_time_s: float = 0.0
    # the JAX package's evaluation memo-bank statistics; the port has no
    # memo bank (Options.cache_fitness raises), so always None
    cache_stats: Optional[dict] = None
    # what validate_dataset found and what data_policy did about it
    dataset_diagnostics: Optional[dict] = None
    device: Optional[torch.device] = None  # None: the card
    iterations: int = 0  # rounds run by this call

    @property
    def multi_output(self) -> bool:
        return len(self.candidates) > 1

    def frontier(self, output: int = 0) -> List[Candidate]:
        return self.candidates[output]

    def best(self, output: int = 0) -> Candidate:
        """Best trade-off frontier member by the score column
        -dlog(loss)/dcomplexity; ties broken by lower loss."""
        front = self.candidates[output]
        if not front:
            raise ValueError("Search produced no valid equations")
        return max(front, key=lambda c: (c.score, -c.loss))

    def best_loss(self, output: int = 0) -> Candidate:
        """Minimum-loss frontier member (usually the most complex)."""
        front = self.candidates[output]
        if not front:
            raise ValueError("Search produced no valid equations")
        return min(front, key=lambda c: c.loss)

    def predict(self, X, output: int = 0,
                complexity: Optional[int] = None) -> np.ndarray:
        """Evaluate the selected equation on X (nfeatures, n) through the
        kernel's value mode on the search's device, at the search's working
        dtype (``Options.dtype``). The values come back as float16 numpy at
        float16, float64 numpy at float64 and as float32 numpy at float32
        and at bfloat16, which numpy has no type for (float32 holds every
        bfloat16 value). A row that left the operators' domain warns."""
        cand = self._pick(output, complexity)
        dev = resolve_device("cuda" if self.device is None else self.device)
        X = np.asarray(X, np.float64 if self.options.dtype == torch.float64
                       else np.float32)
        n_used = int(torch.where(cand.tree.kind == VAR, cand.tree.feat, -1).max()) + 1
        if X.ndim != 2 or X.shape[0] < n_used:
            raise ValueError(f"X must be (nfeatures >= {n_used}, n), got {X.shape}")
        dtype = self.options.dtype
        Xt = torch.as_tensor(X, device=dev).to(dtype)
        tree = cand.tree.map(lambda x: x.to(dev).unsqueeze(0))
        tree = tree._replace(cval=tree.cval.to(dtype))
        y, ok = kernel_eval.eval_trees(tree, Xt, self.options.operators)
        if y.dtype == torch.bfloat16:
            y = y.to(torch.float32)
        if not bool(ok[0]):
            warnings.warn("predict: equation evaluation hit NaN/Inf on this "
                          "input; output contains non-finite values",
                          RuntimeWarning, stacklevel=2)
        return y[0].cpu().numpy()

    def sympy(self, output: int = 0, complexity: Optional[int] = None):
        """The selected equation as a sympy expression (needs sympy)."""
        from .utils.export import to_sympy

        cand = self._pick(output, complexity)
        return to_sympy(cand.tree, self.options, self.variable_names)

    def latex(self, output: int = 0, complexity: Optional[int] = None) -> str:
        """The selected equation as LaTeX (needs sympy)."""
        from .utils.export import to_latex

        cand = self._pick(output, complexity)
        return to_latex(cand.tree, self.options, self.variable_names)

    def _pick(self, output: int, complexity: Optional[int]) -> Candidate:
        if complexity is None:
            return self.best(output)
        matches = [c for c in self.candidates[output]
                   if c.complexity == complexity]
        if not matches:
            raise ValueError(f"No frontier member at complexity {complexity}")
        return matches[0]

    def __repr__(self):
        return "\n".join(
            pareto_table(cands, "Hall of Fame"
                         + (f" (output {j})" if self.multi_output else ""))
            for j, cands in enumerate(self.candidates))


def _curmaxsize(options: Options, iteration: int, niterations: int) -> int:
    """Maxsize warm-up: with warmup_maxsize_by=w > 0 the size cap ramps
    3 -> maxsize over the first w fraction of iterations. Callers pass the
    planned total counted from the first iteration (a resumed search's
    start included), so a resumed search continues the ramp."""
    if options.warmup_maxsize_by <= 0:
        return options.maxsize
    frac = iteration / max(niterations * options.warmup_maxsize_by, 1e-9)
    return min(3 + int((options.maxsize - 3) * min(frac, 1.0)), options.maxsize)


def _saved_state_compatible(state: SearchState, options: Options,
                            I: int) -> Tuple[bool, bool]:
    """(populations usable, hall of fame usable) under these Options: the
    shapes match, and the constants are in the working dtype."""
    try:
        pop = state.island_states.pop
        ok_pop = (pop.scores.shape[0] == I
                  and pop.scores.shape[1] == options.npop
                  and pop.trees.kind.shape[-1] == options.max_len
                  and pop.trees.cval.dtype == options.dtype
                  and state.island_states.hof.losses.shape[-1]
                  == options.actual_maxsize)
    except (AttributeError, IndexError):
        ok_pop = False
    try:
        ghof = state.global_hof
        ok_hof = (ghof.losses.shape[0] == options.actual_maxsize
                  and ghof.trees.kind.shape[-1] == options.max_len
                  and ghof.trees.cval.dtype == options.dtype)
    except (AttributeError, IndexError):
        ok_hof = False
    return ok_pop, ok_hof


def _seed_hof_islands(states: IslandState, source: HallOfFame,
                      options: Options) -> IslandState:
    """Fold a saved or loaded hall of fame into every island's hall of
    fame (a source slot that does not exist carries an inf loss and never
    enters)."""
    I = states.hof.losses.shape[0]
    each = lambda x: x.unsqueeze(0).expand((I,) + x.shape)
    seeded = update_hall_of_fame(states.hof, source.trees.map(each),
                                 each(source.scores), each(source.losses),
                                 options)
    return states._replace(hof=seeded)


def _warm_start_hof(path: str, options: Options, variable_names, X, y,
                    weights, baseline) -> Optional[HallOfFame]:
    """A hall of fame from a CSV checkpoint, its equations scored again on
    this dataset on the search's device; None (with a warning) when the
    file cannot be read."""
    try:
        cands = load_hof_csv(path, options, variable_names)
    except (OSError, ValueError) as e:
        warnings.warn(f"warm start: could not load {path!r}: {e}")
        return None
    if not cands:
        return None
    trees = stack_trees([c.tree for c in cands]).map(lambda x: x.to(X.device))
    trees = trees._replace(cval=trees.cval.to(options.dtype))
    scores, losses = score_trees(trees, X, y, weights, baseline, options)
    hof = init_hall_of_fame(options, (), X.device)
    return update_hall_of_fame(hof, trees, scores, losses, options)


def _multi_output_path(path: str, output: int) -> str:
    """Output j's variant of a checkpoint path, ``base.out{j}.ext`` (for
    the writer and the warm-start reader alike)."""
    root, ext = os.path.splitext(path)
    return f"{root}.out{output}{ext}"


def _front_door(X, y, weights, options: Options):
    """Cast, count and treat the data on the host: (X (nfeat, n), ys
    (nout, n), weights or None, as float32 numpy holding values of the
    working dtype (float64 numpy at float64), the diagnostics, whether y
    was 2-D). Finite values that the cast to float32 or to the working
    dtype turns infinite are counted as ``cast_overflow_cells`` with an
    error entry, and the policy treats them as the non-finite cells they
    became; at float64 the data keeps its double values, so no finite
    value overflows."""
    host = np.float64 if options.dtype == torch.float64 else np.float32
    X_raw, y_raw = np.asarray(X), np.asarray(y)
    X = np.asarray(X_raw, host)
    y = np.asarray(y_raw, host)
    if weights is not None:
        weights = np.asarray(weights, host)
    cast_overflow = 0
    if X_raw.dtype != host or y_raw.dtype != host:
        cast_overflow = int((np.isfinite(X_raw) & ~np.isfinite(X)).sum()
                            + (np.isfinite(y_raw) & ~np.isfinite(y)).sum())
    if options.dtype not in (torch.float32, torch.float64):
        # the values the device will hold, as float32 (which holds every
        # bfloat16 and float16 value)
        def held(a):
            return torch.from_numpy(a).to(options.dtype).float().numpy()

        Xw, yw = held(X), held(y)
        cast_overflow += int((np.isfinite(X) & ~np.isfinite(Xw)).sum()
                             + (np.isfinite(y) & ~np.isfinite(yw)).sum())
        X, y = Xw, yw
        if weights is not None:
            weights = held(weights)
    if X.ndim != 2:
        raise ValueError("X must be (nfeatures, n)")
    multi = y.ndim == 2
    ys = y if multi else y[None, :]
    if ys.shape[1] != X.shape[1]:
        raise ValueError(f"y rows {ys.shape[1]} must match X columns {X.shape[1]}")
    diags = validate_dataset(X, ys, weights)
    diags.cast_overflow_cells = cast_overflow
    if cast_overflow:
        diags.errors.append(
            f"{cast_overflow} finite value(s) overflowed the "
            f"precision='{options.precision}' cast (|value| beyond the "
            "working dtype's range) — rescale the data"
            + ("" if options.dtype == torch.float32
               else " or use a wider precision")
            + "; these cells are counted in the non-finite census above")
    X, ys, weights, diags = sanitize_dataset(X, ys, weights,
                                             options.data_policy, diags)
    return X, ys, weights, diags, multi


def _check_scheduling_kwargs(parallelism, numprocs, procs,
                             addprocs_function) -> None:
    """The reference's worker-scheduling keywords: validated, and a
    warning where they ask for something other than what runs."""
    if parallelism is not None:
        if not isinstance(parallelism, str):
            raise ValueError(f"unknown parallelism {parallelism!r}")
        p = parallelism[1:] if parallelism.startswith(":") else parallelism
        if p not in ("serial", "multithreading", "multiprocessing"):
            raise ValueError(f"unknown parallelism {parallelism!r}")
        if p != "multithreading":
            warnings.warn(
                f"parallelism={parallelism!r} has no effect: every island "
                "runs together on the one device in this process",
                stacklevel=3)
    if any(x is not None for x in (numprocs, procs, addprocs_function)):
        warnings.warn(
            "numprocs/procs/addprocs_function have no effect: worker "
            "processes are replaced by the islands' batch on the one "
            "device", stacklevel=3)


def equation_search(X, y, *, weights=None,
                    variable_names: Optional[Sequence[str]] = None,
                    options: Optional[Options] = None, niterations: int = 10,
                    saved_state: Optional[List[SearchState]] = None,
                    warm_start_file: Optional[str] = None,
                    return_state: bool = False, runtests: bool = True,
                    on_iteration: Optional[Callable] = None,
                    parallelism: Optional[str] = None,
                    numprocs: Optional[int] = None, procs=None,
                    addprocs_function=None, device="cuda",
                    **option_kwargs) -> EquationSearchResult:
    """Search for expressions f(X) ~= y on one device.

    X: (nfeatures, n); y: (n,) or (nout, n) for several outputs; weights
    optional (n,). Extra kwargs build the Options. The data goes through
    the front door (``Options.data_policy``; the census is
    ``result.dataset_diagnostics``), then is held on the device in the
    working dtype (``Options.precision``). ``saved_state`` (a list of
    ``SearchState``, one per output, as ``return_state=True`` returns it)
    resumes a search; a state whose shapes no longer fit the Options is
    recreated with a warning, keeping its hall of fame where that fits.
    ``warm_start_file`` seeds the halls of fame from a CSV checkpoint
    (``Options.output_file`` writes one per iteration; several outputs
    read and write ``base.out{j}.ext``). ``on_iteration(output,
    iteration, candidates)`` is called after every iteration. The search
    runs on ``device`` (default the CUDA card; raises when there is none)
    — pass ``device="cpu"`` for the plain PyTorch path.

    The reference's scheduling keywords are taken for drop-in migration:
    ``parallelism`` is validated (``":serial"`` spelling included) and
    warns unless it is ``"multithreading"``, since the islands always run
    together on the one device; ``numprocs`` / ``procs`` /
    ``addprocs_function`` warn that they have no effect. ``runtests``: the
    front door's census of the data (``models/dataset.py``) runs on every
    call, as the JAX package's preflight does with ``runtests=True``."""
    _check_scheduling_kwargs(parallelism, numprocs, procs, addprocs_function)
    dev = resolve_device(device)
    if options is None:
        options = make_options(**option_kwargs)
    elif option_kwargs:
        raise ValueError("Pass either options= or option kwargs, not both")
    if options.tenants > 1:
        raise ValueError(
            "equation_search is the solo front door (one dataset); "
            "Options.tenants > 1 runs many same-shape jobs as ONE "
            "batched program — use "
            "serving.batched_equation_search(datasets, options=...) "
            "or the srserve job queue (serving.jobs)"
        )
    return _search(X, y, weights, variable_names, options, niterations,
                   saved_state, warm_start_file, return_state, on_iteration,
                   dev)


def _fresh_islands(key, options: Options, nfeatures: int, X, y, weights,
                   baseline):
    """New islands from an output's master key, as the reference's
    ``_fresh_init``: (states, the master key's successor). With T tenants'
    keys (T, 2) and their data (X (T, nfeat, n), ...), every tenant's
    islands as its solo search makes them, tenant-major, and the T
    successors."""
    k = rng.split(key, 2)
    init_keys = rng.split(k[..., 0, :], options.npopulations).reshape(-1, 2)
    return (init_island_state(init_keys, options, nfeatures, X, y, weights,
                              baseline),
            k[..., 1, :])


def _iterate(key, states: IslandState, curmaxsize, X, y, weights, baseline,
             options: Options, n_opt_mut: float):
    """One iteration from an output's master key (2,): the cycles,
    simplify and rescore, the constant-optimisation passes, the hall-of-
    fame merge and migration, each key split as the reference's host loop
    and iteration split it. Returns (the master key's successor, states,
    the merged hall of fame). With T tenants' keys (T, 2) over their data
    (X (T, nfeat, n), ...) and islands, every tenant's iteration is its
    solo one: (keys (T, 2), states, halls of fame (T, ...))."""
    tenants = X.shape[0] if X.dim() == 3 else 0
    k = rng.split(key, 2)
    key = k[..., 0, :]
    k_mig, k_opt, k_opt_mut = rng.split(k[..., 1, :], 3).unbind(-2)
    I = options.npopulations
    states = s_r_cycle_islands_graph(states, curmaxsize, X, y, weights,
                                     baseline, options)
    states = simplify_population_islands(states, curmaxsize, X, y, weights,
                                         baseline, options)
    if options.should_optimize_constants and options.optimizer_probability > 0:
        states = optimize_islands_constants(
            rng.split(k_opt, I).reshape(-1, 2), states, X, y, weights,
            baseline, options)
    if n_opt_mut > 0:
        states = optimize_islands_constants(
            rng.split(k_opt_mut, I).reshape(-1, 2), states, X, y, weights,
            baseline, options,
            probability=min(1.0, n_opt_mut / options.npop),
            count_optimize_telemetry=True)
    ghof = merge_hofs_across_islands(states.hof, tenants)
    states = migrate(k_mig, states, ghof, options)
    return key, states, ghof


def _search(X, y, weights, variable_names, options: Options, niterations,
            saved_state, warm_start_file, return_state, on_iteration, dev):
    X, ys, weights, diags, multi = _front_door(X, y, weights, options)
    if diags.warnings and options.verbosity > 0:
        for msg in diags.warnings:
            print(f"dataset warning: {msg}", file=sys.stderr)
    nout, nfeatures = ys.shape[0], X.shape[0]
    if saved_state is not None and len(saved_state) != nout:
        raise ValueError(f"saved_state holds {len(saved_state)} output(s), "
                         f"y has {nout}")
    I = options.npopulations
    dtype = options.dtype
    Xt = torch.as_tensor(X, device=dev).to(dtype)
    t_start = time.time()
    early_stop = options.early_stop_fn()
    # the `optimize` mutation: one iteration-level pass sized to the
    # expected number of sampled optimize slots
    n_opt_mut = expected_optimize_count(options)

    data, live_states, live_hofs, keys, start_iters = [], [], [], [], []
    for j in range(nout):
        ds = update_baseline_loss(
            make_dataset(Xt, ys[j], weights, variable_names, dtype, dev),
            options)
        Xj, yj, wj, bl = ds.X, ds.y, ds.weights, ds.baseline_loss
        key = rng.key(options.seed + 7919 * j, dev,
                      x64=options.precision == "float64")
        if saved_state is not None:
            state = saved_state[j]
            ok_pop, ok_hof = _saved_state_compatible(state, options, I)
            if ok_pop:
                if state.rng_key is not None:
                    key = torch.as_tensor(state.rng_key).to(
                        dev, torch.int64, copy=True)
                # copies: the caller's state stays as it was
                states = _map_tensors(lambda x: x.to(dev, copy=True),
                                      state.island_states)
                ghof = _map_tensors(lambda x: x.to(dev, copy=True),
                                    state.global_hof)
            else:
                warnings.warn(
                    "saved_state is incompatible with these Options "
                    "(npopulations/npop/maxsize/precision changed); "
                    "recreating populations"
                    + (" but keeping the saved hall of fame" if ok_hof
                       else " and the hall of fame"))
                states, key = _fresh_islands(key, options, nfeatures, Xj,
                                             yj, wj, bl)
                if ok_hof:
                    states = _seed_hof_islands(
                        states, _map_tensors(lambda x: x.to(dev),
                                             state.global_hof), options)
                ghof = merge_hofs_across_islands(states.hof)
            start_iter = state.iteration
        else:
            states, key = _fresh_islands(key, options, nfeatures, Xj, yj, wj,
                                         bl)
            if warm_start_file is not None:
                path = (_multi_output_path(warm_start_file, j) if multi
                        else warm_start_file)
                warm = _warm_start_hof(path, options, variable_names, Xj, yj,
                                       wj, bl)
                if warm is not None:
                    states = _seed_hof_islands(states, warm, options)
            ghof = merge_hofs_across_islands(states.hof)
            start_iter = 0
        data.append((Xj, yj, wj, bl))
        live_states.append(states)
        live_hofs.append(ghof)
        keys.append(key)
        start_iters.append(start_iter)

    progress = SearchProgress(niterations * nout, options)
    bar = ProgressBar(niterations * nout,
                      **({"width": options.terminal_width}
                         if options.terminal_width else {}))
    monitor = ResourceMonitor(verbosity=options.verbosity)
    quit_watcher = QuitWatcher(enabled=options.verbosity > 0)
    its = [s - 1 for s in start_iters]
    latest: List[Optional[List[Candidate]]] = [None] * nout
    evals = [0.0] * nout
    global_it = rounds = 0
    stop_all = False
    for step in range(niterations):
        rounds = step + 1
        for j in range(nout):
            Xj, yj, wj, bl = data[j]
            states = live_states[j]
            its[j] = it = start_iters[j] + step
            cm = _curmaxsize(options, it, max(start_iters[j] + niterations, 1))
            t_dev = time.time()
            keys[j], states, ghof = _iterate(keys[j], states, cm, Xj, yj, wj,
                                             bl, options, n_opt_mut)
            live_states[j], live_hofs[j] = states, ghof
            # the host's one read of the iteration: it waits for the device
            cands = latest[j] = hof_to_candidates(ghof, options,
                                                  variable_names)
            t_host = time.time()
            progress.note_iteration(I)
            global_it += 1
            if options.output_file and options.save_to_file:
                save_hof_csv(cands, _multi_output_path(options.output_file, j)
                             if multi else options.output_file)
            if options.verbosity > 0:
                best = min((c.loss for c in cands), default=float("inf"))
                progress.report(global_it - 1, best,
                                float(states.num_evals.sum()),
                                prefix=f"[output {j}] " if multi else "")
                if options.progress:
                    bar.update(global_it, pareto_table(cands))
            if on_iteration is not None:
                on_iteration(j, it, cands)
            monitor.note(t_host - t_dev, time.time() - t_host)
            monitor.maybe_warn()
            if (options.timeout_in_seconds is not None
                    and time.time() - t_start > options.timeout_in_seconds):
                stop_all = True
            elif options.max_evals is not None:
                evals[j] = float(states.num_evals.sum())
                stop_all = sum(evals) > options.max_evals
            if quit_watcher.should_quit():
                stop_all = True
            if stop_all:
                break
        if stop_all:
            break
        if early_stop is not None and all(
                c is not None and any(early_stop(m.loss, m.complexity)
                                      for m in c) for c in latest):
            break

    results, out_states = [], []
    total_evals = 0.0
    for j in range(nout):
        total_evals += float(live_states[j].num_evals.sum())
        results.append(hof_to_candidates(live_hofs[j], options,
                                         variable_names))
        out_states.append(SearchState(
            island_states=live_states[j], global_hof=live_hofs[j],
            iteration=its[j] + 1, rng_key=keys[j].clone()))
    return EquationSearchResult(
        candidates=results,
        options=options,
        variable_names=variable_names,
        state=out_states if return_state else None,
        num_evals=total_evals,
        search_time_s=time.time() - t_start,
        dataset_diagnostics=diags.to_dict(),
        device=dev,
        iterations=rounds,
    )


EquationSearch = equation_search
