"""Tenant-batched search engine: many same-shape jobs, one search
(counterpart of ``symbolicregression_jl_tpu/serving/batched.py``).

``batched_equation_search`` stacks T independent ``(X, y, weights)``
problems along a leading tenants axis and runs the solo search's
iteration (``api._iterate``) once for all of them: X (T, nfeat, n), the
baselines (T,), and T * I islands tenant-major on the island axis. Every
cycle is one replay of one captured CUDA graph for the whole batch, and
each scoring, rescore and constant-optimisation launch covers every
tenant through the kernels' per-dataset form (``ops/kernel_eval.py``,
``ops/kernel_grad.py``). So the fixed cost of a search (the cycle's small
kernels, the host loop) is paid once for the batch instead of once per
job.

The contract (the JAX package's ``docs/serving.md``):

* **Bit-identity** — tenant t's hall of fame, losses, scores, island
  states and key equal the solo ``equation_search`` of the same Options
  (``tenants=1``) with ``seed=seeds[t]``, bit for bit. Threefry is
  elementwise in the key, so each tenant's key chain draws its solo
  draws; every island's step is its own; each kernel launch gives each
  dataset the layout its solo launch gives it; and what pools islands
  (migration, the hall-of-fame merge) acts within each tenant.
* **Per-tenant PRNG chains** — tenant t's master key is
  ``PRNGKey(seeds[t])``, split per iteration as the solo loop splits it.

Same-Options only: a batch shares one captured graph, so every tenant
runs the same graph-shaping Options. Not yet in the port (ROADMAP.md
section A.11): the per-tenant telemetry and metrics gauges
(``registry=``, ``telemetry_dir=``); and with the memo bank (section
A.9), ``cache_fitness``, which Options refuses.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import api
from ..models.dataset import make_dataset, update_baseline_loss
from ..models.evolve import _map_tensors, expected_optimize_count
from ..models.fitness import score_dtype
from ..models.options import Options, make_options
from ..utils import rng
from ..utils.device import resolve_device
from ..utils.output import hof_to_candidates

TELEMETRY_REFUSED = ("comes with the telemetry/ slice (ROADMAP.md section "
                     "A.11)")


def _normalize_datasets(datasets) -> List[Tuple[Any, Any, Any]]:
    out = []
    for d in datasets:
        if isinstance(d, dict):
            out.append((d["X"], d["y"], d.get("weights")))
        elif len(d) == 3:
            out.append(tuple(d))
        elif len(d) == 2:
            out.append((d[0], d[1], None))
        else:
            raise ValueError(
                "each dataset must be (X, y), (X, y, weights), or a "
                "dict with keys X/y[/weights]"
            )
    if not out:
        raise ValueError("batched_equation_search needs >= 1 dataset")
    return out


def tenant_slice(x, t: int, islands: int):
    """Tenant t's block of a tenant-major nest of tensors: its ``islands``
    islands of an island-axis state, or its row of a (T, ...) one."""
    return _map_tensors(lambda a: a[t * islands:(t + 1) * islands]
                        if islands else a[t], x)


def batched_equation_search(
    datasets: Sequence,
    *,
    options: Optional[Options] = None,
    seeds: Optional[Sequence[int]] = None,
    niterations: int = 10,
    variable_names: Optional[Sequence[str]] = None,
    registry=None,
    telemetry_dir: Optional[str] = None,
    return_state: bool = False,
    runtests: bool = False,
    device="cuda",
    **option_kwargs,
) -> List["api.EquationSearchResult"]:
    """Run T same-shape symbolic-regression jobs as one batched search.

    datasets: sequence of ``(X, y)`` / ``(X, y, weights)`` tuples (or
    dicts) — every X must share one (nfeatures, n) shape, every y one
    (n,), and weights are all-or-none (mixing would change the unweighted
    tenants' loss reduction; the job server pads with explicit weights
    for exactly this reason). seeds: per-tenant seeds (default
    ``options.seed + t``); tenant t is bit-identical to the solo search of
    ``seed=seeds[t]``. Each dataset goes through the solo search's front
    door (``Options.data_policy``). ``device``: the card (default), or
    ``"cpu"`` for the plain PyTorch path. ``registry`` and
    ``telemetry_dir`` are not in the port yet and raise when given.

    Returns one ``EquationSearchResult`` per tenant, in input order; with
    ``return_state`` each holds its tenant's solo-shaped ``SearchState``.
    """
    if registry is not None:
        raise NotImplementedError(f"registry= {TELEMETRY_REFUSED}")
    if telemetry_dir is not None:
        raise NotImplementedError(f"telemetry_dir= {TELEMETRY_REFUSED}")
    jobs = _normalize_datasets(datasets)
    T = len(jobs)
    if options is None:
        option_kwargs.setdefault("tenants", max(T, 1))
        options = make_options(**option_kwargs)
    elif option_kwargs:
        raise ValueError("Pass either options= or option kwargs, not both")
    if options.tenants != T:
        options = dataclasses.replace(options, tenants=max(T, 1))
    if seeds is None:
        seeds = [options.seed + t for t in range(T)]
    if len(seeds) != T:
        raise ValueError(f"seeds has {len(seeds)} entries for {T} datasets")

    if T == 1:
        # one tenant is a solo search: the single-job path carries every
        # solo feature
        solo = dataclasses.replace(options, tenants=1, seed=int(seeds[0]))
        X0, y0, w0 = jobs[0]
        return [api.equation_search(
            X0, y0, weights=w0, options=solo, niterations=niterations,
            variable_names=variable_names, return_state=return_state,
            runtests=runtests, device=device)]

    # ---- admission: every tenant through the solo front door, then the
    # shape contract ----
    dev = resolve_device(device)
    fronts = []
    for t, (X, y, w) in enumerate(jobs):
        if np.ndim(y) != 1:
            raise ValueError(
                f"dataset {t}: serving jobs are single-output (y must "
                f"be 1-D, got shape {np.shape(y)})")
        X, ys, w, d, _ = api._front_door(X, y, w, options)
        fronts.append((X, ys[0], w, d))
    shape0 = fronts[0][0].shape
    for t, (X, _, _, _) in enumerate(fronts):
        if X.shape != shape0:
            raise ValueError(
                f"dataset {t} has X shape {X.shape}, tenant 0 has "
                f"{shape0}: a batch shares ONE padded shape — use the "
                "job server's pad ladder (serving.jobs) to quantize")
    has_w = [w is not None for _, _, w, _ in fronts]
    if any(has_w) and not all(has_w):
        raise ValueError(
            "weights must be all-or-none across a batch: an unweighted "
            "tenant's loss reduction (the mean) differs bitwise from "
            "ones-weights — pad with explicit weights (serving.jobs "
            "does) or drop them everywhere")

    # ---- each tenant's device data and baseline as its solo search makes
    # them, stacked ----
    dtype = options.dtype
    data = [update_baseline_loss(make_dataset(
        torch.as_tensor(X, device=dev).to(dtype), y, w, variable_names,
        dtype, dev), options) for X, y, w, _ in fronts]
    Xb = torch.stack([d.X for d in data])
    yb = torch.stack([d.y for d in data])
    wb = torch.stack([d.weights for d in data]) if all(has_w) else None
    bl = torch.tensor([d.baseline_loss for d in data],
                      dtype=score_dtype(dtype), device=dev)
    I = options.npopulations
    t_start = time.time()

    keys = torch.stack([rng.key(int(s), dev,
                                x64=options.precision == "float64")
                        for s in seeds])
    states, keys = api._fresh_islands(keys, options, shape0[0], Xb, yb, wb,
                                      bl)
    ghof = api.merge_hofs_across_islands(states.hof, T)
    n_opt_mut = expected_optimize_count(options)
    early_stop = options.early_stop_fn()
    it_done = 0
    for it in range(niterations):
        cm = api._curmaxsize(options, it, max(niterations, 1))
        keys, states, ghof = api._iterate(keys, states, cm, Xb, yb, wb, bl,
                                          options, n_opt_mut)
        it_done = it + 1
        if early_stop is not None and all(
                any(early_stop(c.loss, c.complexity)
                    for c in hof_to_candidates(tenant_slice(ghof, t, 0),
                                               options, variable_names))
                for t in range(T)):
            break

    # ---- per-tenant results ----
    search_time_s = time.time() - t_start
    results = []
    for t in range(T):
        ghof_t = tenant_slice(ghof, t, 0)
        states_t = tenant_slice(states, t, I)
        state = None
        if return_state:
            state = [api.SearchState(
                island_states=_map_tensors(torch.clone, states_t),
                global_hof=_map_tensors(torch.clone, ghof_t),
                iteration=it_done, rng_key=keys[t].clone())]
        results.append(api.EquationSearchResult(
            candidates=[hof_to_candidates(ghof_t, options, variable_names)],
            options=options,
            variable_names=variable_names,
            state=state,
            num_evals=float(states_t.num_evals.sum()),
            search_time_s=search_time_s,
            dataset_diagnostics=fronts[t][3].to_dict(),
            device=dev,
            iterations=it_done,
        ))
    return results
