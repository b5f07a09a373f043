"""Carry the JAX package's search state across to this package.

The input is numpy only — e.g. ``jax.tree_util.tree_map(np.asarray,
state)._asdict()`` for an ``IslandState`` — as nested mappings or
attribute-bearing tuples; nothing of the JAX package is imported. Node
codes and operator numbering are the same in both packages, so trees
carry across unchanged, and so do the threefry keys (``uint32`` pairs
become int64 pairs of the same words), so a converted state continues the
reference's random stream. Constants, losses and scores keep their
working dtype (float32, bfloat16 or float16) bit for bit; the search
statistics and evaluation counts are float32 in both packages.
``search_state_from_numpy`` carries a whole ``SearchState`` (with its
master key ``rng_key``) so that ``equation_search(saved_state=[...])``
resumes the reference's search where it stopped.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .models.evolve import IslandState
from .models.parsimony import RunningSearchStatistics
from .models.population import HallOfFame, Population
from .models.trees import TreeBatch
from .utils.device import resolve_device


def _field(obj, name):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _tensor(x, dtype, device):
    return torch.as_tensor(np.array(x), device=device).to(dtype)


def _working(x, device):
    """A floating array of the working dtype, bit for bit: JAX hands
    bfloat16 over as an ``ml_dtypes`` array, which torch cannot read, so it
    crosses as its 16-bit pattern; float16 and float64 (a JAX search with
    ``jax_enable_x64``) cross as they are, anything else as float32."""
    a = np.array(x)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(a.view(np.uint16).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    if a.dtype in (np.float16, np.float64):
        return torch.from_numpy(a).to(device)
    return _tensor(a, torch.float32, device)


def trees_from_numpy(t, device="cuda") -> TreeBatch:
    dev = resolve_device(device)
    ints = [_tensor(_field(t, f), torch.int64, dev) for f in ("kind", "op", "feat")]
    return TreeBatch(*ints, _working(_field(t, "cval"), dev),
                     _tensor(_field(t, "length"), torch.int64, dev))


def population_from_numpy(p, device="cuda") -> Population:
    dev = resolve_device(device)
    return Population(
        trees=trees_from_numpy(_field(p, "trees"), dev),
        scores=_working(_field(p, "scores"), dev),
        losses=_working(_field(p, "losses"), dev),
        birth=_tensor(_field(p, "birth"), torch.int64, dev),
    )


def hall_of_fame_from_numpy(h, device="cuda") -> HallOfFame:
    dev = resolve_device(device)
    return HallOfFame(
        trees=trees_from_numpy(_field(h, "trees"), dev),
        scores=_working(_field(h, "scores"), dev),
        losses=_working(_field(h, "losses"), dev),
        exists=_tensor(_field(h, "exists"), torch.bool, dev),
    )


def keys_from_numpy(k, device="cuda") -> torch.Tensor:
    """Threefry keys (``uint32[..., 2]``) as this package's int64 keys."""
    return torch.as_tensor(np.array(k).astype(np.int64),
                           device=resolve_device(device))


def island_state_from_numpy(s, device="cuda") -> IslandState:
    """A JAX ``IslandState`` with a leading islands axis (as numpy) ->
    this package's ``IslandState`` on ``device``."""
    dev = resolve_device(device)
    stats = _field(s, "stats")
    return IslandState(
        pop=population_from_numpy(_field(s, "pop"), dev),
        stats=RunningSearchStatistics(
            _tensor(_field(stats, "frequencies"), torch.float32, dev)),
        hof=hall_of_fame_from_numpy(_field(s, "hof"), dev),
        key=keys_from_numpy(_field(s, "key"), dev),
        birth_counter=_tensor(_field(s, "birth_counter"), torch.int64, dev),
        num_evals=_tensor(_field(s, "num_evals"), torch.float32, dev),
        mut_counts=_tensor(_field(s, "mut_counts"), torch.int64, dev),
    )


def search_state_from_numpy(s, device="cuda"):
    """A JAX ``SearchState`` (its fields as numpy: ``island_states``,
    ``global_hof``, ``iteration``, ``rng_key``) -> this package's
    ``SearchState``: resuming from it continues the reference's search."""
    from .api import SearchState
    dev = resolve_device(device)
    key = _field(s, "rng_key")
    return SearchState(
        island_states=island_state_from_numpy(_field(s, "island_states"), dev),
        global_hof=hall_of_fame_from_numpy(_field(s, "global_hof"), dev),
        iteration=int(_field(s, "iteration")),
        rng_key=None if key is None else keys_from_numpy(key, dev))
