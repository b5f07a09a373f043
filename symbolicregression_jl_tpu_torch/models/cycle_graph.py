"""The cycle loop as one captured CUDA graph, replayed once per cycle.

The PyTorch counterpart of the JAX package's compiled iteration
(``api._make_iteration_fn``'s cached jit), limited to the cycle: the body
of its ``lax.scan`` over the temperature schedule (``models/evolve.py``
``s_r_cycle_islands``) is captured once as a CUDA graph of
``evolve.cycle_step`` on static device buffers, and each cycle is one
replay. Inside the graph the step copies its result back into the state
buffers, so N replays are N cycles. The once-per-iteration window decay
(``move_window``) runs eagerly after the last replay, as in the eager
loop.

A ``CycleGraph`` is cached under (``Options._graph_key()``, the data's
shapes, the working dtype, the device), the counterpart of the JAX
package's lru-cached jit: it holds its own static X, y, weights,
baseline, temperature, ``curmaxsize`` and traced-scalar buffers, which
each search fills before its first replay. So a second search at the same
widths replays the graph the first one captured, with other data, another
``curmaxsize`` (a curriculum) or other traced scalars (``alpha``,
``parsimony``, ...). What the graph bakes in is the graph key's: shapes,
branch structure, and the kernel arguments passed by value (operator ids,
loss id and constants, row count, launch layout).

The random stream is the islands' threefry keys (``IslandState.key``)
and the minibatch chain's key, both static buffers: each replay's
threefry launches (``ops/kernel_rng.py``, one per draw plan: propose,
mutate, crossover, and the minibatch when batching) read them on the card
and the step writes their successors back, so the captured draws are the eager
step's draws and no generator state has to be carried into or out of the
graph. The kernels' launch counters are counted in Python at launch,
which a replay does not run: the graph records what its capture counted
and adds it once per replay, so every count means what it means on the
eager path. The warm-up before capture (on a side stream, on a copy of
the state and of the chain's key: it builds the kernel libraries and
fills the device tables, the draw plans' op tables, launch plans and the
allocator's blocks outside the capture) is set-up: its result is dropped, the live keys do not move,
and its launches are not counted.

On the CPU, which has no graphs, ``run`` runs the same step eagerly on the
same static buffers. On the card a failed capture or replay raises; there
is no fallback to the eager loop. A custom objective (``loss_function``)
runs inside the captured step (its vmapped ``eval_tree`` calls, one value-
mode launch per scoring call), as do per-island minibatches (the gather
and one scoring launch per island); an objective that reads a device
value on the host, or builds a tensor from Python data, fails at capture
with an error that names it. The float64 search captures its own graph
(the working dtype is in the key), its baseline a float64 device scalar.
A tenant-batched search (X (T, nfeat, nrows)) captures one graph for the
whole batch, keyed by X's shape with T in it: its baseline and its
minibatch chain's key are one per tenant, and each scoring call in it is
one per-set launch over the T datasets.
"""

from __future__ import annotations

import collections
import time
from typing import List, Optional

import torch

from ..ops import kernel_eval, kernel_grad, kernel_instr, kernel_rng
from .evolve import (
    IslandState, _map_tensors, batch_key, cycle_step, temperature_schedule,
)
from .fitness import score_dtype
from .options import TRACED_SCALAR_FIELDS, Options
from .parsimony import move_window

# every launch counter of the three kernel wrappers
LAUNCH_COUNTERS = (
    kernel_eval.LAUNCHES, kernel_eval.STORAGE_LAUNCHES,
    kernel_eval.LOSS_LAUNCHES, kernel_grad.LAUNCHES,
    kernel_grad.STORAGE_LAUNCHES, kernel_grad.LOSS_LAUNCHES,
    kernel_instr.LAUNCHES, kernel_instr.STORAGE_LAUNCHES,
    kernel_eval.USER_LAUNCHES, kernel_grad.USER_LAUNCHES,
    kernel_instr.USER_LAUNCHES, kernel_grad.VJP_LAUNCHES,
    kernel_rng.LAUNCHES, kernel_rng.PLAN_LAUNCHES,
)


def _leaves(x) -> List[torch.Tensor]:
    """The tensors of a nest of NamedTuples, in field order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [t for f in x for t in _leaves(f)]
    return []


def _copy_state(dst: IslandState, src: IslandState) -> None:
    for d, s in zip(_leaves(dst), _leaves(src)):
        d.copy_(s)


def _set(buf: torch.Tensor, value) -> None:
    """``buf`` := ``value`` on the device (a copy or a fill: no host
    read)."""
    if isinstance(value, torch.Tensor):
        buf.copy_(value)
    else:
        buf.fill_(value)


def _snapshot() -> list:
    return [dict(c) for c in LAUNCH_COUNTERS]


def _restore(snap: list) -> None:
    for c, s in zip(LAUNCH_COUNTERS, snap):
        c.clear()
        c.update(s)


class CycleGraph:
    """Static buffers for one (graph key, shapes, dtype, device), the
    captured cycle step on them (on the card), and its statistics:
    ``captures``, ``replays``, ``capture_s`` and ``pool_bytes`` (the device
    memory the capture reserved for the graph's private pool)."""

    def __init__(self, options: Options, states: IslandState, X, y,
                 weights):
        self.options = options  # its graph fields are the graph's
        self.device = device = X.device
        self.X = torch.empty_like(X)
        self.y = torch.empty_like(y)
        self.weights = None if weights is None else torch.empty_like(weights)
        f32 = dict(dtype=torch.float32, device=device)
        # one per tenant in a tenant-batched search (X (T, nfeat, nrows))
        lead = tuple(X.shape[:-2])
        self.baseline = torch.zeros(lead, dtype=score_dtype(X.dtype),
                                    device=device)
        self.temperature = torch.ones((), **f32)
        self.curmaxsize = torch.zeros((), dtype=torch.int64, device=device)
        self.scalars = tuple(torch.zeros((), **f32)
                             for _ in TRACED_SCALAR_FIELDS)
        self.state = _map_tensors(torch.empty_like, states)
        self.bkey = torch.zeros(lead + (2,), dtype=torch.int64,
                                device=device)
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self.launch_delta: list = []
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0
        self.pool_bytes = 0

    def load(self, states: IslandState, curmaxsize, X, y, weights, baseline,
             options: Options) -> None:
        """Fill the static buffers with one search's data, state, bounds
        and traced scalars (copies and fills on the device: no host
        read)."""
        self.X.copy_(X)
        self.y.copy_(y)
        if self.weights is not None:
            self.weights.copy_(weights)
        _set(self.baseline, baseline)
        _set(self.curmaxsize, curmaxsize)
        for buf, f in zip(self.scalars, TRACED_SCALAR_FIELDS):
            _set(buf, getattr(options, f))
        _copy_state(self.state, states)
        self.bkey.copy_(batch_key(states, X))

    def _step(self, out: IslandState, bkey: torch.Tensor) -> None:
        """One cycle on the static buffers, its result copied into ``out``
        and the chain's next key into ``bkey``."""
        opts = self.options.bind_scalars(self.scalars)
        new, nkey = cycle_step(self.state, self.bkey, self.temperature,
                               self.curmaxsize, self.X, self.y, self.weights,
                               self.baseline, opts)
        _copy_state(out, new)
        bkey.copy_(nkey)

    def capture(self) -> None:
        """Warm up on a side stream, then capture one step. Raises if the
        card refuses the capture."""
        before = _snapshot()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            scratch = _map_tensors(torch.clone, self.state)
            self._step(scratch, self.bkey.clone())
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)
        del scratch
        _restore(before)
        graph = torch.cuda.CUDAGraph()
        t0 = time.time()
        try:
            with torch.cuda.graph(graph):
                # after the context's own synchronize and empty_cache
                reserved = torch.cuda.memory_reserved(self.device)
                self._step(self.state, self.bkey)
        except RuntimeError as e:
            fn = self.options.loss_function
            if fn is None:
                raise
            raise RuntimeError(
                f"the cycle step with the custom objective {fn!r} "
                "(Options.loss_function) could not be captured in a CUDA "
                "graph: the objective must be tensor math on the card, with "
                f"no read of a device value on the host ({e})") from e
        finally:
            after = _snapshot()
            _restore(before)
        torch.cuda.synchronize(self.device)
        self.capture_s += time.time() - t0
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.launch_delta = [
            {k: v - b.get(k, 0) for k, v in a.items() if v != b.get(k, 0)}
            for a, b in zip(after, before)]
        self.graph = graph
        self.captures += 1

    def run(self, ncycles: int, temps: torch.Tensor) -> None:
        """``ncycles`` cycles on the static state at temperatures
        ``temps[0:ncycles]``: replays of the captured step on the card, the
        same step run eagerly on the CPU."""
        if self.device.type != "cuda":
            for c in range(ncycles):
                self.temperature.copy_(temps[c])
                self._step(self.state, self.bkey)
            return
        if self.graph is None:
            self.capture()
        for c in range(ncycles):
            self.temperature.copy_(temps[c])
            self.graph.replay()
            for counter, delta in zip(LAUNCH_COUNTERS, self.launch_delta):
                for k, v in delta.items():
                    counter[k] = counter.get(k, 0) + v
        self.replays += ncycles


CACHE_SIZE = 8  # graphs kept, least recently used dropped first
_CACHE: "collections.OrderedDict[tuple, CycleGraph]" = collections.OrderedDict()


def cache_key(options: Options, X, y, weights) -> tuple:
    """What a captured cycle bakes in: the Options' graph fields, the
    data's shapes, the working dtype and the device."""
    return (options._graph_key(), tuple(X.shape), tuple(y.shape),
            None if weights is None else tuple(weights.shape), X.dtype,
            X.device)


def cycle_graph(options: Options, states: IslandState, X, y,
                weights) -> CycleGraph:
    """The cached ``CycleGraph`` of this search's key, made on first use."""
    key = cache_key(options, X, y, weights)
    g = _CACHE.get(key)
    if g is None:
        g = _CACHE[key] = CycleGraph(options, states, X, y, weights)
        while len(_CACHE) > CACHE_SIZE:
            _CACHE.popitem(last=False)
    _CACHE.move_to_end(key)
    return g


def clear_cache() -> None:
    """Drop every cached graph and its buffers."""
    _CACHE.clear()


def s_r_cycle_islands_graph(states: IslandState, curmaxsize, X, y,
                            weights, baseline, options: Options,
                            ncycles: Optional[int] = None) -> IslandState:
    """``evolve.s_r_cycle_islands`` through the cached graph of this
    search: load the state, run ``ncycles`` cycles (replays on the card),
    then the window decay. Returns a state of its own (a copy of the
    static buffers), so a later search that reuses the buffers leaves it
    as it is."""
    ncycles = ncycles or options.ncycles_per_iteration
    g = cycle_graph(options, states, X, y, weights)
    g.load(states, curmaxsize, X, y, weights, baseline, options)
    g.run(ncycles, temperature_schedule(ncycles, options.annealing,
                                        X.device))
    out = _map_tensors(torch.clone, g.state)
    return out._replace(stats=move_window(out.stats))
