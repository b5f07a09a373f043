"""Adaptive parsimony running statistics (counterpart of
``symbolicregression_jl_tpu/models/parsimony.py``): a per-complexity
frequency histogram, updated by scatter-add and decayed toward a fixed
window mass. Batched over any leading (island) dims."""

from __future__ import annotations

from typing import NamedTuple

import torch

WINDOW_SIZE = 100000.0


def normalize(frequencies: torch.Tensor) -> torch.Tensor:
    return frequencies / torch.clamp_min(
        frequencies.sum(dim=-1, keepdim=True), 1e-9)


class RunningSearchStatistics(NamedTuple):
    frequencies: torch.Tensor  # (..., actual_maxsize) float32
    window_size: float = WINDOW_SIZE

    @property
    def normalized(self) -> torch.Tensor:
        return normalize(self.frequencies)


def init_search_statistics(actual_maxsize: int, batch_shape=(),
                           device="cuda") -> RunningSearchStatistics:
    return RunningSearchStatistics(
        torch.ones(tuple(batch_shape) + (actual_maxsize,),
                   dtype=torch.float32, device=device))


def update_frequencies(stats: RunningSearchStatistics,
                       complexities: torch.Tensor) -> RunningSearchStatistics:
    """Add 1 at each observed complexity; out-of-range sizes are dropped.
    ``complexities`` has the statistics' batch dims plus one trailing axis
    of observations."""
    size = stats.frequencies.shape[-1]
    c = complexities - 1
    valid = (c >= 0) & (c < size)
    freqs = stats.frequencies.clone().scatter_add_(
        -1, c.clamp(0, size - 1), valid.to(stats.frequencies.dtype))
    return stats._replace(frequencies=freqs)


def move_window(stats: RunningSearchStatistics) -> RunningSearchStatistics:
    """Scale the total mass back to window_size when it exceeds it."""
    tot = stats.frequencies.sum(dim=-1, keepdim=True)
    scale = torch.where(tot > stats.window_size,
                        stats.window_size / torch.clamp_min(tot, 1e-9),
                        torch.ones_like(tot))
    return stats._replace(frequencies=stats.frequencies * scale)
