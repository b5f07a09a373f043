"""Hall-of-fame rendering (counterpart of the candidate/table parts of
``symbolicregression_jl_tpu/utils/output.py``)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..models.options import Options
from ..models.population import HallOfFame, calculate_pareto_frontier
from ..models.trees import TreeBatch, decode_tree, expr_to_string


@dataclasses.dataclass
class Candidate:
    """One hall-of-fame entry, host-side."""

    complexity: int
    loss: float
    score: float  # -dlog(loss)/dcomplexity vs the previous frontier point
    equation: str
    tree: TreeBatch  # single tree (batch shape ()), CPU tensors

    def __repr__(self):
        return (f"Candidate(complexity={self.complexity}, loss={self.loss:.6g}, "
                f"equation={self.equation!r})")


def hof_to_candidates(hof: HallOfFame, options: Options,
                      variable_names: Optional[Sequence[str]] = None,
                      pareto_only: bool = True) -> List[Candidate]:
    """Decode the hall of fame into sorted host-side candidates with the
    Pareto score column. One device->host copy of the (small) table."""
    front = calculate_pareto_frontier(hof).cpu().numpy()
    exists = hof.exists.cpu().numpy()
    # the working dtype's losses, as float32 (which holds every bfloat16 and
    # float16 value; numpy has no bfloat16)
    losses = hof.losses.cpu().to(torch.float32).numpy()
    trees = hof.trees.map(lambda x: x.cpu())
    pick = front if pareto_only else exists
    out: List[Candidate] = []
    prev_loss, prev_c = None, None
    for i in np.where(pick)[0]:
        tree = trees[int(i)]
        eq = expr_to_string(decode_tree(tree), options.operators, variable_names)
        c = int(i) + 1
        loss = float(losses[i])
        if prev_loss is None or prev_loss <= 0 or loss <= 0:
            score = 0.0 if prev_loss is None else np.inf
        else:
            score = -(np.log(loss) - np.log(prev_loss)) / max(c - prev_c, 1)
        out.append(Candidate(complexity=c, loss=loss,
                             score=float(max(score, 0.0)), equation=eq,
                             tree=tree))
        prev_loss, prev_c = loss, c
    return out


def pareto_table(candidates: List[Candidate], title: str = "Hall of Fame") -> str:
    lines = ["-" * 78, title, "-" * 78,
             f"{'Complexity':<12}{'Loss':<16}{'Score':<12}Equation"]
    for c in candidates:
        lines.append(f"{c.complexity:<12}{c.loss:<16.8g}{c.score:<12.4g}{c.equation}")
    lines.append("-" * 78)
    return "\n".join(lines)
