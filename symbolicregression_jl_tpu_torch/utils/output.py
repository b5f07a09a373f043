"""Hall-of-fame rendering, the CSV checkpoint and its reader (counterpart
of ``symbolicregression_jl_tpu/utils/output.py``).

The checkpoint is written twice, to the path and to ``path.bkup``, so a
kill in the middle of one write leaves the other whole; the reader falls
back to the backup when the main file is missing or torn."""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..models.options import Options
from ..models.population import HallOfFame, calculate_pareto_frontier
from ..models.trees import (
    TreeBatch, decode_tree, encode_tree, expr_to_string, parse_expression,
)


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
    # float16 value; numpy has no bfloat16), float64 at float64
    losses = hof.losses.cpu().to(torch.float64 if hof.losses.dtype
                                 == torch.float64 else torch.float32).numpy()
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


def save_hof_csv(candidates: List[Candidate], path: str) -> None:
    """Write the frontier to ``path``, then to ``path.bkup``."""
    body = "Complexity;Loss;Equation\n" + "".join(
        f"{c.complexity};{c.loss:.12g};{c.equation}\n" for c in candidates)
    for p in (path, path + ".bkup"):
        with open(p, "w") as f:
            f.write(body)


def _parse_hof_csv(path, options, variable_names):
    """One checkpoint file -> (candidates, clean); ``clean`` is False when
    a line did not parse (a file torn by a kill in mid-write). The trees
    are float32 CPU tensors."""
    out: List[Candidate] = []
    clean = True
    with open(path) as f:
        f.readline()  # header
        for line in f:
            parts = line.rstrip("\n").split(";", 2)
            try:
                if len(parts) != 3:
                    raise ValueError("short line")
                c, loss, eq = parts
                expr = parse_expression(eq, options.operators, variable_names)
                out.append(Candidate(
                    complexity=int(c), loss=float(loss), score=0.0,
                    equation=eq,
                    tree=encode_tree(expr, options.max_len, device="cpu")))
            except (ValueError, KeyError):
                clean = False
    return out, clean


def load_hof_csv(path: str, options: Options,
                 variable_names=None) -> List[Candidate]:
    """The candidates of a checkpoint, equations parsed again by
    ``parse_expression``. A missing or torn main file falls back to
    ``.bkup`` when the backup parses clean (the main file, the newer
    write, wins ties)."""
    bkup = path + ".bkup"
    cands, clean = (_parse_hof_csv(path, options, variable_names)
                    if os.path.exists(path) else ([], False))
    if not clean and os.path.exists(bkup):
        bcands, bclean = _parse_hof_csv(bkup, options, variable_names)
        if bclean or len(bcands) > len(cands):
            return bcands
    return cands
