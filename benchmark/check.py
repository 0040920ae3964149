"""Whether the timed path's first updates are correct: the numbers that
compare the program with the plain reference, each against its limit.

  batch_diff  elements of the loader's batches that differ from the
              batches the reference assembles from the corpus (ids, masks,
              labels, pixels, neighbour texts and positions); exact.
  tower_gap   each frozen tower's pooled outputs in the first update's
              micro-batches: the worst row's distance from the
              reference's, over that row's norm or the median row's,
              whichever is larger; the worst tower.
  loss_gap    the worst update's |loss - reference loss| / reference loss.
  grad_gap    the first gradient as AdamW took it: the worst leaf's
              |norm - reference norm| over the reference's norm of that
              leaf or of the median leaf, whichever is larger.
  change_gap  the same for the norm of each leaf's change over the
              updates, over the leaves whose reference gradient is at
              least a thousandth of the median leaf's (a key's bias, under
              softmax, has none and moves by round-off alone).
  optim_diff  how far the program's optimizer departs from the
              configuration, as its file (benchmark/optimizers/) reads it:
              AdamW's betas, eps and weight decay in each group, and each
              trainable leaf held other than once; exact. The first three
              updates of a warm-up cannot show these settings (Adam's first
              steps are about sign(g) x lr; the decay is lr x wd x p), so
              they are read where they are set.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import numpy as np
import torch

NAMES = ("batch_diff", "tower_gap", "loss_gap", "grad_gap", "change_gap",
         "optim_diff")
TINY_GRADIENT = 1e-3


def batch_diff(got: List[Dict], want: List[Dict]) -> float:
    diff = 0
    for g, w in zip(got, want):
        for key in set(g) | set(w):
            if key not in g or key not in w:
                diff += int(np.asarray(g.get(key, w.get(key))).size)
                continue
            a, b = np.asarray(g[key]), np.asarray(w[key])
            if a.shape != b.shape:
                diff += max(a.size, b.size)
            else:
                diff += int((a.astype(np.int64) != b.astype(np.int64)).sum())
    return float(diff)


def tower_gap(got: Dict[str, List[torch.Tensor]],
              want: Dict[str, List[torch.Tensor]]) -> float:
    if set(got) != set(want):
        return float("inf")
    return max((_rows_gap(got[k], want[k]) for k in want), default=0.0)


def _rows_gap(got: List[torch.Tensor], want: List[torch.Tensor]) -> float:
    g = torch.cat([t.float().reshape(-1, t.shape[-1]).cpu() for t in got])
    w = torch.cat([t.float().reshape(-1, t.shape[-1]).cpu() for t in want])
    if g.shape != w.shape:
        return float("inf")
    norms = w.norm(dim=1)
    floor = norms.median()
    return float(((g - w).norm(dim=1) / torch.maximum(norms, floor)).max())


def loss_gap(got: List[float], want: List[float]) -> float:
    if len(got) != len(want):
        return float("inf")
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def norm_gap(got: Dict[str, float], want: Dict[str, float],
             leaves: List[str]) -> float:
    if not leaves:
        return float("inf")
    floor = statistics.median(want[n] for n in leaves)
    worst = 0.0
    for n in leaves:
        gap = abs(got.get(n, float("inf")) - want[n])
        denom = max(want[n], floor)
        worst = max(worst, gap / denom if denom > 0
                    else (0.0 if gap == 0 else float("inf")))
    return worst


def as_readings(run, batches: List[Dict], optim_diff: float = 0.0) -> Dict:
    """A reference ``Run`` in the place of the program's readings (the
    control and the planted faults); ``optim_diff``: the settings in which
    its optimizer departs from the configuration."""
    return dict(batches=batches, reference_batches=batches,
                tower=run.tower, losses=run.losses,
                grad_norms=run.grad_norms, change_norms=run.change_norms,
                optim_diff=optim_diff)


def numbers(program: Dict, reference) -> Dict[str, float]:
    """The numbers of a program's readings (``batches``, ``tower``,
    ``losses``, ``grad_norms``, ``change_norms``, ``optim_diff``) against
    the reference's ``Run`` and assembled ``batches`` (``reference_batches``)."""
    ref = reference
    leaves = sorted(ref.grad_norms)
    median = statistics.median(ref.grad_norms.values())
    moved = [n for n in leaves
             if ref.grad_norms[n] >= TINY_GRADIENT * median]
    return {
        "batch_diff": batch_diff(program["batches"],
                                 program["reference_batches"]),
        "tower_gap": tower_gap(program["tower"], ref.tower),
        "loss_gap": loss_gap(program["losses"], ref.losses),
        "grad_gap": norm_gap(program["grad_norms"], ref.grad_norms, leaves),
        "change_gap": norm_gap(program["change_norms"], ref.change_norms,
                               moved),
        "optim_diff": program["optim_diff"],
    }


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(np.isfinite(values[k]) and values[k] <= limits[k]
               for k in NAMES)
