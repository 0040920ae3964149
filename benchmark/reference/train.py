"""The first updates of a training run, worked out in plain PyTorch.

Each update takes its batch in ``grad_accumulation_steps`` micro-batches
of consecutive rows, sums the micro-batches' gradients of the mean CE and
divides by their number, clips the trainable gradients to the global norm
``grad_clip``, and takes one step of the configuration's optimizer
(``benchmark/optimizers/<optimizer>.py``, its ``Reference``) at the
learning rate of a linear warm-up over ``lr_warmup_steps`` updates. The
trainable leaves are every part's ``extra`` group (the fusion block, the
adapters) and the ``hf`` group of a part marked ``trains``; the towers
never train. Dropout masks come from a generator seeded as the training
loop seeds its dropout stream, from (seed, epoch). The forward is
``reference/model.py``'s; ``Precision`` decides its products' rounding,
and ``half`` keeps only the first half of each micro-batch's rows (a
fault a check has to catch).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from benchmark import work
from benchmark.reference.model import Precision, losses


def dropout_seed(seed: int, epoch: int = 0) -> int:
    return int(np.random.SeedSequence([seed, epoch]).generate_state(
        1, np.uint64)[0])


@dataclass
class Run:
    """What the first updates gave: each update's mean loss, each tower's
    outputs in the first update's micro-batches, and by leaf (the
    training loop's names) the first gradient's norm as the optimizer
    took it and the norm of the change over all the updates."""
    losses: List[float]
    tower: Dict[str, List[torch.Tensor]]
    grad_norms: Dict[str, float]
    change_norms: Dict[str, float]


def _tensors(batch: Dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items()}


def run(cfg: Dict, settings: Dict, weights: Dict, batches: List[Dict],
        seed: int, device: torch.device, prec: Precision = Precision(),
        half: bool = False) -> Run:
    """``len(batches)`` updates from ``weights`` (benchmark/weights.py's
    groups) on ``batches`` (the assembled batches, numpy)."""
    parts = {part["part"]: part for part in cfg["parts"]}
    p: Dict[str, torch.Tensor] = {}
    names: Dict[str, str] = {}
    for (part, group), tensors in weights.items():
        trains = group == "extra" or parts[part].get("trains", False)
        family = work.load("families", parts[part]["family"])
        for name, t in tensors.items():
            p[name] = t.float().clone().requires_grad_(trains)
            names[name] = family.program_name(name)
    train = [n for n in p if p[n].requires_grad]
    start = {n: p[n].detach().clone() for n in train}
    opt = work.load("optimizers", cfg["optimizer"]).Reference(
        {n: p[n] for n in train}, settings)
    lr0 = settings["learning_rate"]
    warmup = max(1, settings["lr_warmup_steps"])
    accum = settings["grad_accumulation_steps"]
    gen = torch.Generator(device=device).manual_seed(dropout_seed(seed))

    out_losses, grad_norms = [], {}
    tower: Dict[str, List[torch.Tensor]] = {}
    for t, batch in enumerate(batches, start=1):
        rows = next(iter(batch.values())).shape[0] // accum
        keep = rows // 2 if half else rows
        total = 0.0
        for i in range(accum):
            mb = _tensors({k: np.asarray(x)[i * rows:i * rows + keep]
                           for k, x in batch.items()}, device)
            loss, _, pooled = losses(p, cfg, settings, mb, prec, gen)
            loss.backward()
            total += float(loss.detach())
            if t == 1:
                for part, out in pooled.items():
                    tower.setdefault(part, []).append(out.detach().float())
        grads = [p[n].grad if p[n].grad is not None
                 else torch.zeros_like(p[n]) for n in train]
        with torch.no_grad():
            grads = [g / accum for g in grads]
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
            coef = 1.0 if norm < settings["grad_clip"] else float(
                settings["grad_clip"] / norm)
            grads = [g * coef for g in grads]
            if t == 1:
                grad_norms = {names[n]: float(g.norm())
                              for n, g in zip(train, grads)}
            lr = lr0 * min(1.0, t / warmup) if t - 1 < warmup else lr0
            opt.step(t, p, dict(zip(train, grads)), lr)
            for n in train:
                p[n].grad = None
        out_losses.append(total / accum)
    change = {names[n]: float((p[n].detach() - start[n]).norm())
              for n in train}
    return Run(out_losses, tower, grad_norms, change)
