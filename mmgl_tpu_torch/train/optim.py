"""Optimizer and schedule (counterpart of mmgl_tpu/train/optim.py:27-64).

OPT: AdamW(betas, eps 1e-8, weight_decay) under a linear warmup to the
learning rate over ``lr_warmup_steps`` updates, then a step decay by
``lr_schedule_gamma`` every ``lr_schedule_step_size * steps_per_epoch /
grad_accumulation_steps`` updates; gradients clipped by their global norm
before the update (train/steps.py). The optimizer holds the trainable
parameters only, so frozen ones get no state and no decay, as under
``optax.masked``.

torch's AdamW decays decoupled, ``p -= lr * wd * p`` before the Adam step,
which is optax.adamw's ``p -= lr * (adam + wd * p)``; with eps added to the
bias-corrected root it is the same update. Adafactor (T5) is not ported.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Tuple

import torch

from mmgl_tpu.config import Arguments


def lr_factor(args: Arguments) -> Callable[[int], float]:
    """The schedule as a multiple of ``--learning_rate`` at an update count
    (``lr_schedule`` divided by the base rate)."""
    warmup = max(1, args.lr_warmup_steps)
    decay_every = max(1, (args.lr_schedule_step_size * args.steps_per_epoch)
                      // args.grad_accumulation_steps)
    gamma = args.lr_schedule_gamma

    def fn(step: int) -> float:
        if step < warmup:
            return min(1.0, (step + 1.0) / warmup)
        return gamma ** math.floor(max(step - warmup, 0) / decay_every)

    return fn


def build_optimizer(args: Arguments, params: Iterable[torch.nn.Parameter]
                    ) -> Tuple[torch.optim.Optimizer,
                               torch.optim.lr_scheduler.LambdaLR]:
    """(AdamW over ``params``, its LambdaLR schedule). Step the scheduler
    once after each optimizer step: update n then runs at lr_factor(n)."""
    name = args.model_name_or_path or ""
    if "t5" in name:
        raise NotImplementedError("Adafactor (T5) is not ported yet")
    params = [p for p in params if p.requires_grad]
    opt = torch.optim.AdamW(params, lr=args.learning_rate,
                            betas=(args.adam_beta1, args.adam_beta2),
                            eps=1e-8, weight_decay=args.weight_decay)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lr_factor(args))
