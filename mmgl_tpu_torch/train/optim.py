"""Optimizers and schedule (counterpart of mmgl_tpu/train/optim.py:27-64).

Chosen by model name as the JAX package chooses (:45): Adafactor for T5,
AdamW otherwise.

OPT: AdamW(betas, eps 1e-8, weight_decay) under a linear warmup to the
learning rate over ``lr_warmup_steps`` updates, then a step decay by
``lr_schedule_gamma`` every ``lr_schedule_step_size * steps_per_epoch /
grad_accumulation_steps`` updates; gradients clipped by their global norm
before the update (train/steps.py). The optimizer holds the trainable
parameters only, so frozen ones get no state and no decay, as under
``optax.masked``.

torch's AdamW decays decoupled, ``p -= lr * wd * p`` before the Adam step,
which is optax.adamw's ``p -= lr * (adam + wd * p)``; with eps added to the
bias-corrected root it is the same update.

T5: ``Adafactor``, what ``optax.adafactor(lr, multiply_by_parameter_scale=
False, min_dim_size_to_factor=2)`` computes (optax/_src/factorized.py and
alias.py): factored second moments for every tensor of two or more dims
(over its two largest dims), unfactored for vectors; decay 1 - (t+1)^-0.8,
epsilon 1e-30 added to the squared gradient; the update clipped to block
RMS 1.0, scaled by the constant learning rate; no momentum, no weight
decay. ``torch.optim.Adafactor`` is another algorithm (its own decay and
epsilons, a relative step). The factoring reads the flax layout: a
``Linear`` weight is the transpose of the flax kernel, so the optimizer
factors it transposed, which decides the dims of a square matrix.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from mmgl_tpu_torch.config import Arguments


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


class Adafactor(torch.optim.Optimizer):
    """optax.adafactor(lr, multiply_by_parameter_scale=False,
    min_dim_size_to_factor=2) with a constant learning rate; state (step
    count, v_row / v_col or v) only for the parameters given. ``transposed``
    holds the parameters whose flax layout is their transpose."""

    DECAY_RATE = 0.8           # decay 1 - (t+1)^-0.8
    EPS = 1e-30                # added to the squared gradient
    CLIPPING_THRESHOLD = 1.0   # block RMS of an update
    MIN_DIM_SIZE_TO_FACTOR = 2

    def __init__(self, params, lr: float,
                 transposed: Iterable[torch.Tensor] = ()):
        super().__init__(params, dict(lr=lr))
        self._transposed = {id(p) for p in transposed}

    def _factored_dims(self, shape) -> Optional[Tuple[int, int]]:
        """optax's choice: the two largest dims, (second, largest), by
        numpy's argsort of the shape."""
        if len(shape) < 2:
            return None
        order = np.argsort(shape)
        if shape[order[-2]] < self.MIN_DIM_SIZE_TO_FACTOR:
            return None
        return int(order[-2]), int(order[-1])

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                flip = id(p) in self._transposed
                g = p.grad.T if flip else p.grad
                shape = tuple(g.shape)
                dims = self._factored_dims(shape)
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    if dims is None:
                        state["v"] = torch.zeros_like(g)
                    else:
                        d1, d0 = dims
                        state["v_row"] = g.new_zeros(
                            shape[:d0] + shape[d0 + 1:])
                        state["v_col"] = g.new_zeros(
                            shape[:d1] + shape[d1 + 1:])
                # optax's fp32 1 - (t+1)^-0.8, taken on the host as a
                # Python float (exactly that fp32 value): no copy to the
                # device per tensor
                t = torch.tensor(state["step"] + 1, dtype=torch.float32)
                decay = float(1.0 - t ** -self.DECAY_RATE)
                g2 = g.square() + self.EPS
                if dims is None:
                    v = state["v"]
                    v.copy_(decay * v + (1.0 - decay) * g2)
                    update = g * v.rsqrt()
                else:
                    d1, d0 = dims
                    v_row, v_col = state["v_row"], state["v_col"]
                    v_row.copy_(decay * v_row
                                + (1.0 - decay) * g2.mean(dim=d0))
                    v_col.copy_(decay * v_col
                                + (1.0 - decay) * g2.mean(dim=d1))
                    reduced_d1 = d1 - 1 if d1 > d0 else d1
                    row_col_mean = v_row.mean(dim=reduced_d1, keepdim=True)
                    row_factor = (v_row / row_col_mean).rsqrt()
                    col_factor = v_col.rsqrt()
                    update = (g * row_factor.unsqueeze(d0)
                              * col_factor.unsqueeze(d1))
                # clip_by_block_rms, then the learning rate
                denom = torch.clamp(update.square().mean().sqrt()
                                    / self.CLIPPING_THRESHOLD, min=1.0)
                update = update / denom * group["lr"]
                p.sub_(update.T if flip else update)
                state["step"] += 1


def flax_transposed(model: nn.Module):
    """The parameters stored as the transpose of their flax leaf: every
    ``Linear`` weight (utils/convert.py transposes Dense kernels)."""
    return [m.weight for m in model.modules() if isinstance(m, nn.Linear)]


def build_optimizer(args: Arguments,
                    params: Union[nn.Module, Iterable[torch.nn.Parameter]]
                    ) -> Tuple[torch.optim.Optimizer,
                               torch.optim.lr_scheduler.LambdaLR]:
    """(the optimizer over the trainable ``params``, its LambdaLR
    schedule): Adafactor at a constant rate for T5, else AdamW under
    ``lr_factor``. Step the scheduler once after each optimizer step: update
    n then runs at lr_factor(n). Pass the model itself for T5, so Adafactor
    factors the Linear weights in their flax layout."""
    name = args.model_name_or_path or ""
    transposed = []
    if isinstance(params, nn.Module):
        transposed = flax_transposed(params)
        params = params.parameters()
    params = [p for p in params if p.requires_grad]
    if "t5" in name:
        opt = Adafactor(params, lr=args.learning_rate, transposed=transposed)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda _: 1.0)
    opt = torch.optim.AdamW(params, lr=args.learning_rate,
                            betas=(args.adam_beta1, args.adam_beta2),
                            eps=1e-8, weight_decay=args.weight_decay)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lr_factor(args))
