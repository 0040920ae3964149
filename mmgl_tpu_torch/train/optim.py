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

On a mesh (``mesh``): ``--zero1`` shards the optimizer's state over the
data group (parallel/mesh.py ``apply_zero1``), unless FSDP already shards
the parameters and so AdamW's moments with them. Adafactor takes the
whole tensor's statistics from a tensor-parallel share: each mean over a
sharded dim, and each block RMS, is summed over the model group, and the
factored dims are chosen from the unsharded shape. Under FSDP it updates
each parameter from its gathered gradient and keeps whole statistics.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, Dict, Iterable, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from mmgl_tpu_torch.config import Arguments
from mmgl_tpu_torch.parallel.collectives import all_reduce


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
    holds the parameters whose flax layout is their transpose; ``shards``
    maps a tensor-parallel share to (its sharded dim, the unsharded shape,
    the model group)."""

    DECAY_RATE = 0.8           # decay 1 - (t+1)^-0.8
    EPS = 1e-30                # added to the squared gradient
    CLIPPING_THRESHOLD = 1.0   # block RMS of an update
    MIN_DIM_SIZE_TO_FACTOR = 2

    def __init__(self, params, lr: float,
                 transposed: Iterable[torch.Tensor] = (),
                 shards: Optional[Dict[int, Tuple]] = None):
        super().__init__(params, dict(lr=lr))
        self._transposed = {id(p) for p in transposed}
        self._shards = shards or {}

    @classmethod
    def _factored_dims(cls, shape) -> Optional[Tuple[int, int]]:
        """optax's choice: the two largest dims, (second, largest), by
        numpy's argsort of the shape."""
        if len(shape) < 2:
            return None
        order = np.argsort(shape)
        if shape[order[-2]] < cls.MIN_DIM_SIZE_TO_FACTOR:
            return None
        return int(order[-2]), int(order[-1])

    @classmethod
    def state_shard_dims(cls, tdim: Optional[int], full: Tuple[int, ...],
                         flip: bool) -> Dict[str, Optional[int]]:
        """{state key: the dim on which that state tensor of a parameter is
        cut over the model group, or None where it is whole}, for a
        parameter of unsharded shape ``full`` cut on ``tdim`` (None: not
        cut); ``flip``: stored as the transpose of its flax layout. "v" is
        also the cut dim of the gradient in the flax layout, and so of
        the update."""
        sdim = (None if tdim is None
                else (len(full) - 1 - tdim if flip else tdim))
        dims = cls._factored_dims(tuple(full[::-1] if flip else full))
        if dims is None or sdim is None:
            return {"v": sdim, "v_row": None, "v_col": None}
        d1, d0 = dims
        return {"v": sdim,
                "v_row": None if sdim == d0 else sdim - (sdim > d0),
                "v_col": None if sdim == d1 else sdim - (sdim > d1)}

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                flip = id(p) in self._transposed
                grad = p.grad
                if hasattr(grad, "full_tensor"):    # an FSDP share
                    grad = grad.full_tensor()
                g = grad.T if flip else grad
                shape = tuple(g.shape)
                # the sharded dim in the flax layout and the whole shape
                tdim, full, model_group = self._shards.get(
                    id(p), (None, shape[::-1] if flip else shape, None))
                cut = self.state_shard_dims(tdim, full, flip)
                sdim = cut["v"]
                full = tuple(full[::-1] if flip else full)

                def mean(x, dim, sharded, n):
                    """x's mean over dim (all dims: None) as the whole
                    tensor's, whose ``sharded`` dim is cut (n: the whole
                    count)."""
                    if sharded is None or (dim is not None
                                           and dim != sharded):
                        return (x.mean() if dim is None
                                else x.mean(dim=dim, keepdim=True))
                    total = x.sum() if dim is None else x.sum(
                        dim=dim, keepdim=True)
                    return all_reduce(total, model_group) / n

                dims = self._factored_dims(full)
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
                    v_row.copy_(decay * v_row + (1.0 - decay) * mean(
                        g2, d0, sdim, full[d0]).squeeze(d0))
                    v_col.copy_(decay * v_col + (1.0 - decay) * mean(
                        g2, d1, sdim, full[d1]).squeeze(d1))
                    reduced_d1 = d1 - 1 if d1 > d0 else d1
                    row_col_mean = mean(v_row, reduced_d1, cut["v_row"],
                                        full[d1])
                    row_factor = (v_row / row_col_mean).rsqrt()
                    col_factor = v_col.rsqrt()
                    update = (g * row_factor.unsqueeze(d0)
                              * col_factor.unsqueeze(d1))
                # clip_by_block_rms, then the learning rate
                rms = mean(update.square(), None, sdim, math.prod(full))
                denom = torch.clamp(rms.sqrt() / self.CLIPPING_THRESHOLD,
                                    min=1.0)
                update = update / denom * group["lr"]
                update = update.T if flip else update
                if hasattr(p, "device_mesh"):    # back to the FSDP share
                    from torch.distributed.tensor import distribute_tensor

                    update = distribute_tensor(update, p.device_mesh,
                                               p.placements,
                                               src_data_rank=None)
                p.sub_(update)
                state["step"] += 1


def flax_transposed(model: nn.Module):
    """The parameters stored as the transpose of their flax leaf: every
    ``Linear`` weight (utils/convert.py transposes Dense kernels)."""
    return [m.weight for m in model.modules() if isinstance(m, nn.Linear)]


def tp_shards(model: nn.Module, mesh) -> Dict[int, Tuple]:
    """{id(parameter): (its dim sharded over the model group, its unsharded
    shape, the model group)} of the tensor-parallel shares of ``model``."""
    layout = getattr(model, "tp_layout", {})
    out = {}
    for name, p in model.named_parameters():
        if name in layout:
            full = list(p.shape)
            full[layout[name]] *= mesh.n_model
            out[id(p)] = (layout[name], tuple(full), mesh.model_group)
    return out


def build_optimizer(args: Arguments,
                    params: Union[nn.Module, Iterable[torch.nn.Parameter]],
                    mesh=None
                    ) -> Tuple[torch.optim.Optimizer,
                               torch.optim.lr_scheduler.LambdaLR]:
    """(the optimizer over the trainable ``params``, its LambdaLR
    schedule): Adafactor at a constant rate for T5, else AdamW under
    ``lr_factor``. Step the scheduler once after each optimizer step: update
    n then runs at lr_factor(n). Pass the model itself for T5, so Adafactor
    factors the Linear weights in their flax layout, and on a mesh, so
    that it sees the tensor-parallel shares; ``--zero1`` shards the state
    over ``mesh``'s data group."""
    name = args.model_name_or_path or ""
    transposed, shards, fsdp = [], {}, False
    if isinstance(params, nn.Module):
        transposed = flax_transposed(params)
        if mesh is not None:
            shards = tp_shards(params, mesh)
        fsdp = getattr(params, "fsdp", False)
        params = params.parameters()
    params = [p for p in params if p.requires_grad]
    if "t5" in name:
        cls = partial(Adafactor, transposed=transposed, shards=shards)
        defaults = dict(lr=args.learning_rate)
        schedule = lambda _: 1.0
    else:
        cls = torch.optim.AdamW
        defaults = dict(lr=args.learning_rate,
                        betas=(args.adam_beta1, args.adam_beta2), eps=1e-8,
                        weight_decay=args.weight_decay)
        schedule = lr_factor(args)
    if args.zero1 and mesh is not None and not fsdp:
        from mmgl_tpu_torch.parallel.mesh import apply_zero1

        opt = apply_zero1(cls, params, mesh, **defaults)
    else:
        opt = cls(params, **defaults)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, schedule)
