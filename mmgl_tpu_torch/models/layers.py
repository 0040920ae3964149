"""Shared model building blocks (counterpart of mmgl_tpu/models/layers.py).

Parameters and compute dtypes are split as flax's ``param_dtype`` / ``dtype``
split them: the parameters stay in their own dtype (float32, so an optimizer
update on bf16 training is not rounded away) and each layer casts them to
its ``compute_dtype`` at use (``cast_at_use``). The cast is explicit
rather than ``torch.autocast``, which would keep LayerNorm outputs and the
residual stream in fp32 where the JAX package rounds them to the compute
dtype. The LoRA adapter comes with PEFT.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn


def _quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


ACT2FN: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": F.relu,
    # jax.nn.gelu defaults to approximate=True, so both names are the tanh form
    "gelu": _gelu_tanh,
    "gelu_new": _gelu_tanh,
    "quick_gelu": _quick_gelu,
}


def _cast_is_kept(p: torch.Tensor) -> bool:
    """No gradient can flow into p: it is frozen, or grad mode is off."""
    return not (p.requires_grad and torch.is_grad_enabled())


def cast_at_use(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``p`` in ``dtype``. Each cast is a kernel launch, and greedy decode is
    bound by launches, so where no gradient can flow into ``p`` (a frozen
    tower, an eval pass) the cast is kept on ``p`` and reused until ``p`` is
    written in place (its version counter moves: optimizer steps,
    load_state_dict) or moved. A cast made for a gradient frees the kept
    one."""
    if p.dtype == dtype:
        return p
    if not _cast_is_kept(p):
        p.__dict__.pop("_kept_cast", None)
        return p.to(dtype)
    stamp = (p._version, p.data_ptr(), dtype)
    kept = p.__dict__.get("_kept_cast")
    if kept is None or kept[0] != stamp:
        kept = p.__dict__["_kept_cast"] = (stamp, p.detach().to(dtype))
    return kept[1]


class Linear(nn.Linear):
    """flax ``Dense(dtype=compute_dtype)``: input, weight and bias cast to
    the compute dtype."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 *, compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else cast_at_use(self.bias, dt)
        return F.linear(x.to(dt), cast_at_use(self.weight, dt), bias)


class LayerNorm(nn.LayerNorm):
    """flax ``LayerNorm(dtype=compute_dtype)``: statistics, scale and bias in
    fp32, the output rounded to the compute dtype. (torch's CUDA layer_norm
    refuses a bf16 input with fp32 scale and bias, hence the casts.)"""

    def __init__(self, normalized_shape: int, eps: float = 1e-5, *,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(normalized_shape, eps=eps)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight,
                         self.bias, self.eps)
        return y.to(self.compute_dtype)


class RMSNorm(nn.Module):
    """T5's layer norm (mmgl_tpu/models/layers.py:63-76): no mean, no bias;
    the variance in fp32, x scaled in fp32, times the fp32 weight, then
    rounded to the compute dtype. Its epsilon is T5's 1e-6, not OPT's
    LayerNorm 1e-5."""

    def __init__(self, dim: int, eps: float = 1e-6, *,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        return (self.weight * (xf * torch.rsqrt(var + self.eps))).to(
            self.compute_dtype)


class Embedding(nn.Embedding):
    """flax ``Embed(dtype=compute_dtype)``: the rows looked up, then cast
    (the same values as casting the table first, without casting all of
    it), or looked up in the kept cast of the table (``cast_at_use``)."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(num_embeddings, embedding_dim)
        self.compute_dtype = compute_dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if _cast_is_kept(self.weight):
            return F.embedding(ids, cast_at_use(self.weight,
                                                self.compute_dtype))
        return F.embedding(ids, self.weight).to(self.compute_dtype)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """The tied LM head, flax ``Embed.attend``: x @ table.T in the
        compute dtype."""
        dt = self.compute_dtype
        return x.to(dt) @ cast_at_use(self.weight, dt).T


class Dropout(nn.Module):
    """Counterpart of ``FastDropout`` (mmgl_tpu/ops/dropout.py:46-58) with
    the exact keep probability 1 - rate (the TPU's uint8 quantization,
    230/256 for rate 0.1, does not carry over), as flax's ``nn.Dropout``
    computes it on the CPU: kept values scaled by 1/(1 - rate).

    Active only in training mode. The mask comes from ``generator``, which
    the caller passes explicitly (the counterpart of the "dropout" rng
    stream); it must live on the input's device."""

    def __init__(self, rate: float):
        super().__init__()
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"dropout rate {rate} is not in [0, 1)")
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("dropout in training mode needs a generator")
        keep = torch.rand(x.shape, generator=generator,
                          device=x.device) < 1.0 - self.rate
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


def make_positions_from_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """OPT/Roberta position scheme: cumsum of the mask, pads pinned.

    positions = cumsum(mask) * mask - 1, so padded slots read index -1 (the
    caller adds the model's offset)."""
    mask = attention_mask.to(torch.int64)
    return torch.cumsum(mask, dim=1) * mask - 1


@torch.no_grad()
def init_weights(module: torch.nn.Module, generator: torch.Generator) -> None:
    """Seeded init of every Linear, Embedding and LayerNorm under module,
    with the distributions of the flax defaults (the numbers differ: the two
    frameworks' generators do): Dense kernels normal with std
    1/sqrt(fan_in) and zero bias, Embed tables normal with std
    1/sqrt(features), LayerNorm 1 and 0."""
    for m in module.modules():
        if isinstance(m, torch.nn.Linear):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.in_features),
                             generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, torch.nn.Embedding):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.embedding_dim),
                             generator=generator)
        elif isinstance(m, torch.nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
