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

from mmgl_tpu_torch.parallel.collectives import (copy_to_group,
                                                 reduce_from_group)
from mmgl_tpu_torch.utils import spans


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


# bumped where parameters change behind their version counters: FSDP
# all-gathers each update's values into the same unsharded storage without
# moving its counter (parallel/mesh.py ``apply_fsdp``)
_CAST_EPOCH = [0]


def invalidate_kept_casts() -> None:
    """Drop every kept cast (``cast_at_use``) at its next use."""
    _CAST_EPOCH[0] += 1


def cast_at_use(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``p`` in ``dtype``. Each cast is a kernel launch, and greedy decode is
    bound by launches, so where no gradient can flow into ``p`` (a frozen
    tower, an eval pass) the cast is kept on ``p`` and reused until ``p`` is
    written in place (its version counter moves: optimizer steps,
    load_state_dict), moved, or ``invalidate_kept_casts`` runs. A cast made
    for a gradient frees the kept one. Each cast made, kept or not, counts
    its bytes as ``param_cast`` (utils/spans.py); a kept cast reused counts
    nothing."""
    if p.dtype == dtype:
        return p
    if not _cast_is_kept(p):
        p.__dict__.pop("_kept_cast", None)
        cast = p.to(dtype)
        spans.count("param_cast", cast)
        return cast
    stamp = (p._version, p.data_ptr(), dtype, _CAST_EPOCH[0])
    kept = p.__dict__.get("_kept_cast")
    if kept is None or kept[0] != stamp:
        kept = p.__dict__["_kept_cast"] = (stamp, p.detach().to(dtype))
        spans.count("param_cast", kept[1])
    return kept[1]


def _norm_cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A norm layer's input or output in ``dtype``; where that changes its
    dtype, the bytes written count as ``norm_cast`` (utils/spans.py)."""
    if x.dtype == dtype:
        return x
    cast = x.to(dtype)
    spans.count("norm_cast", cast)
    return cast


class Linear(nn.Linear):
    """flax ``Dense(dtype=compute_dtype)``: input, weight and bias cast to
    the compute dtype.

    Tensor-parallel (``tp``, set by parallel/tensor_parallel.py to
    ("col", group) or ("row", group)): a column-parallel layer holds its
    rank's rows of the weight and bias (output features) and takes its
    input through ``copy_to_group``; a row-parallel one holds its rank's
    input features, sums the partial products over the group
    (``reduce_from_group``), then adds its whole bias."""

    tp = None

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 *, compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else cast_at_use(self.bias, dt)
        weight = cast_at_use(self.weight, dt)
        if self.tp is None:
            return F.linear(x.to(dt), weight, bias)
        mode, group = self.tp
        if mode == "col":
            return F.linear(copy_to_group(x.to(dt), group), weight, bias)
        y = reduce_from_group(F.linear(x.to(dt), weight), group)
        return y if bias is None else y + bias


class LoRALinear(Linear):
    """flax ``LoRADense`` (mmgl_tpu/models/layers.py:23-61): y = x W + b +
    (dropout(x) A) B * alpha / r, in the compute dtype, with ``lora_a``
    (in, r) and ``lora_b`` (r, out) in the flax layout (so x @ A @ B, no
    transposes). A is drawn from he_uniform and B is zero (``seeded_init``,
    called by ``init_weights``), so the adapter adds nothing until B
    moves. With ``rank`` 0 it is a plain Linear. The adapter's dropout, in
    training mode only, draws from ``generator``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 *, rank: int = 0, alpha: float = 1.0, dropout: float = 0.0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias,
                         compute_dtype=compute_dtype)
        self.rank, self.scale = rank, alpha / max(rank, 1)
        if rank > 0:
            self.lora_a = nn.Parameter(torch.empty(in_features, rank))
            self.lora_b = nn.Parameter(torch.zeros(rank, out_features))
            self.lora_dropout = Dropout(dropout)

    def seeded_init(self, generator: torch.Generator) -> None:
        """he_uniform for A (variance 2 / fan_in, fan_in = in), zero B."""
        if self.rank > 0:
            limit = math.sqrt(6.0 / self.in_features)
            self.lora_a.uniform_(-limit, limit, generator=generator)
            self.lora_b.zero_()

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = super().forward(x)
        if self.rank == 0:
            return y
        dt = self.compute_dtype
        h = self.lora_dropout(x.to(dt), generator) @ cast_at_use(
            self.lora_a, dt)
        if self.tp is not None:
            # B holds the rank's output columns: the (B, S, r) product's
            # gradient is a share of A's and the input's
            h = copy_to_group(h, self.tp[1])
        return y + h @ cast_at_use(self.lora_b, dt) * self.scale


class LayerNorm(nn.LayerNorm):
    """flax ``LayerNorm(dtype=compute_dtype)``: statistics, scale and bias in
    fp32, the output rounded to the compute dtype. (torch's layer_norm
    refuses an input and a scale and bias of different dtypes, hence the
    casts; with ``--param_dtype bfloat16`` the scale and bias are bf16.)"""

    def __init__(self, normalized_shape: int, eps: float = 1e-5, *,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(normalized_shape, eps=eps)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(_norm_cast(x, torch.float32), self.normalized_shape,
                         self.weight.float(), self.bias.float(), self.eps)
        return _norm_cast(y, self.compute_dtype)


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
        xf = _norm_cast(x, torch.float32)
        var = xf.square().mean(dim=-1, keepdim=True)
        return _norm_cast(self.weight * (xf * torch.rsqrt(var + self.eps)),
                          self.compute_dtype)


class Embedding(nn.Embedding):
    """flax ``Embed(dtype=compute_dtype)``: the rows looked up, then cast
    (the same values as casting the table first, without casting all of
    it), or looked up in the kept cast of the table (``cast_at_use``).

    Vocab-parallel (``tp``, a ``VocabShard`` set by
    parallel/tensor_parallel.py): the table holds the rank's rows
    [start, start + rows); a lookup takes the ids in that range, zeros the
    others and sums over the group, and ``attend`` returns the rank's
    columns of the logits."""

    tp = None

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(num_embeddings, embedding_dim)
        self.compute_dtype = compute_dtype

    def _lookup(self, ids: torch.Tensor) -> torch.Tensor:
        if _cast_is_kept(self.weight):
            return F.embedding(ids, cast_at_use(self.weight,
                                                self.compute_dtype))
        return F.embedding(ids, self.weight).to(self.compute_dtype)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return self._lookup(ids)
        local = ids - self.tp.start
        inside = (local >= 0) & (local < self.weight.shape[0])
        rows = self._lookup(torch.where(inside, local,
                                        torch.zeros_like(local)))
        rows = rows * inside[..., None].to(rows.dtype)
        return reduce_from_group(rows, self.tp.group)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """The tied LM head, flax ``Embed.attend``: x @ table.T in the
        compute dtype (the rank's vocab columns where vocab-parallel)."""
        dt = self.compute_dtype
        x = x.to(dt)
        if self.tp is not None:
            x = copy_to_group(x, self.tp.group)
        return x @ cast_at_use(self.weight, dt).T


class Dropout(nn.Module):
    """Counterpart of ``FastDropout`` (mmgl_tpu/ops/dropout.py:46-58) with
    the exact keep probability 1 - rate (the TPU's uint8 quantization,
    230/256 for rate 0.1, does not carry over), as flax's ``nn.Dropout``
    computes it on the CPU: kept values scaled by 1/(1 - rate).

    Active only in training mode. The mask comes from ``generator``, which
    the caller passes explicitly (the counterpart of the "dropout" rng
    stream); it must live on the input's device. Over a tensor-parallel
    rank's share of a dim (``shard`` = (dim, ranks, index), set by
    parallel/tensor_parallel.py) it draws the whole dim's mask and keeps
    its share: the mask of one device."""

    shard = None

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
        shape = list(x.shape)
        if self.shard is not None:
            dim, ranks, _ = self.shard
            shape[dim] *= ranks
        keep = torch.rand(shape, generator=generator,
                          device=x.device) < 1.0 - self.rate
        if self.shard is not None:
            dim, _, index = self.shard
            n = x.shape[dim]
            keep = keep.narrow(dim, index * n, n)
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
    1/sqrt(features), LayerNorm 1 and 0; a module with its own rule (the
    LoRA adapter, the virtual-token tables) through its ``seeded_init``."""
    for m in module.modules():
        if hasattr(m, "seeded_init"):
            m.seeded_init(generator)
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
