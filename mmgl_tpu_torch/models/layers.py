"""Shared model building blocks (counterpart of mmgl_tpu/models/layers.py).

Projections are plain ``nn.Linear``; the LoRA adapter comes with PEFT.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch
import torch.nn.functional as F


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
