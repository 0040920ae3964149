"""Prompt and prefix tuning tables (counterpart of
mmgl_tpu/peft/virtual_tokens.py:21-50).

  * ``PromptTuning``: a learned (P, dim) table of virtual embeddings,
    broadcast over the batch; the fusion model prepends it to the LM's
    input and extends the mask (and, decoder-only, the labels).
  * ``PrefixTuning``: a learned (layers, 2, P, heads, head_dim) table, one
    (k, v) pair of (P, heads, head_dim) per self-attention layer, prepended
    to that layer's keys and values.

P is ``num_virtual_tokens`` (20, mmgl_tpu/models/fusion.py:55). Both tables
are drawn from normal(0, 0.02), flax's ``normal(0.02)``, by
``init_weights`` (models/layers.py) through ``seeded_init``. The tables keep
the flax layout, so utils/convert.py copies them as they are.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from mmgl_tpu_torch.parallel.collectives import copy_to_group

INIT_STD = 0.02


class PromptTuning(nn.Module):
    def __init__(self, num_virtual_tokens: int, hidden_size: int):
        super().__init__()
        # flax's leaf is "embedding", which convert maps to "weight"
        self.weight = nn.Parameter(torch.empty(num_virtual_tokens,
                                               hidden_size))

    def seeded_init(self, generator: torch.Generator) -> None:
        self.weight.normal_(0.0, INIT_STD, generator=generator)

    def forward(self, batch_size: int) -> torch.Tensor:
        """(batch_size, P, dim), the table broadcast (a view)."""
        return self.weight[None].expand(batch_size, *self.weight.shape)


class PrefixTuning(nn.Module):
    # tensor-parallel: (group, first head, heads) of this rank, which takes
    # those heads' keys and values of the replicated table
    head_shard = None

    def __init__(self, num_layers: int, num_virtual_tokens: int,
                 num_heads: int, head_dim: int):
        super().__init__()
        self.kv = nn.Parameter(torch.empty(num_layers, 2, num_virtual_tokens,
                                           num_heads, head_dim))

    def seeded_init(self, generator: torch.Generator) -> None:
        self.kv.normal_(0.0, INIT_STD, generator=generator)

    def forward(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """[(k, v)] * layers, each (P, heads, head_dim): this rank's heads
        where tensor-parallel."""
        kv = self.kv
        if self.head_shard is not None:
            group, start, count = self.head_shard
            kv = copy_to_group(kv, group)[..., start:start + count, :]
        return [(kv[i, 0], kv[i, 1]) for i in range(kv.shape[0])]
