"""Roberta text encoder (counterpart of mmgl_tpu/models/roberta.py:21-143).

The frozen neighbor-text tower of the embedding mode: the encoder trunk
only, post-LN layers with exact (erf) GELU; the first-token ``TextPooler``
and the projection live in the fusion model (models/fusion.py), as in the
JAX package. Positions are ``cumsum(mask) * mask + pad_token_id``, so a
padded slot reads the pad row of the table; token types are all 0.
Self-attention runs through ``ops.multi_head_attention`` with the text's
key mask: at 512 tokens and 12 heads of 64 that is K1 on the card (an empty
neighbor slot has an all-zero mask, a fully masked row, which K1 treats as
``xla_attention`` does). Parameters stay fp32 and each layer computes in
``dtype`` (models/layers.py). Module names follow the flax parameter paths
(``encoder.layers.0.attention.query``), so weights convert mechanically
(utils/convert.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mmgl_tpu_torch.models.layers import Embedding, LayerNorm, Linear
from mmgl_tpu_torch.ops import multi_head_attention


@dataclass(frozen=True)
class RobertaConfig:
    vocab_size: int = 50265
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 1
    dtype: torch.dtype = torch.float32
    use_pallas: bool = True      # False: attention_reference (--use_pallas)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


class RobertaEmbeddings(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        self.word_embeddings = Embedding(cfg.vocab_size, cfg.hidden_size,
                                         compute_dtype=dt)
        self.position_embeddings = Embedding(cfg.max_position_embeddings,
                                             cfg.hidden_size, compute_dtype=dt)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size,
                                               cfg.hidden_size,
                                               compute_dtype=dt)
        self.layer_norm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps,
                                    compute_dtype=dt)

    def forward(self, input_ids, attention_mask):
        mask = attention_mask.to(torch.int64)
        positions = torch.cumsum(mask, dim=1) * mask + self.cfg.pad_token_id
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(positions)
             + self.token_type_embeddings(torch.zeros_like(input_ids)))
        return self.layer_norm(x)


class RobertaSelfAttention(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.cfg = cfg
        dt, e = cfg.dtype, cfg.hidden_size
        self.query = Linear(e, e, compute_dtype=dt)
        self.key = Linear(e, e, compute_dtype=dt)
        self.value = Linear(e, e, compute_dtype=dt)
        self.out = Linear(e, e, compute_dtype=dt)

    def forward(self, hidden_states, attention_mask):
        cfg = self.cfg
        b, s, e = hidden_states.shape
        d = cfg.head_dim
        q = self.query(hidden_states)
        h = q.shape[-1] // d     # a tensor-parallel rank's H / m
        q = q.view(b, s, h, d)
        k = self.key(hidden_states).view(b, s, h, d)
        v = self.value(hidden_states).view(b, s, h, d)
        out = multi_head_attention(q, k, v, kv_mask=attention_mask,
                                   use_pallas=cfg.use_pallas)
        return self.out(out.reshape(b, s, h * d))


class RobertaLayer(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        dt, e = cfg.dtype, cfg.hidden_size
        self.attention = RobertaSelfAttention(cfg)
        self.attention_norm = LayerNorm(e, eps=cfg.layer_norm_eps,
                                        compute_dtype=dt)
        self.intermediate = Linear(e, cfg.intermediate_size, compute_dtype=dt)
        self.output = Linear(cfg.intermediate_size, e, compute_dtype=dt)
        self.output_norm = LayerNorm(e, eps=cfg.layer_norm_eps,
                                     compute_dtype=dt)

    def forward(self, hidden_states, attention_mask):
        attn = self.attention(hidden_states, attention_mask)
        hidden_states = self.attention_norm(hidden_states + attn)
        inter = F.gelu(self.intermediate(hidden_states))  # exact (erf)
        return self.output_norm(hidden_states + self.output(inter))


class RobertaEncoder(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.layers = nn.ModuleList(RobertaLayer(cfg)
                                    for _ in range(cfg.num_hidden_layers))

    def forward(self, hidden_states, attention_mask):
        for layer in self.layers:
            hidden_states = layer(hidden_states, attention_mask)
        return hidden_states


class RobertaModel(nn.Module):
    """Returns last_hidden_state (B, S, H) in the compute dtype."""

    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.config = cfg
        self.embeddings = RobertaEmbeddings(cfg)
        self.encoder = RobertaEncoder(cfg)

    def forward(self, input_ids, attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        # the key mask as the attention kernels take it, once a forward
        attention_mask = attention_mask.to(torch.int32)
        x = self.embeddings(input_ids, attention_mask)
        return self.encoder(x, attention_mask)
