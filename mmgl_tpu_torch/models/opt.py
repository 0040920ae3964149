"""OPT decoder-only LM (counterpart of mmgl_tpu/models/opt.py:38-420).

Covers the pre-LN ordering of OPT-125M/1.3B/2.7B/6.7B: learned positions
from the attention-mask cumsum with offset 2, the tied LM head
(``hidden @ E.T``), hidden dropout at the JAX package's three sites
(embeddings, after attention, after fc2; attention dropout is 0) in training
mode, and a KV cache for greedy decode. Post-LN with project_in/out (350M),
layerdrop raise NotImplementedError here; MPT cross layers and prefix KV
at model build (models/factory.py). Module
names follow the flax parameter paths
(``decoder.layers.0.self_attn.q_proj``) so weights convert mechanically
(utils/convert.py). Attention runs through ops.multi_head_attention.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
from torch import nn

from mmgl_tpu_torch.models.layers import (ACT2FN, Dropout, Embedding,
                                          LayerNorm, Linear,
                                          make_positions_from_mask)
from mmgl_tpu_torch.ops import multi_head_attention


@dataclass(frozen=True)
class OPTConfig:
    vocab_size: int = 50272
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    ffn_dim: int = 3072
    max_position_embeddings: int = 2048
    word_embed_proj_dim: Optional[int] = None  # != hidden_size only for 350m
    do_layer_norm_before: bool = True
    activation_function: str = "relu"
    dropout: float = 0.1        # hidden dropout (opt.py:216, :291)
    layerdrop: float = 0.0
    pad_token_id: int = 1
    bos_token_id: int = 2
    eos_token_id: int = 2
    dtype: torch.dtype = torch.float32  # compute dtype; parameters stay fp32

    @property
    def embed_dim(self) -> int:
        return self.word_embed_proj_dim or self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    def check_supported(self) -> None:
        if (not self.do_layer_norm_before or (self.word_embed_proj_dim and
                self.word_embed_proj_dim != self.hidden_size)):
            raise NotImplementedError(
                "OPT post-LN with project_in/out (opt-350m) is not ported yet")
        if self.layerdrop > 0.0:
            raise NotImplementedError("layerdrop is not ported yet")


class KVCache:
    """One layer's decode cache. Updated IN PLACE: ``k``/``v`` slots are
    written and ``index`` advances, where the JAX package returns new
    arrays."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor):
        self.k = k          # (B, max_len, H, D)
        self.v = v
        self.index = 0      # next slot to write


def init_cache(config: OPTConfig, batch: int, max_len: int,
               device: torch.device) -> List[KVCache]:
    """Empty per-layer KV cache for autoregressive decode."""
    shape = (batch, max_len, config.num_attention_heads, config.head_dim)
    return [KVCache(torch.zeros(shape, dtype=config.dtype, device=device),
                    torch.zeros(shape, dtype=config.dtype, device=device))
            for _ in range(config.num_hidden_layers)]


class OPTAttention(nn.Module):
    def __init__(self, cfg: OPTConfig):
        super().__init__()
        self.cfg = cfg
        e, dt = cfg.hidden_size, cfg.dtype
        self.q_proj = Linear(e, e, compute_dtype=dt)
        self.k_proj = Linear(e, e, compute_dtype=dt)
        self.v_proj = Linear(e, e, compute_dtype=dt)
        self.out_proj = Linear(e, e, compute_dtype=dt)

    def forward(self, hidden_states: torch.Tensor,
                kv_mask: Optional[torch.Tensor] = None,
                cache: Optional[KVCache] = None) -> torch.Tensor:
        cfg = self.cfg
        h, d = cfg.num_attention_heads, cfg.head_dim
        b, s, _ = hidden_states.shape
        q = self.q_proj(hidden_states).view(b, s, h, d)
        k = self.k_proj(hidden_states).view(b, s, h, d)
        v = self.v_proj(hidden_states).view(b, s, h, d)

        causal = True
        if cache is not None:
            idx = cache.index
            cache.k[:, idx:idx + s] = k
            cache.v[:, idx:idx + s] = v
            cache.index = idx + s
            if s == 1:
                # decode step: attend over the written cache prefix; the
                # prompt mask is padded with ones over the generated span
                k, v = cache.k, cache.v
                max_len = k.shape[1]
                valid = (torch.arange(max_len, device=k.device)[None, :]
                         < idx + s)
                if kv_mask is not None and kv_mask.shape[1] < max_len:
                    pad = kv_mask.new_ones(b, max_len - kv_mask.shape[1])
                    kv_mask = torch.cat([kv_mask, pad], dim=1)
                kv_mask = (valid if kv_mask is None
                           else kv_mask.bool() & valid)
                causal = False
            # else: prefill attends causally over the current segment only
            # (exact when the cache is empty, the only prefill pattern)

        out = multi_head_attention(q, k, v, kv_mask=kv_mask, causal=causal)
        return self.out_proj(out.reshape(b, s, cfg.hidden_size))


class OPTDecoderLayer(nn.Module):
    """Pre-LN OPT block."""

    def __init__(self, cfg: OPTConfig):
        super().__init__()
        dt = cfg.dtype
        self.self_attn = OPTAttention(cfg)
        self.self_attn_layer_norm = LayerNorm(cfg.hidden_size, eps=1e-5,
                                              compute_dtype=dt)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, eps=1e-5,
                                          compute_dtype=dt)
        self.fc1 = Linear(cfg.hidden_size, cfg.ffn_dim, compute_dtype=dt)
        self.fc2 = Linear(cfg.ffn_dim, cfg.hidden_size, compute_dtype=dt)
        self.act = ACT2FN[cfg.activation_function]
        self.dropout = Dropout(cfg.dropout)

    def forward(self, hidden_states, attention_mask=None, cache=None,
                generator=None):
        residual = hidden_states
        hidden_states = self.self_attn(
            self.self_attn_layer_norm(hidden_states), attention_mask, cache)
        hidden_states = residual + self.dropout(hidden_states, generator)
        residual = hidden_states
        hidden_states = self.fc2(self.act(self.fc1(
            self.final_layer_norm(hidden_states))))
        return residual + self.dropout(hidden_states, generator)


class OPTDecoder(nn.Module):
    def __init__(self, cfg: OPTConfig):
        super().__init__()
        cfg.check_supported()
        self.cfg = cfg
        dt = cfg.dtype
        self.embed_tokens = Embedding(cfg.vocab_size, cfg.embed_dim,
                                      compute_dtype=dt)
        # learned positions, offset 2
        self.embed_positions = Embedding(cfg.max_position_embeddings + 2,
                                         cfg.hidden_size, compute_dtype=dt)
        self.embed_dropout = Dropout(cfg.dropout)
        self.layers = nn.ModuleList(OPTDecoderLayer(cfg)
                                    for _ in range(cfg.num_hidden_layers))
        self.final_layer_norm = LayerNorm(cfg.hidden_size, eps=1e-5,
                                          compute_dtype=dt)

    def forward(self, input_ids=None, attention_mask=None, inputs_embeds=None,
                caches: Optional[List[KVCache]] = None, position_ids=None,
                generator: Optional[torch.Generator] = None):
        if inputs_embeds is None:
            inputs_embeds = self.embed_tokens(input_ids)
        b, s = inputs_embeds.shape[:2]
        if attention_mask is None:
            attention_mask = torch.ones(b, s, dtype=torch.int32,
                                        device=inputs_embeds.device)
        if position_ids is None:
            position_ids = make_positions_from_mask(attention_mask)[:, -s:]
        hidden_states = inputs_embeds + self.embed_positions(position_ids + 2)
        hidden_states = self.embed_dropout(hidden_states, generator)
        for i, layer in enumerate(self.layers):
            hidden_states = layer(hidden_states, attention_mask,
                                  caches[i] if caches is not None else None,
                                  generator)
        return self.final_layer_norm(hidden_states)


class OPTForCausalLM(nn.Module):
    """OPT with the tied LM head. Returns (logits, caches); the caches are
    the ones passed in, updated in place. In training mode with dropout > 0
    the forward needs ``generator``, the dropout stream."""

    def __init__(self, cfg: OPTConfig):
        super().__init__()
        self.config = cfg
        self.decoder = OPTDecoder(cfg)

    def forward(self, input_ids=None, attention_mask=None, inputs_embeds=None,
                caches: Optional[List[KVCache]] = None, position_ids=None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Optional[List[KVCache]]]:
        hidden = self.decoder(input_ids=input_ids,
                              attention_mask=attention_mask,
                              inputs_embeds=inputs_embeds, caches=caches,
                              position_ids=position_ids, generator=generator)
        return self.decoder.embed_tokens.attend(hidden), caches

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Token embedding lookup (for inputs_embeds fusion paths)."""
        return self.decoder.embed_tokens(input_ids)
