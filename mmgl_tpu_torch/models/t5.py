"""T5 encoder-decoder LM (counterpart of mmgl_tpu/models/t5.py).

Relative position biases computed once per stack, RMSNorm (eps 1e-6),
UNscaled attention (scale 1.0: T5 folds the 1/sqrt(d) into its init), relu
or gated-gelu FFN, and the tied LM head with ``hidden * d_model**-0.5``
before ``hidden @ E.T``. In training mode, hidden dropout at HF's sites (the
embeddings, each residual branch, the FFN's inner activation, the stack's
final norm) through ``layers.Dropout``, and attention-prob dropout inside
every attention, which the dispatch sends to K7 with its in-kernel Philox
dropout. Both draw from the ``generator`` the caller passes. The decoder has
an in-place KV cache for greedy decode (models/opt.py ``KVCache``).

Attention routes on T5-base (ops/attention.py): the encoder's 512-token
self-attention with its bias and the decoder's 128-token causal
self-attention with its bias go to K7; the 128 x 512 cross-attention goes to
K4 in eval and to K7 in training (dropout); decode steps (one query) to the
reference. Module names follow the flax parameter paths
(``encoder.layers.0.self_attn.q``) so weights convert mechanically
(utils/convert.py). Prefix tuning (``prefix_kvs``, one learned (P, H, D)
key and value pair a decoder layer; mmgl_tpu/models/t5.py:136-156) puts
[prefix; k] and [prefix; v] in each decoder self-attention, the key mask (if
any) extended with ones and the position bias with P zero columns in front;
the causal mask aligns the ends, so every query sees the prefix (128
queries against 148 keys at T5-base's decoder: K7 and K8 at a ragged key
length). Only the teacher-forced forward takes them; ``decode``, which
greedy generation runs, takes none, as in the JAX package.

What the attention kernels take is made once a stack, not once a layer:
the position bias with every head, the prefix's zero columns and its rows
padded to a multiple of 8 elements (``padded_bias``: K7's TMA and
K8/K9's tiles read rows that start on 16 bytes, the view in place), and
the key masks in int32 with the prefix's ones.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from mmgl_tpu_torch.models.layers import (ACT2FN, Dropout, Embedding,
                                          Linear, RMSNorm, cast_at_use)
from mmgl_tpu_torch.models.opt import KVCache
from mmgl_tpu_torch.ops import multi_head_attention
from mmgl_tpu_torch.ops.flash_attention import padded_bias
from mmgl_tpu_torch.parallel.collectives import copy_to_group


@dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 768
    d_kv: int = 64
    d_ff: int = 3072
    num_layers: int = 12
    num_decoder_layers: int = 12
    num_heads: int = 12
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    dropout_rate: float = 0.1        # hidden and attention-prob dropout
    feed_forward_proj: str = "relu"  # or "gated-gelu"
    tie_word_embeddings: bool = True
    pad_token_id: int = 0
    eos_token_id: int = 1
    decoder_start_token_id: int = 0
    dtype: torch.dtype = torch.float32  # compute dtype; parameters stay fp32
    use_pallas: bool = True      # False: attention_reference (--use_pallas)

    @property
    def inner_dim(self) -> int:
        return self.num_heads * self.d_kv


def _relative_position_bucket(relative_position: torch.Tensor,
                              bidirectional: bool, num_buckets: int,
                              max_distance: int) -> torch.Tensor:
    """T5's log-binned relative position buckets (int64), in the JAX
    package's fp32 arithmetic."""
    ret = torch.zeros_like(relative_position)
    n = -relative_position
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).long() * num_buckets
        n = n.abs()
    else:
        n = n.clamp(min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    log_ratio = torch.log(torch.tensor(max_distance / max_exact,
                                       dtype=torch.float32))
    val_if_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-6) / log_ratio
        * (num_buckets - max_exact)).long()   # truncates, as astype(int32)
    val_if_large = val_if_large.clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


def compute_position_bias(relpos_table: torch.Tensor, q_len: int, k_len: int,
                          bidirectional: bool, num_buckets: int,
                          max_distance: int, q_offset: int = 0
                          ) -> torch.Tensor:
    """(1, H, q_len, k_len) additive bias from the bucket table (buckets,
    H), contiguous: the layout the kernels take, so no layer copies it."""
    dev = relpos_table.device
    ctx = torch.arange(q_len, device=dev)[:, None] + q_offset
    mem = torch.arange(k_len, device=dev)[None, :]
    buckets = _relative_position_bucket(mem - ctx, bidirectional,
                                        num_buckets, max_distance)
    bias = F.embedding(buckets, relpos_table)        # (q, k, H)
    return bias.permute(2, 0, 1).contiguous()[None]


class T5Attention(nn.Module):
    # tensor-parallel: this rank's model index, folded into the attention
    # dropout's key so that the ranks' heads draw apart
    dropout_stream = 0

    def __init__(self, cfg: T5Config, causal: bool = False):
        super().__init__()
        self.cfg, self.causal = cfg, causal
        dt = cfg.dtype
        self.q = Linear(cfg.d_model, cfg.inner_dim, bias=False,
                        compute_dtype=dt)
        self.k = Linear(cfg.d_model, cfg.inner_dim, bias=False,
                        compute_dtype=dt)
        self.v = Linear(cfg.d_model, cfg.inner_dim, bias=False,
                        compute_dtype=dt)
        self.o = Linear(cfg.inner_dim, cfg.d_model, bias=False,
                        compute_dtype=dt)

    def forward(self, hidden_states, kv_states=None, kv_mask=None,
                position_bias=None, cache: Optional[KVCache] = None,
                generator: Optional[torch.Generator] = None,
                prefix_kv=None):
        """With ``prefix_kv``, the self-attention's keys and values are
        [prefix; k] and [prefix; v], and ``kv_mask`` and ``position_bias``
        already cover the prefix (``T5Stack`` extends them once)."""
        cfg = self.cfg
        b, s, _ = hidden_states.shape
        d = cfg.d_kv
        src = hidden_states if kv_states is None else kv_states
        q = self.q(hidden_states)
        h = q.shape[-1] // d     # a tensor-parallel rank's H / m
        q = q.view(b, s, h, d)
        k = self.k(src).view(b, src.shape[1], h, d)
        v = self.v(src).view(b, src.shape[1], h, d)

        causal = self.causal
        if cache is not None and kv_states is None:
            idx = cache.index
            cache.k[:, idx:idx + s] = k
            cache.v[:, idx:idx + s] = v
            cache.index = idx + s
            if s == 1:
                # decode step: attend over the written cache prefix
                k, v = cache.k, cache.v
                max_len = k.shape[1]
                valid = (torch.arange(max_len, device=k.device)[None, :]
                         < idx + s)
                if kv_mask is not None and kv_mask.shape[1] < max_len:
                    pad = kv_mask.new_ones(b, max_len - kv_mask.shape[1])
                    kv_mask = torch.cat([kv_mask, pad], dim=1)
                kv_mask = (valid.expand(b, max_len) if kv_mask is None
                           else kv_mask.bool() & valid)
                causal = False
            # else: prefill, causal over the current segment (empty cache)

        if prefix_kv is not None and kv_states is None:
            pk, pv = (t.to(k.dtype)[None].expand(b, *t.shape)
                      for t in prefix_kv)
            k, v = torch.cat([pk, k], dim=1), torch.cat([pv, v], dim=1)

        rate = cfg.dropout_rate if self.training else 0.0
        out = multi_head_attention(q, k, v, kv_mask=kv_mask,
                                   bias=position_bias, causal=causal,
                                   scale=1.0, dropout_rate=rate,
                                   generator=generator,
                                   dropout_stream=self.dropout_stream,
                                   use_pallas=cfg.use_pallas)
        return self.o(out.reshape(b, s, h * d))


class T5FFN(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        dt = cfg.dtype
        self.gated = "gated" in cfg.feed_forward_proj
        if self.gated:
            self.wi_0 = Linear(cfg.d_model, cfg.d_ff, bias=False,
                               compute_dtype=dt)
            self.wi_1 = Linear(cfg.d_model, cfg.d_ff, bias=False,
                               compute_dtype=dt)
        else:
            self.wi = Linear(cfg.d_model, cfg.d_ff, bias=False,
                             compute_dtype=dt)
        self.wo = Linear(cfg.d_ff, cfg.d_model, bias=False, compute_dtype=dt)
        self.dropout = Dropout(cfg.dropout_rate)

    def forward(self, x, generator=None):
        if self.gated:
            h = ACT2FN["gelu_new"](self.wi_0(x)) * self.wi_1(x)
        else:
            h = F.relu(self.wi(x))
        return self.wo(self.dropout(h, generator))


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, is_decoder: bool = False):
        super().__init__()
        dt, eps = cfg.dtype, cfg.layer_norm_epsilon
        self.is_decoder = is_decoder
        self.self_attn = T5Attention(cfg, causal=is_decoder)
        self.self_attn_norm = RMSNorm(cfg.d_model, eps, compute_dtype=dt)
        if is_decoder:
            self.cross_attn = T5Attention(cfg, causal=False)
            self.cross_attn_norm = RMSNorm(cfg.d_model, eps, compute_dtype=dt)
        self.ffn = T5FFN(cfg)
        self.ffn_norm = RMSNorm(cfg.d_model, eps, compute_dtype=dt)
        self.dropout = Dropout(cfg.dropout_rate)

    def forward(self, hidden_states, attention_mask=None, position_bias=None,
                encoder_states=None, encoder_mask=None,
                cache: Optional[KVCache] = None, generator=None,
                prefix_kv=None):
        attn = self.self_attn(self.self_attn_norm(hidden_states),
                              kv_mask=attention_mask,
                              position_bias=position_bias, cache=cache,
                              generator=generator, prefix_kv=prefix_kv)
        hidden_states = hidden_states + self.dropout(attn, generator)
        if self.is_decoder and encoder_states is not None:
            attn = self.cross_attn(self.cross_attn_norm(hidden_states),
                                   kv_states=encoder_states,
                                   kv_mask=encoder_mask, generator=generator)
            hidden_states = hidden_states + self.dropout(attn, generator)
        ffn = self.ffn(self.ffn_norm(hidden_states), generator)
        return hidden_states + self.dropout(ffn, generator)


class T5Stack(nn.Module):
    # tensor-parallel: (group, first head, heads) of this rank, whose
    # columns of the replicated bucket table it takes
    head_shard = None

    def __init__(self, cfg: T5Config, is_decoder: bool = False):
        super().__init__()
        self.cfg, self.is_decoder = cfg, is_decoder
        n = cfg.num_decoder_layers if is_decoder else cfg.num_layers
        self.layers = nn.ModuleList(T5Block(cfg, is_decoder)
                                    for _ in range(n))
        self.final_layer_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon,
                                        compute_dtype=cfg.dtype)
        self.relpos_bias = Embedding(cfg.relative_attention_num_buckets,
                                     cfg.num_heads, compute_dtype=cfg.dtype)
        self.dropout = Dropout(cfg.dropout_rate)

    def forward(self, inputs_embeds, attention_mask=None, encoder_states=None,
                encoder_mask=None, caches: Optional[List[KVCache]] = None,
                position_offset: int = 0, generator=None, prefix_kvs=None):
        cfg = self.cfg
        s = inputs_embeds.shape[1]
        # a decode step attends the whole cache buffer; a prefill (s > 1)
        # only the current segment
        k_len = caches[0].k.shape[1] if (caches is not None and s == 1) else s
        table = cast_at_use(self.relpos_bias.weight, cfg.dtype)
        if self.head_shard is not None:
            group, start, count = self.head_shard
            table = copy_to_group(table, group)[:, start:start + count]
        bias = compute_position_bias(
            table, s, k_len, bidirectional=not self.is_decoder,
            num_buckets=cfg.relative_attention_num_buckets,
            max_distance=cfg.relative_attention_max_distance,
            q_offset=position_offset)
        # once a stack: the masks in int32, the prefix's keys (every
        # decoder layer's prefix has the same length) always valid and
        # without a position bias, the bias rows padded for the kernels
        if attention_mask is not None:
            attention_mask = attention_mask.to(torch.int32)
        if encoder_mask is not None:
            encoder_mask = encoder_mask.to(torch.int32)
        if prefix_kvs is not None:
            p = prefix_kvs[0][0].shape[0]
            bias = torch.cat([bias.new_zeros(*bias.shape[:3], p), bias],
                             dim=3)
            if attention_mask is not None:
                attention_mask = torch.cat(
                    [attention_mask.new_ones(attention_mask.shape[0], p),
                     attention_mask], dim=1)
        bias = padded_bias(bias)
        hidden_states = self.dropout(inputs_embeds, generator)
        for i, layer in enumerate(self.layers):
            hidden_states = layer(
                hidden_states, attention_mask, bias, encoder_states,
                encoder_mask, caches[i] if caches is not None else None,
                generator,
                prefix_kvs[i] if prefix_kvs is not None else None)
        return self.dropout(self.final_layer_norm(hidden_states), generator)


def t5_init_cache(config: T5Config, batch: int, max_len: int,
                  device: torch.device, num_heads: Optional[int] = None
                  ) -> List[KVCache]:
    """Empty per-layer decoder self-attention cache, of ``num_heads`` heads
    (a tensor-parallel rank's own; default the config's)."""
    shape = (batch, max_len, num_heads or config.num_heads, config.d_kv)
    return [KVCache(torch.zeros(shape, dtype=config.dtype, device=device),
                    torch.zeros(shape, dtype=config.dtype, device=device))
            for _ in range(config.num_decoder_layers)]


def shift_right(labels: torch.Tensor, decoder_start_token_id: int,
                pad_token_id: int) -> torch.Tensor:
    """HF T5's label shift: decoder inputs = [start, labels[:-1]], -100 ->
    pad."""
    shifted = torch.roll(labels, 1, dims=-1)
    shifted[:, 0] = decoder_start_token_id
    return torch.where(shifted == -100, torch.full_like(shifted, pad_token_id),
                       shifted)


class T5ForConditionalGeneration(nn.Module):
    """T5 with the tied head. In training mode with dropout > 0 the forward
    needs ``generator``, the dropout stream (hidden and attention)."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.config = cfg
        self.shared = Embedding(cfg.vocab_size, cfg.d_model,
                                compute_dtype=cfg.dtype)
        self.encoder = T5Stack(cfg, is_decoder=False)
        self.decoder = T5Stack(cfg, is_decoder=True)
        if not cfg.tie_word_embeddings:
            self.lm_head = Linear(cfg.d_model, cfg.vocab_size, bias=False,
                                  compute_dtype=cfg.dtype)

    def _head(self, hidden: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        if cfg.tie_word_embeddings:
            return self.shared.attend(hidden * (cfg.d_model ** -0.5))
        return self.lm_head(hidden)

    def encode(self, input_ids=None, attention_mask=None, inputs_embeds=None,
               generator=None) -> torch.Tensor:
        if inputs_embeds is None:
            inputs_embeds = self.shared(input_ids)
        return self.encoder(inputs_embeds, attention_mask,
                            generator=generator)

    def decode(self, decoder_input_ids, encoder_states, attention_mask=None,
               decoder_mask=None, caches: Optional[List[KVCache]] = None,
               position_offset: int = 0, generator=None, prefix_kvs=None):
        """(logits, caches); the caches are updated in place."""
        hidden = self.decoder(self.shared(decoder_input_ids), decoder_mask,
                              encoder_states, attention_mask, caches,
                              position_offset, generator, prefix_kvs)
        return self._head(hidden), caches

    def forward(self, input_ids=None, attention_mask=None, labels=None,
                decoder_input_ids=None, inputs_embeds=None,
                decoder_attention_mask=None,
                generator: Optional[torch.Generator] = None,
                prefix_kvs=None) -> torch.Tensor:
        cfg = self.config
        enc = self.encode(input_ids, attention_mask, inputs_embeds, generator)
        if decoder_input_ids is None:
            decoder_input_ids = shift_right(labels, cfg.decoder_start_token_id,
                                            cfg.pad_token_id)
        logits, _ = self.decode(decoder_input_ids, enc, attention_mask,
                                decoder_attention_mask, generator=generator,
                                prefix_kvs=prefix_kvs)
        return logits

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.shared(input_ids)

    @property
    def local_heads(self) -> int:
        """The decoder self-attention heads this rank holds."""
        q = self.decoder.layers[0].self_attn.q.weight
        return q.shape[0] // self.config.d_kv
