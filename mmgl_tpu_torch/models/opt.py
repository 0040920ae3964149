"""OPT decoder-only LM and MPT (counterpart of mmgl_tpu/models/opt.py:38-420).

Covers the pre-LN ordering of OPT-125M/1.3B/2.7B/6.7B and the post-LN
ordering of OPT-350M, whose 512-wide embeddings go through ``project_in``
(512 -> 1024, no bias) before the 1024-wide positions are added and
``project_out`` before the tied head (mmgl_tpu/models/opt.py:234-263,
:278-290, :328-331, :367-370): learned positions from the attention-mask
cumsum with offset 2, the tied LM head (``hidden @ E.T`` on the embedding's
width), hidden dropout at the JAX package's three sites (embeddings, after
attention, after fc2; attention dropout is 0) in training mode, and a KV
cache for greedy decode.

Training only (mmgl_tpu/models/opt.py:294-302, :335-363):

* Layerdrop (``layerdrop`` p > 0, in training mode): each decoder layer,
  and the cross layer that follows it, is bypassed with probability p. The
  keep decisions are drawn on the device from the dropout ``generator``, one
  per layer before the first, and applied without a branch (the layer runs,
  then ``torch.where(keep, out, residual)``), as the JAX package's "compute,
  then select". Eval, the prefill and decode ignore it.
* Remat (``remat``): where a gradient is recorded, every decoder layer and
  cross layer runs under ``torch.utils.checkpoint`` (non-reentrant), and its
  forward is recomputed in the backward. The recompute replays the layer's
  dropout draws from a generator forked at the layer's start
  (``_Replay``): checkpoint's own ``preserve_rng_state`` saves only the
  default generators, never the explicit dropout stream.

PEFT and MPT:

* LoRA (``peft_type=lora``) on the q and v projections of every attention
  (``layers.LoRALinear``, rank ``lora_r``; :120-128).
* Prefix K/V (``prefix_kvs``, one (P, H, D) pair a layer): [prefix; k] and
  [prefix; v], the key mask extended with ones, in every self-attention
  (:177-185). The causal mask aligns the ends, so every query sees the
  prefix. The fusion model passes them in training and the teacher-forced
  eval; generation does not (nor does the JAX package's).
* MPT (``cross_attention``): ``neighbor_layers.i``, each a whole decoder
  layer whose attention reads its keys and values from the neighbour
  memory, non-causal under ``neighbor_mask`` (:149-153, :201-262), runs
  after layer idx when (idx + 1) % ``neighbor_layer_wise`` == 0 and fewer
  than ``num_neighbor_layers`` have run (:345-360), in training, the
  prefill and every decode step. Under ``peft_type=flamingo`` its two
  residual branches are gated by tanh(``gating1``) and tanh(``gating2``),
  scalars that start at 0.

Module names follow the flax parameter paths
(``decoder.layers.0.self_attn.q_proj``) so weights convert mechanically
(utils/convert.py). Attention runs through ops.multi_head_attention.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
from torch import nn

from mmgl_tpu_torch.models.layers import (ACT2FN, Dropout, Embedding,
                                          LayerNorm, Linear, LoRALinear,
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
    do_layer_norm_before: bool = True           # False: post-LN (350m)
    remove_final_layer_norm: bool = False
    activation_function: str = "relu"
    dropout: float = 0.1        # hidden dropout (opt.py:216, :291)
    layerdrop: float = 0.0
    pad_token_id: int = 1
    bos_token_id: int = 2
    eos_token_id: int = 2
    # MPT: interleaved cross layers over the neighbour memory
    cross_attention: bool = False
    neighbor_layer_wise: int = 4            # a cross layer every k layers
    peft_type: str = "none"                 # none|lora|prefix|prompt|flamingo
    lora_r: int = 64
    lora_alpha: float = 1.0
    lora_dropout: float = 0.0
    dtype: torch.dtype = torch.float32  # compute dtype; parameters stay fp32
    use_pallas: bool = True      # False: attention_reference (--use_pallas)
    remat: bool = False          # recompute each layer in the backward

    @property
    def num_neighbor_layers(self) -> int:
        if not self.cross_attention:
            return 0
        return self.num_hidden_layers // self.neighbor_layer_wise

    @property
    def lora_rank(self) -> int:
        return self.lora_r if self.peft_type == "lora" else 0

    @property
    def embed_dim(self) -> int:
        return self.word_embed_proj_dim or self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def projects(self) -> bool:
        """Whether the embeddings are narrower than the hidden states and
        go through project_in/project_out."""
        return self.embed_dim != self.hidden_size

    @property
    def has_final_layer_norm(self) -> bool:
        return self.do_layer_norm_before and not self.remove_final_layer_norm


class KVCache:
    """One layer's decode cache. Updated IN PLACE: ``k``/``v`` slots are
    written and ``index`` advances, where the JAX package returns new
    arrays."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor):
        self.k = k          # (B, max_len, H, D)
        self.v = v
        self.index = 0      # next slot to write


def init_cache(config: OPTConfig, batch: int, max_len: int,
               device: torch.device, num_heads: Optional[int] = None
               ) -> List[KVCache]:
    """Empty per-layer KV cache for autoregressive decode, of ``num_heads``
    heads (a tensor-parallel rank's own; default the config's)."""
    heads = num_heads or config.num_attention_heads
    shape = (batch, max_len, heads, config.head_dim)
    return [KVCache(torch.zeros(shape, dtype=config.dtype, device=device),
                    torch.zeros(shape, dtype=config.dtype, device=device))
            for _ in range(config.num_hidden_layers)]


class OPTAttention(nn.Module):
    """Causal self-attention, or with ``cross_attention`` non-causal
    attention over the neighbour memory (``kv_states``)."""

    def __init__(self, cfg: OPTConfig, cross_attention: bool = False):
        super().__init__()
        self.cfg, self.cross_attention = cfg, cross_attention
        e, dt = cfg.hidden_size, cfg.dtype
        lora = dict(rank=cfg.lora_rank, alpha=cfg.lora_alpha,
                    dropout=cfg.lora_dropout, compute_dtype=dt)
        self.q_proj = LoRALinear(e, e, **lora)
        self.k_proj = Linear(e, e, compute_dtype=dt)
        self.v_proj = LoRALinear(e, e, **lora)
        self.out_proj = Linear(e, e, compute_dtype=dt)

    def forward(self, hidden_states: torch.Tensor,
                kv_mask: Optional[torch.Tensor] = None,
                cache: Optional[KVCache] = None,
                kv_states: Optional[torch.Tensor] = None,
                prefix_kv: Optional[Tuple[torch.Tensor,
                                          torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        cfg = self.cfg
        d = cfg.head_dim
        b, s, _ = hidden_states.shape
        src = kv_states if self.cross_attention else hidden_states
        # the heads counted from the projection: a tensor-parallel rank
        # holds H / m of them
        q = self.q_proj(hidden_states, generator)
        h = q.shape[-1] // d
        q = q.view(b, s, h, d)
        k = self.k_proj(src).view(b, -1, h, d)
        v = self.v_proj(src, generator).view(b, -1, h, d)

        # the cross layers take no cache and no prefix
        causal = not self.cross_attention
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

        if prefix_kv is not None:
            # learned (P, H, D) keys and values in front, always visible
            pk, pv = (t.to(k.dtype)[None].expand(b, *t.shape)
                      for t in prefix_kv)
            k, v = torch.cat([pk, k], dim=1), torch.cat([pv, v], dim=1)
            if kv_mask is not None:
                kv_mask = torch.cat([kv_mask.new_ones(b, pk.shape[1]),
                                     kv_mask], dim=1)

        out = multi_head_attention(q, k, v, kv_mask=kv_mask, causal=causal,
                                   use_pallas=cfg.use_pallas)
        return self.out_proj(out.reshape(b, s, h * d))


class OPTDecoderLayer(nn.Module):
    """OPT block: each LayerNorm before its sublayer (pre-LN), or after its
    residual add (post-LN, ``do_layer_norm_before=False``). With
    ``cross_attention`` (MPT's neighbour layers) the attention reads the
    memory, and under ``peft_type=flamingo`` each residual branch is scaled
    by the tanh of its gate (mmgl_tpu/models/opt.py:201-262)."""

    def __init__(self, cfg: OPTConfig, cross_attention: bool = False):
        super().__init__()
        dt = cfg.dtype
        self.cross_attention = cross_attention
        self.self_attn = OPTAttention(cfg, cross_attention)
        self.self_attn_layer_norm = LayerNorm(cfg.hidden_size, eps=1e-5,
                                              compute_dtype=dt)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, eps=1e-5,
                                          compute_dtype=dt)
        self.fc1 = Linear(cfg.hidden_size, cfg.ffn_dim, compute_dtype=dt)
        self.fc2 = Linear(cfg.ffn_dim, cfg.hidden_size, compute_dtype=dt)
        self.act = ACT2FN[cfg.activation_function]
        self.dropout = Dropout(cfg.dropout)
        self.pre_ln = cfg.do_layer_norm_before
        self.gated = cross_attention and cfg.peft_type == "flamingo"
        if self.gated:
            self.gating1 = nn.Parameter(torch.zeros(()))
            self.gating2 = nn.Parameter(torch.zeros(()))

    def _gate(self, name: str, x: torch.Tensor) -> torch.Tensor:
        if not self.gated:
            return x
        return torch.tanh(getattr(self, name)).to(x.dtype) * x

    def forward(self, hidden_states, attention_mask=None, cache=None,
                generator=None, neighbor_embeds=None, neighbor_mask=None,
                prefix_kv=None):
        pre = self.pre_ln
        residual = hidden_states
        if pre:
            hidden_states = self.self_attn_layer_norm(hidden_states)
        if self.cross_attention:
            hidden_states = self.self_attn(hidden_states, neighbor_mask,
                                           kv_states=neighbor_embeds,
                                           generator=generator)
        else:
            hidden_states = self.self_attn(hidden_states, attention_mask,
                                           cache, prefix_kv=prefix_kv,
                                           generator=generator)
        hidden_states = residual + self._gate(
            "gating1", self.dropout(hidden_states, generator))
        if not pre:
            hidden_states = self.self_attn_layer_norm(hidden_states)
        residual = hidden_states
        if pre:
            hidden_states = self.final_layer_norm(hidden_states)
        hidden_states = self.fc2(self.act(self.fc1(hidden_states)))
        hidden_states = residual + self._gate(
            "gating2", self.dropout(hidden_states, generator))
        if not pre:
            hidden_states = self.final_layer_norm(hidden_states)
        return hidden_states


class _Replay:
    """The dropout generator a checkpointed layer draws from: the step's
    own on the first call (the forward, which advances the step's stream),
    and on every later call (the recompute) a generator forked from the
    state the step's had at the layer's start, so that the recompute draws
    the forward's masks again without rewinding the step's stream."""

    def __init__(self, generator: Optional[torch.Generator]):
        self.generator, self.calls = generator, 0
        self.state = None if generator is None else generator.get_state()

    def __call__(self) -> Optional[torch.Generator]:
        self.calls += 1
        if self.generator is None or self.calls == 1:
            return self.generator
        fork = torch.Generator(device=self.generator.device)
        fork.set_state(self.state)
        return fork


def _run_layer(layer: nn.Module, remat: bool, hidden_states, *args,
               generator=None, **kwargs):
    """``layer(hidden_states, *args, generator=generator, **kwargs)``, under
    ``torch.utils.checkpoint`` where ``remat`` holds and a gradient is
    recorded. Non-reentrant: it records the adapters' gradients when no
    input of the layer requires one (LoRA under --freeze_lm), and runs the
    forward with the gradient mode it was called in, so the kernels'
    wrappers decide as they would without it."""
    if not (remat and torch.is_grad_enabled()):
        return layer(hidden_states, *args, generator=generator, **kwargs)
    replay = _Replay(generator)
    return torch.utils.checkpoint.checkpoint(
        lambda h: layer(h, *args, generator=replay(), **kwargs),
        hidden_states, use_reentrant=False, preserve_rng_state=False)


class OPTDecoder(nn.Module):
    def __init__(self, cfg: OPTConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        self.embed_tokens = Embedding(cfg.vocab_size, cfg.embed_dim,
                                      compute_dtype=dt)
        # learned positions, offset 2
        self.embed_positions = Embedding(cfg.max_position_embeddings + 2,
                                         cfg.hidden_size, compute_dtype=dt)
        if cfg.projects:
            self.project_in = Linear(cfg.embed_dim, cfg.hidden_size,
                                     bias=False, compute_dtype=dt)
            self.project_out = Linear(cfg.hidden_size, cfg.embed_dim,
                                      bias=False, compute_dtype=dt)
        self.embed_dropout = Dropout(cfg.dropout)
        self.layers = nn.ModuleList(OPTDecoderLayer(cfg)
                                    for _ in range(cfg.num_hidden_layers))
        if cfg.cross_attention:
            self.neighbor_layers = nn.ModuleList(
                OPTDecoderLayer(cfg, cross_attention=True)
                for _ in range(cfg.num_neighbor_layers))
        if cfg.has_final_layer_norm:
            self.final_layer_norm = LayerNorm(cfg.hidden_size, eps=1e-5,
                                              compute_dtype=dt)

    def forward(self, input_ids=None, attention_mask=None, inputs_embeds=None,
                caches: Optional[List[KVCache]] = None, position_ids=None,
                generator: Optional[torch.Generator] = None,
                neighbor_embeds=None, neighbor_mask=None, prefix_kvs=None):
        cfg = self.cfg
        if inputs_embeds is None:
            inputs_embeds = self.embed_tokens(input_ids)
        b, s = inputs_embeds.shape[:2]
        if attention_mask is None:
            attention_mask = torch.ones(b, s, dtype=torch.int32,
                                        device=inputs_embeds.device)
        # the key mask as the attention kernels take it, once a forward
        # (a no-op where the batch's mask is int32 already)
        attention_mask = attention_mask.to(torch.int32)
        if position_ids is None:
            position_ids = make_positions_from_mask(attention_mask)[:, -s:]
        if self.cfg.projects:
            inputs_embeds = self.project_in(inputs_embeds)
        hidden_states = inputs_embeds + self.embed_positions(position_ids + 2)
        hidden_states = self.embed_dropout(hidden_states, generator)
        keep = None
        if self.training and cfg.layerdrop > 0.0:
            if generator is None:
                raise ValueError("layerdrop in training mode needs a "
                                 "generator")
            keep = torch.rand(len(self.layers), generator=generator,
                              device=hidden_states.device) \
                < 1.0 - cfg.layerdrop
        n_cross = 0
        for i, layer in enumerate(self.layers):
            residual = hidden_states
            hidden_states = _run_layer(
                layer, cfg.remat, hidden_states, attention_mask,
                caches[i] if caches is not None else None,
                generator=generator,
                prefix_kv=prefix_kvs[i] if prefix_kvs is not None else None)
            if (cfg.cross_attention and neighbor_embeds is not None
                    and (i + 1) % cfg.neighbor_layer_wise == 0
                    and n_cross < cfg.num_neighbor_layers):
                hidden_states = _run_layer(
                    self.neighbor_layers[n_cross], cfg.remat, hidden_states,
                    generator=generator, neighbor_embeds=neighbor_embeds,
                    neighbor_mask=neighbor_mask)
                n_cross += 1
            if keep is not None:
                hidden_states = torch.where(keep[i], hidden_states, residual)
        if self.cfg.has_final_layer_norm:
            hidden_states = self.final_layer_norm(hidden_states)
        if self.cfg.projects:
            hidden_states = self.project_out(hidden_states)
        return hidden_states


class OPTForCausalLM(nn.Module):
    """OPT with the tied LM head. Returns (logits, caches); the caches are
    the ones passed in, updated in place. In training mode with dropout or
    layerdrop > 0 the forward needs ``generator``, the dropout stream.
    ``return_hidden``: the pre-head states in place of the logits (after
    project_out, in the tied table's width) for the vocab-chunked CE, which
    folds the head into the loss (train/losses.chunked_ce). The head is
    always the tied table here, as in every configuration of the JAX
    package's factory, so there is no untied head to refuse."""

    def __init__(self, cfg: OPTConfig):
        super().__init__()
        self.config = cfg
        self.decoder = OPTDecoder(cfg)

    def forward(self, input_ids=None, attention_mask=None, inputs_embeds=None,
                caches: Optional[List[KVCache]] = None, position_ids=None,
                generator: Optional[torch.Generator] = None,
                neighbor_embeds=None, neighbor_mask=None, prefix_kvs=None,
                return_hidden: bool = False
                ) -> Tuple[torch.Tensor, Optional[List[KVCache]]]:
        hidden = self.decoder(input_ids=input_ids,
                              attention_mask=attention_mask,
                              inputs_embeds=inputs_embeds, caches=caches,
                              position_ids=position_ids, generator=generator,
                              neighbor_embeds=neighbor_embeds,
                              neighbor_mask=neighbor_mask,
                              prefix_kvs=prefix_kvs)
        if return_hidden:
            return hidden, caches
        return self.decoder.embed_tokens.attend(hidden), caches

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Token embedding lookup (for inputs_embeds fusion paths)."""
        return self.decoder.embed_tokens(input_ids)

    @property
    def local_heads(self) -> int:
        """The self-attention heads this rank holds (all of them unless
        tensor-parallel)."""
        q = self.decoder.layers[0].self_attn.q_proj.weight
        return q.shape[0] // self.config.head_dim
