"""Greedy generation with a KV cache (counterpart of
mmgl_tpu/train/generate.py:30-125).

T5 (``_generate_t5``): the fused prompt is encoded once; the decoder starts
from ``decoder_start_token_id`` and takes one token per step against its
in-place self-attention cache, with the relative-position bias at query
offset t; each step's argmax is the output, and rows that have emitted EOS
emit pad.

Decoder-only:
One prefill over the padded prompt (with its image splices, or in the
embedding mode [prompt; neighbour soft tokens] under the prompt mask
extended by the neighbours', mmgl_tpu/train/generate.py:47-70), then
single-token decode steps against a preallocated cache: greedy, EOS-finished
rows emit pad. A Python loop replaces ``lax.scan``; it stops one step
earlier than the scan, whose last step computes a token it discards. And
the cache is updated in place (models/opt.py KVCache). Generated tokens land
in cache slots after the padded prompt; pad slots stay masked through the
prompt's attention mask, which the decode step extends with ones. Positions
continue the mask cumsum, so they stay contiguous with the real text. The
first token comes from the logits at ``n_valid - 1`` of the (combined)
mask, as in the JAX package, even where that is not the last prompt token.

MPT: the prefill and every decode step take the neighbour memory and its
mask from ``prefill_inputs``, for the cross layers. Prompt tuning: the
prefill starts with the virtual tokens (``prefill_inputs`` puts them in
front). Prefix tuning: no prefix in the prefill or the steps, for OPT and
T5 alike. That is the JAX package's behaviour (its ``lm_decode`` and
``decode_t5`` take no ``prefix_kvs``, mmgl_tpu/train/generate.py:60-63,
76-81, 109-113), kept here on purpose: generation runs the bare LM while the
teacher-forced eval uses the trained prefix.

On a tensor-parallel mesh each rank decodes with its own heads (its caches
hold H / m) and takes the argmax of its vocab columns, all-gathered as
(value, index) pairs over the model group (``losses.vocab_argmax``): every
rank emits the same tokens.
"""

from __future__ import annotations

from typing import Dict

import torch

from mmgl_tpu_torch.models.fusion import MMGLModel
from mmgl_tpu_torch.models.layers import make_positions_from_mask
from mmgl_tpu_torch.models.opt import init_cache
from mmgl_tpu_torch.models.t5 import t5_init_cache
from mmgl_tpu_torch.train.losses import vocab_argmax


def _prompt_batch(model: MMGLModel, batch: Dict) -> Dict:
    """The prompt span of an input+output batch, without labels."""
    t_in = model.config.max_input_length
    prompt = {k: v for k, v in batch.items() if k != "labels"}
    prompt["input_ids"] = batch["input_ids"][:, :t_in]
    prompt["attention_mask"] = batch["attention_mask"][:, :t_in]
    return prompt


@torch.no_grad()
def greedy_generate(model: MMGLModel, batch: Dict,
                    max_new_tokens: int = 32) -> torch.Tensor:
    """Returns (B, max_new_tokens) generated ids on the model's device.
    Runs the model in eval mode (no dropout)."""
    model.eval()
    if not model.config.decoder_only:
        return _generate_t5(model, batch, max_new_tokens)
    opt_cfg = model.config.opt
    embeds, mask, memory, memory_mask = model.prefill_inputs(
        _prompt_batch(model, batch))
    b, t_prompt = embeds.shape[:2]
    vocab = getattr(model, "vocab_shard", None)
    caches = init_cache(opt_cfg, b, t_prompt + max_new_tokens, embeds.device,
                        num_heads=model.lm.local_heads)

    logits, caches = model.lm_decode(
        inputs_embeds=embeds, attention_mask=mask, neighbor_embeds=memory,
        neighbor_mask=memory_mask, caches=caches,
        position_ids=make_positions_from_mask(mask))
    n_valid = mask.sum(dim=1).long()                            # (B,)
    rows = torch.arange(b, device=embeds.device)
    tok = vocab_argmax(logits[rows, n_valid - 1], vocab)

    eos, pad = opt_cfg.eos_token_id, opt_cfg.pad_token_id
    finished = torch.zeros(b, dtype=torch.bool, device=embeds.device)
    pos = n_valid
    out = [tok]
    for _ in range(max_new_tokens - 1):   # the last token needs no step
        step_logits, caches = model.lm_decode(
            input_ids=tok[:, None], attention_mask=mask,
            neighbor_embeds=memory, neighbor_mask=memory_mask, caches=caches,
            position_ids=pos[:, None])
        nxt = vocab_argmax(step_logits[:, 0], vocab)
        finished = finished | (tok == eos)
        tok = torch.where(finished, torch.full_like(nxt, pad), nxt)
        out.append(tok)
        pos = pos + 1
    return torch.stack(out, dim=1)


def _generate_t5(model: MMGLModel, batch: Dict,
                 max_new_tokens: int) -> torch.Tensor:
    """mmgl_tpu/train/generate.py:92-120."""
    t5_cfg = model.config.t5
    embeds, mask, _, _ = model.prefill_inputs(_prompt_batch(model, batch))
    enc = model.encode_t5(inputs_embeds=embeds, attention_mask=mask)
    b = embeds.shape[0]
    vocab = getattr(model, "vocab_shard", None)
    caches = t5_init_cache(t5_cfg, b, max_new_tokens, embeds.device,
                           num_heads=model.lm.local_heads)
    tok = torch.full((b,), t5_cfg.decoder_start_token_id, dtype=torch.long,
                     device=embeds.device)
    eos, pad = t5_cfg.eos_token_id, t5_cfg.pad_token_id
    finished = torch.zeros(b, dtype=torch.bool, device=embeds.device)
    out = []
    for t in range(max_new_tokens):
        logits, caches = model.decode_t5(
            decoder_input_ids=tok[:, None], encoder_states=enc,
            attention_mask=mask, caches=caches, position_offset=t)
        nxt = vocab_argmax(logits[:, 0], vocab)
        finished = finished | (tok == eos)
        tok = torch.where(finished, torch.full_like(nxt, pad), nxt)
        out.append(tok)
    return torch.stack(out, dim=1)
