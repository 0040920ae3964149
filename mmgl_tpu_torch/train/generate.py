"""Greedy generation with a KV cache (counterpart of
mmgl_tpu/train/generate.py:30-89, 123-125), decoder-only.

One prefill over the padded prompt (with its image splices), then
single-token decode steps against a preallocated cache: greedy, EOS-finished
rows emit pad. A Python loop replaces ``lax.scan``; it stops one step
earlier than the scan, whose last step computes a token it discards. And
the cache is updated in place (models/opt.py KVCache). Generated tokens land
in cache slots after the padded prompt; pad slots stay masked through the
prompt's attention mask, which the decode step extends with ones. Positions
continue the mask cumsum, so they stay contiguous with the real text.
"""

from __future__ import annotations

from typing import Dict

import torch

from mmgl_tpu_torch.models.fusion import MMGLModel
from mmgl_tpu_torch.models.layers import make_positions_from_mask
from mmgl_tpu_torch.models.opt import init_cache


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
    opt_cfg = model.config.opt
    embeds, mask = model.prefill_inputs(_prompt_batch(model, batch))
    b, t_prompt = embeds.shape[:2]
    caches = init_cache(opt_cfg, b, t_prompt + max_new_tokens, embeds.device)

    logits, caches = model.lm_decode(
        inputs_embeds=embeds, attention_mask=mask, caches=caches,
        position_ids=make_positions_from_mask(mask))
    n_valid = mask.sum(dim=1).long()                            # (B,)
    rows = torch.arange(b, device=embeds.device)
    tok = torch.argmax(logits[rows, n_valid - 1], dim=-1)

    eos, pad = opt_cfg.eos_token_id, opt_cfg.pad_token_id
    finished = torch.zeros(b, dtype=torch.bool, device=embeds.device)
    pos = n_valid
    out = [tok]
    for _ in range(max_new_tokens - 1):   # the last token needs no step
        step_logits, caches = model.lm_decode(
            input_ids=tok[:, None], attention_mask=mask, caches=caches,
            position_ids=pos[:, None])
        nxt = torch.argmax(step_logits[:, 0], dim=-1)
        finished = finished | (tok == eos)
        tok = torch.where(finished, torch.full_like(nxt, pad), nxt)
        out.append(tok)
        pos = pos + 1
    return torch.stack(out, dim=1)
