"""Losses, forward only (counterpart of mmgl_tpu/train/losses.py:100-117).

Decoder-only CE over the whole shifted sequence, prompt and pads included,
with -100 positions (image splices) excluded, plus the summary loss over the
label span with pads dropped (run_generation.py:470-481 in the reference),
from one per-token CE pass. The CE is fp32 log-softmax over the logits,
whatever their dtype, as the JAX package computes it.
"""

from __future__ import annotations

from typing import Tuple

import torch

IGNORE_INDEX = -100


def token_ce(logits: torch.Tensor, labels: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token CE in fp32 and its validity; labels < 0 give 0."""
    valid = labels >= 0
    logp = torch.log_softmax(logits.float(), dim=-1)
    gold = torch.gather(logp, -1, labels.clamp(min=0)[..., None])[..., 0]
    return torch.where(valid, -gold, torch.zeros_like(gold)), valid


def causal_losses(logits: torch.Tensor, labels: torch.Tensor,
                  max_input_length: int, pad_token_id: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lm_loss, summary_loss): logits[:, :-1] predict labels[:, 1:]."""
    ce, valid = token_ce(logits[:, :-1], labels[:, 1:])
    loss = ce.sum() / valid.sum().clamp(min=1)
    pos = torch.arange(ce.shape[1], device=ce.device)
    shifted = labels[:, 1:]
    span = valid & (pos[None, :] >= max_input_length) & (shifted
                                                          != pad_token_id)
    s_loss = (ce * span).sum() / span.sum().clamp(min=1)
    return loss, s_loss
