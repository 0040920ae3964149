"""Losses (counterpart of mmgl_tpu/train/losses.py:22-64, 100-117).

Decoder-only CE over the whole shifted sequence, prompt and pads included,
with -100 positions (image splices) excluded, plus the summary loss over the
label span with pads dropped (run_generation.py:470-481 in the reference),
from one per-token CE pass.

The per-token CE is ``_TokenCE``, the counterpart of the custom-VJP
``_ce_core``: an fp32 logsumexp over the logits in their own dtype, saving
only the logits and the (B, T) logsumexp, never an fp32 copy of the (B, T, V)
logits; the backward recomputes softmax minus one-hot in one pass and
returns the gradient in the logits' dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch

IGNORE_INDEX = -100


class _TokenCE(torch.autograd.Function):
    """Per-token CE in fp32 from native-dtype logits; labels < 0 give 0."""

    @staticmethod
    def forward(ctx, logits, labels):
        valid = labels >= 0
        safe = labels.clamp(min=0)
        # the max in the logits' dtype is exact; exp and sum run in fp32
        m = logits.amax(dim=-1).float()
        s = torch.exp(logits.float() - m[..., None]).sum(dim=-1)
        logz = torch.log(s) + m
        gold = torch.gather(logits, -1, safe[..., None])[..., 0].float()
        ctx.save_for_backward(logits, safe, valid, logz)
        return torch.where(valid, logz - gold, torch.zeros_like(logz))

    @staticmethod
    def backward(ctx, grad):
        logits, safe, valid, logz = ctx.saved_tensors
        g = torch.where(valid, grad, torch.zeros_like(grad)).float()
        # one fp32 working copy, updated in place (copy=True: never the
        # saved fp32 logits themselves)
        p = logits.to(torch.float32, copy=True).sub_(logz[..., None]).exp_()
        p.scatter_add_(-1, safe[..., None],
                       torch.full_like(logz[..., None], -1.0))
        return p.mul_(g[..., None]).to(logits.dtype), None


def token_ce(logits: torch.Tensor, labels: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token CE in fp32 and its validity; labels < 0 give 0."""
    return _TokenCE.apply(logits, labels), labels >= 0


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
