"""Eval step (counterpart of mmgl_tpu/train/steps.py:240-259).

Training steps come in a later change.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from mmgl_tpu_torch.train.losses import causal_losses


def make_eval_step(model, decoder_only: bool, max_input_length: int,
                   pad_token_id: int) -> Callable[[Dict], Dict]:
    """Teacher-forced eval: loss + argmax predictions over the label span
    (run_generation.py:580-606 val path). step(batch) -> {"loss",
    "summary_loss", "predictions"}, all on the model's device."""
    if not decoder_only:
        raise NotImplementedError("encoder-decoder eval is not ported yet")

    @torch.no_grad()
    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        out = model(batch)
        logits, labels = out["logits"], out["labels"]
        loss, s_loss = causal_losses(logits, labels, max_input_length,
                                     pad_token_id)
        preds = torch.argmax(logits[:, max_input_length:-1], dim=-1)
        return {"loss": loss, "summary_loss": s_loss, "predictions": preds}

    return step
