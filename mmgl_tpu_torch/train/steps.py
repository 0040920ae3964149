"""Train and eval steps (counterpart of mmgl_tpu/train/steps.py:72-90,
95-171, 240-259).

The JAX package compiles one program per update: a ``lax.scan`` over the
micro-batches, then the optimizer. Here the same update runs eagerly: each
micro-batch's loss is backpropagated into the parameters' ``.grad``, the
sums are divided by the number of micro-batches, the global norm of the
trainable gradients is taken before clipping, and one optimizer step and
one scheduler step follow. Metrics stay on the device; nothing here waits
for it. Decoder-only models take the causal losses over prompt + summary;
encoder-decoder (T5) the unshifted CE over the summary, which is also the
summary loss.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from mmgl_tpu_torch.train.losses import causal_losses, seq2seq_loss


def losses_of(out: Dict, decoder_only: bool, max_input_length: int,
            pad_token_id: int):
    """(loss, summary_loss) of a forward's logits and labels."""
    if decoder_only:
        return causal_losses(out["logits"], out["labels"], max_input_length,
                             pad_token_id)
    loss = seq2seq_loss(out["logits"], out["labels"])
    return loss, loss


def make_train_step(model, optimizer: torch.optim.Optimizer,
                    scheduler, decoder_only: bool, max_input_length: int,
                    pad_token_id: int, grad_accumulation_steps: int = 1,
                    grad_clip: float = 0.0
                    ) -> Callable[[Dict, Optional[torch.Generator]], Dict]:
    """step(batch, generator) -> {"loss", "summary_loss", "grad_norm"}.

    ``batch`` is the loader's batch of ``accum * micro`` samples, split into
    ``accum`` micro-batches of consecutive rows (the JAX package's reshape
    to (accum, micro, ...)). ``generator`` is the dropout stream. The
    optimizer's parameters are the trainable set."""
    accum = max(1, grad_accumulation_steps)
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def step(batch: Dict, generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        model.train()
        n = batch["input_ids"].shape[0]
        if n % accum:
            raise ValueError(f"a batch of {n} does not split into {accum} "
                             "micro-batches")
        micro = n // accum
        sums = 0.0
        for i in range(accum):
            mb = {k: v[i * micro:(i + 1) * micro] for k, v in batch.items()}
            out = model(mb, generator=generator)
            loss, s_loss = losses_of(out, decoder_only, max_input_length,
                                   pad_token_id)
            loss.backward()
            sums = sums + torch.stack([loss.detach(), s_loss.detach()])
        grads = [p.grad for p in params]
        if accum > 1:
            torch._foreach_mul_(grads, 1.0 / accum)
        grad_norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        if grad_clip and grad_clip > 0:
            # optax.clip_by_global_norm: g / norm * clip once norm >= clip
            coef = torch.where(grad_norm < grad_clip,
                               torch.ones_like(grad_norm),
                               grad_clip / grad_norm)
            torch._foreach_mul_(grads, coef)
        optimizer.step()
        scheduler.step()
        optimizer.zero_grad(set_to_none=True)
        sums = sums / accum
        return {"loss": sums[0], "summary_loss": sums[1],
                "grad_norm": grad_norm}

    return step


def make_eval_step(model, decoder_only: bool, max_input_length: int,
                   pad_token_id: int) -> Callable[[Dict], Dict]:
    """Teacher-forced eval: loss + argmax predictions over the label span
    (run_generation.py:580-606 val path). step(batch) -> {"loss",
    "summary_loss", "predictions"}, all on the model's device. Runs the
    model in eval mode (``deterministic=True``: no dropout)."""
    @torch.no_grad()
    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        model.eval()
        out = model(batch)
        loss, s_loss = losses_of(out, decoder_only, max_input_length,
                               pad_token_id)
        span = (out["logits"][:, max_input_length:-1] if decoder_only
                else out["logits"])
        preds = torch.argmax(span, dim=-1)
        return {"loss": loss, "summary_loss": s_loss, "predictions": preds}

    return step
