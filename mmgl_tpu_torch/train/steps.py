"""Train and eval steps (counterpart of mmgl_tpu/train/steps.py:54-171,
240-259).

The JAX package compiles one program per update: a ``lax.scan`` over the
micro-batches, then the optimizer. Here the same update runs eagerly: each
micro-batch's loss is backpropagated into the parameters' ``.grad``, the
sums are divided by the number of micro-batches, the global norm of the
trainable gradients is taken before clipping, and one optimizer step and
one scheduler step follow. Metrics stay on the device; nothing here waits
for it. Decoder-only models take the causal losses over prompt + summary;
encoder-decoder (T5) the unshifted CE over the summary, which is also the
summary loss. The loss follows ``make_loss_fn``: ``fused_ce=False`` takes
the plain CE (decoder-only), ``chunked_ce`` n > 0 the vocab-chunked CE over
the pre-head states and the tied table (decoder-only), whose gradient sums
the lookup's share and the head's, as ``jax.grad`` does.

On a mesh (``mesh``, parallel/mesh.py) each rank runs its data shard's
micro-batches: its losses are its shares of the global batch's means
(train/losses.py), scaled by the data ranks before the backward; the
gradients are then averaged over the data group (one all-reduce a dtype,
or FSDP's reduce-scatter), which gives the global batch's gradient. The
global norm sums the squares of the tensor-parallel shards over the model
group and those of FSDP shards over the data group, and counts a
replicated tensor once. The reported losses are summed over the data
group: the global batch's.

While a ``torch.profiler`` session is on, each update records its spans
(utils/spans.py): ``update``, then ``micro_batch`` holding ``forward``
and ``backward`` for each micro-batch, then ``optimizer``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from mmgl_tpu_torch.models.layers import invalidate_kept_casts
from mmgl_tpu_torch.parallel.collectives import all_reduce, group_size
from mmgl_tpu_torch.train.losses import (causal_losses,
                                         chunked_causal_losses, seq2seq_loss,
                                         vocab_argmax)
from mmgl_tpu_torch.utils import spans


def losses_of(out: Dict, decoder_only: bool, max_input_length: int,
              pad_token_id: int, fused_ce: bool = True, vocab=None,
              data=None):
    """(loss, summary_loss) of a forward's logits and labels; ``vocab``
    the logits' shard, ``data`` the data group (train/losses.py)."""
    if decoder_only:
        return causal_losses(out["logits"], out["labels"], max_input_length,
                             pad_token_id, fused_ce=fused_ce, vocab=vocab,
                             data=data)
    loss = seq2seq_loss(out["logits"], out["labels"], vocab=vocab,
                        data=data)
    return loss, loss


def _groups(model, mesh):
    """(the logits' vocab shard, the data group) of ``model`` on ``mesh``."""
    return (getattr(model, "vocab_shard", None),
            None if mesh is None else mesh.data_group)


def make_loss_fn(model, decoder_only: bool, max_input_length: int,
                 pad_token_id: int, fused_ce: bool = True, chunked_ce: int = 0,
                 mesh=None) -> Callable:
    """loss_fn(batch, generator=None) -> (loss, summary_loss) of the model's
    forward (``make_loss_fn``). With ``chunked_ce`` the model returns its
    pre-head states and the loss takes the tied table itself, so the
    table's gradient sums its lookup's and its head's shares."""
    vocab, data = _groups(model, mesh)
    if chunked_ce > 0:
        if not decoder_only:
            raise ValueError("chunked CE is decoder-only (the tied OPT head)")

        def chunked(batch: Dict, generator=None):
            out = model(batch, generator=generator, return_hidden=True)
            return chunked_causal_losses(
                out["hidden"], model.lm.decoder.embed_tokens.weight,
                out["labels"], max_input_length, pad_token_id,
                n_chunks=chunked_ce, vocab=vocab, data=data)

        return chunked

    def loss_fn(batch: Dict, generator=None):
        return losses_of(model(batch, generator=generator), decoder_only,
                         max_input_length, pad_token_id, fused_ce=fused_ce,
                         vocab=vocab, data=data)

    return loss_fn


def average_over_data(grads: List[torch.Tensor], mesh) -> None:
    """The gradients averaged over the data group in place: one all-reduce
    (sum) of each dtype's flattened gradients, then 1 / data ranks."""
    group = mesh.data_group
    n = group_size(group)
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for same in by_dtype.values():
        flat = all_reduce(_flatten_dense_tensors(same), group)
        flat.mul_(1.0 / n)
        for g, synced in zip(same, _unflatten_dense_tensors(flat, same)):
            g.copy_(synced)


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (FSDP), else the tensor."""
    return t.to_local() if hasattr(t, "to_local") else t


def global_norm(grads: List[torch.Tensor], tp_sharded: List[bool], mesh,
                fsdp: bool) -> torch.Tensor:
    """The whole model's gradient norm from this rank's shares: squares of
    tensor-parallel shards summed over the model group, of FSDP shards over
    the data group; a replicated tensor counted once."""
    sq = torch.stack(torch._foreach_norm(grads)).square()
    tp = torch.tensor(tp_sharded, device=sq.device)
    parts = torch.stack([sq[~tp].sum(), sq[tp].sum()])
    if fsdp:
        all_reduce(parts, mesh.data_group)
    rep, shards = parts
    return torch.sqrt(rep + all_reduce(shards.clone(), mesh.model_group))


def make_train_step(model, optimizer: torch.optim.Optimizer,
                    scheduler, decoder_only: bool, max_input_length: int,
                    pad_token_id: int, grad_accumulation_steps: int = 1,
                    grad_clip: float = 0.0, fused_ce: bool = True,
                    chunked_ce: int = 0, mesh=None
                    ) -> Callable[[Dict, Optional[torch.Generator]], Dict]:
    """step(batch, generator) -> {"loss", "summary_loss", "grad_norm"}.

    ``batch`` is the loader's batch of ``accum * micro`` samples, split into
    ``accum`` micro-batches of consecutive rows (the JAX package's reshape
    to (accum, micro, ...)). ``generator`` is the dropout stream. The
    optimizer's parameters are the trainable set. ``mesh``: the rank's
    parallel/mesh.py Mesh, where ``batch`` is its data shard's."""
    accum = max(1, grad_accumulation_steps)
    loss_fn = make_loss_fn(model, decoder_only, max_input_length,
                           pad_token_id, fused_ce=fused_ce,
                           chunked_ce=chunked_ce, mesh=mesh)
    params = [p for group in optimizer.param_groups for p in group["params"]]
    names = {id(p): n for n, p in model.named_parameters()}
    gradless = getattr(model, "gradless_prefixes", ())
    meshed = mesh is not None and mesh.shape != (1, 1)
    n_data = 1 if mesh is None else mesh.n_data
    fsdp = getattr(model, "fsdp", False)
    tp_layout = getattr(model, "tp_layout", {})
    tp_sharded = [names.get(id(p)) in tp_layout for p in params]

    def apply_gradients() -> torch.Tensor:
        """Everything after the last backward; returns the gradients'
        global norm before clipping."""
        for p in params:
            if p.grad is None:
                # a trainable parameter the model declares off the gradient
                # path (the text pooler, behind the text tower's
                # stop_gradient) gets a zero gradient, as from jax.grad:
                # AdamW still decays it. Any other is cut off by mistake.
                name = names.get(id(p), "")
                if not name.startswith(gradless):
                    raise RuntimeError(
                        f"the trainable parameter {name or tuple(p.shape)} "
                        "got no gradient")
                p.grad = torch.zeros_like(p)
        grads = [_local(p.grad) for p in params]
        if n_data > 1 and not fsdp:
            average_over_data(grads, mesh)
        if accum > 1:
            torch._foreach_mul_(grads, 1.0 / accum)
        if meshed:
            grad_norm = global_norm(grads, tp_sharded, mesh, fsdp)
        else:
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
        if fsdp:
            invalidate_kept_casts()
        return grad_norm

    def update(batch: Dict, generator: Optional[torch.Generator]
               ) -> Dict[str, torch.Tensor]:
        model.train()
        n = batch["input_ids"].shape[0]
        if n % accum:
            raise ValueError(f"a batch of {n} does not split into {accum} "
                             "micro-batches")
        micro = n // accum
        sums = 0.0
        for i in range(accum):
            with spans.span("micro_batch"):
                mb = {k: v[i * micro:(i + 1) * micro]
                      for k, v in batch.items()}
                with spans.span("forward", device=True):
                    loss, s_loss = loss_fn(mb, generator)
                with spans.span("backward", device=True):
                    (loss * n_data if n_data > 1 else loss).backward()
                sums = sums + torch.stack([loss.detach(), s_loss.detach()])
        with spans.span("optimizer", device=True):
            grad_norm = apply_gradients()
        sums = sums / accum
        if meshed:
            all_reduce(sums, mesh.data_group)
        return {"loss": sums[0], "summary_loss": sums[1],
                "grad_norm": grad_norm}

    def step(batch: Dict, generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        with spans.span("update", device=True, root=True):
            return update(batch, generator)

    return step


def make_eval_step(model, decoder_only: bool, max_input_length: int,
                   pad_token_id: int, mesh=None) -> Callable[[Dict], Dict]:
    """Teacher-forced eval: loss + argmax predictions over the label span
    (run_generation.py:580-606 val path). step(batch) -> {"loss",
    "summary_loss", "predictions"}, all on the model's device. Runs the
    model in eval mode (``deterministic=True``: no dropout). On a mesh the
    losses are the global batch's (summed over the data group) and the
    predictions this rank's rows."""
    vocab, data = _groups(model, mesh)

    @torch.no_grad()
    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        model.eval()
        out = model(batch)
        loss, s_loss = losses_of(out, decoder_only, max_input_length,
                                 pad_token_id, vocab=vocab, data=data)
        if group_size(data) > 1:
            loss, s_loss = all_reduce(torch.stack([loss, s_loss]), data)
        span = (out["logits"][:, max_input_length:-1] if decoder_only
                else out["logits"])
        preds = vocab_argmax(span, vocab)
        return {"loss": loss, "summary_loss": s_loss, "predictions": preds}

    return step
