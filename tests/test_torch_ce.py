"""The port's plain and vocab-chunked cross-entropy against the JAX
package, on the CPU.

``--fused_ce false`` is the JAX ``_ce_plain`` (plain autograd of the fp32
logsumexp minus the gold logit); ``--chunked_ce n`` the JAX ``chunked_ce``,
which streams the tied head over n vocab chunks and never materialises the
(B, T, V) logits (mmgl_tpu/train/losses.py:67-78, 120-245). Both apply to
the decoder-only losses; T5 ignores ``--chunked_ce``, as the JAX CLI does.
fp32 throughout. Each test states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmgl_tpu.train.losses import causal_losses as jax_causal_losses
from mmgl_tpu.train.losses import \
    chunked_causal_losses as jax_chunked_causal_losses
from mmgl_tpu_torch import cli
from mmgl_tpu_torch.train import steps
from mmgl_tpu_torch.train.losses import (causal_losses,
                                         chunked_causal_losses)
from test_torch_embedding import PAD
from test_torch_peft_train import check_updates
# autouse: one intra-op thread for the module's tiny shapes
from test_torch_regularization import _one_thread  # noqa: F401

# a vocabulary that is a multiple of no n x 128 below: 1000 rows, padded to
# 1024 (n = 1, 8) or 1152 (n = 3)
VOCAB, WIDTH = 1000, 32
PROMPT = 6


def _labels(rng, b, t, v):
    """Labels with an ignored position and a pad run in the summary span."""
    labels = rng.randint(3, v, (b, t)).astype(np.int32)
    labels[0, 3] = -100
    labels[1, 2] = -100
    labels[1, t - 3:] = PAD
    return labels


def test_plain_ce_matches_jax():
    """``causal_losses(fused_ce=False)`` against the JAX package's with
    ``fused_ce=False``: loss and summary loss within 1e-6, the logits'
    gradient of loss + 0.5 summary loss within 1e-7, and the same numbers
    as the fused CE within those bounds."""
    rng = np.random.RandomState(0)
    logits = (rng.randn(2, 12, 50) * 3).astype(np.float32)
    labels = _labels(rng, 2, 12, 50)

    def jloss(x):
        loss, s_loss = jax_causal_losses(x, jnp.asarray(labels), PROMPT,
                                         PAD, fused_ce=False)
        return loss + 0.5 * s_loss, (loss, s_loss)

    (_, want), want_grad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(logits))
    got = {}
    for fused in (False, True):
        tl = torch.from_numpy(logits).requires_grad_()
        loss, s_loss = causal_losses(tl, torch.from_numpy(labels).long(),
                                     PROMPT, PAD, fused_ce=fused)
        (loss + 0.5 * s_loss).backward()
        got[fused] = (loss.detach(), s_loss.detach(), tl.grad)
    for fused in (False, True):
        loss, s_loss, grad = got[fused]
        for g, w in ((loss, want[0]), (s_loss, want[1])):
            assert abs(float(g) - float(w)) <= 1e-6, fused
        np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad),
                                   rtol=0, atol=1e-7)


@pytest.mark.parametrize("n_chunks", [1, 3, 8])
def test_chunked_ce_matches_jax_grad(n_chunks):
    """``chunked_causal_losses`` over n chunks against the JAX package's
    under ``jax.grad``, a vocabulary of 1000 (no multiple of n x 128),
    ignored labels and pads in the summary span: loss and summary loss
    within 1e-6, dhidden and the table's gradient of loss + 0.5 summary loss
    within 1e-5 of their largest entry (fp32 sums of up to 1000 products in
    another order: sqrt(1000) float32 ulps is 2e-6 of a term); and the
    losses equal the materialised
    ``hidden @ emb.T`` through ``causal_losses`` within 1e-5."""
    rng = np.random.RandomState(n_chunks)
    hidden = rng.randn(2, 12, WIDTH).astype(np.float32)
    emb = (rng.randn(VOCAB, WIDTH) / np.sqrt(WIDTH)).astype(np.float32)
    labels = _labels(rng, 2, 12, VOCAB)

    def jloss(h, e):
        loss, s_loss = jax_chunked_causal_losses(
            h, e, jnp.asarray(labels), PROMPT, PAD, n_chunks=n_chunks)
        return loss + 0.5 * s_loss, (loss, s_loss)

    (_, want), (want_h, want_e) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(hidden),
                                             jnp.asarray(emb))
    th = torch.from_numpy(hidden).requires_grad_()
    te = torch.from_numpy(emb).requires_grad_()
    tlabels = torch.from_numpy(labels).long()
    loss, s_loss = chunked_causal_losses(th, te, tlabels, PROMPT, PAD,
                                         n_chunks=n_chunks)
    (loss + 0.5 * s_loss).backward()
    for g, w in ((loss, want[0]), (s_loss, want[1])):
        assert abs(float(g.detach()) - float(w)) <= 1e-6
    for got, w in ((th.grad, want_h), (te.grad, want_e)):
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    full = causal_losses(torch.from_numpy(hidden @ emb.T), tlabels, PROMPT,
                         PAD)
    for g, w in zip((loss, s_loss), full):
        assert abs(float(g.detach()) - float(w)) <= 1e-5


def test_chunked_ce_skips_a_frozen_table():
    """With the table frozen (LoRA, --freeze_lm) the backward computes no
    table gradient, and dhidden is the one it computes with the table
    trainable."""
    rng = np.random.RandomState(4)
    hidden = torch.from_numpy(rng.randn(2, 12, WIDTH).astype(np.float32))
    emb = torch.from_numpy(rng.randn(VOCAB, WIDTH).astype(np.float32))
    labels = torch.from_numpy(_labels(rng, 2, 12, VOCAB)).long()
    grads = []
    for trainable in (False, True):
        h = hidden.clone().requires_grad_()
        e = emb.clone().requires_grad_(trainable)
        chunked_causal_losses(h, e, labels, PROMPT, PAD, 4)[0].backward()
        assert (e.grad is not None) == trainable
        grads.append(h.grad)
    assert torch.equal(grads[0], grads[1])


CHUNKED_CASES = {"opt-full": ("opt-tiny", "text_only", "none", ())}


def test_chunked_ce_two_updates_match_jax():
    """Two AdamW updates of opt-tiny with every parameter trained, the tied
    table among them (its gradient sums the lookup's share and the head's),
    with --chunked_ce 4 in both packages: loss rtol 1e-5 at each, every
    parameter atol 1e-5 at a learning rate of 1e-3 (check_updates); the
    k_proj biases (a zero true gradient: softmax ignores a constant added
    to a query's logits) within check_updates' noise bound."""
    check_updates("opt-full", CHUNKED_CASES, skip=("k_proj.bias",),
                  chunked_ce=4)


def test_chunked_ce_loss_fn_takes_the_pre_head_states(monkeypatch):
    """The train step's loss with --chunked_ce asks the model for its
    pre-head states and hands the tied table itself to the loss; without
    it, for the logits. T5 refuses the pre-head states."""
    from test_torch_embedding import _args, _batches

    args = _args("opt-tiny", "text_only", "none")
    tok = cli.get_tokenizer(args.tokenizer_path)
    model, _ = cli.build_model(args, torch.device("cpu"),
                               vocab_size=tok.vocab_size, tokenizer=tok)
    batch = {k: v[:2] for k, v in _batches(args, 1)[0].items()}
    seen = []
    real = steps.chunked_causal_losses

    def spy(hidden, emb, *a, **kw):
        seen.append((tuple(hidden.shape), emb))
        return real(hidden, emb, *a, **kw)

    monkeypatch.setattr(steps, "chunked_causal_losses", spy)
    chunked = steps.make_loss_fn(model, True, args.max_input_length, PAD,
                                 chunked_ce=4)(batch)
    plain = steps.make_loss_fn(model, True, args.max_input_length, PAD)(
        batch)
    width = model.config.opt.embed_dim
    assert len(seen) == 1 and seen[0][1] is \
        model.lm.decoder.embed_tokens.weight
    assert seen[0][0][-1] == width
    for a, b in zip(chunked, plain):
        assert abs(float(a.detach()) - float(b.detach())) <= 1e-5
    t5_args = _args("t5-tiny")
    t5_model, _ = cli.build_model(t5_args, torch.device("cpu"),
                                  vocab_size=tok.vocab_size, tokenizer=tok)
    with pytest.raises(ValueError, match="OPT and MPT only"):
        t5_model(batch, return_hidden=True)


class _Built(Exception):
    """Stops a run once its train step is built."""


def test_t5_ignores_chunked_ce(monkeypatch, tmp_path):
    """Through the entry point, the train step T5 gets with --chunked_ce 4
    is the one it gets without the flag (the JAX CLI passes it only where
    the model is decoder-only), while OPT's takes the 4 chunks."""
    from test_torch_t5 import TINY

    def built(*a, **kw):
        raise _Built(a[3:], kw)

    monkeypatch.setattr(cli, "make_train_step", built)
    steps_of = {}
    for model, extra in (("t5-tiny", ()), ("t5-tiny", ("--chunked_ce", "4")),
                         ("opt-tiny", ("--chunked_ce", "4"))):
        args, device = cli.parse_cli(TINY + [
            "--model_name_or_path", model, "--context", "section_only",
            "--log_dir", str(tmp_path), *extra])
        with pytest.raises(_Built) as stop:
            cli.run(args, device)
        steps_of[model, bool(extra)] = stop.value.args
    assert steps_of["t5-tiny", True] == steps_of["t5-tiny", False]
    assert steps_of["t5-tiny", True][1]["chunked_ce"] == 0
    assert steps_of["opt-tiny", True][1]["chunked_ce"] == 4
