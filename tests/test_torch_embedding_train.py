"""The port's embedding neighbor mode against the JAX package, on the CPU:
the trainable set, a training trajectory, the eval step and greedy decode,
and the entry point. The helpers, the tiny flags and their reasons are in
tests/test_torch_embedding.py. Each test states its tolerance.
"""

from functools import partial

import jax
import numpy as np
import pytest
import torch

from mmgl_tpu.peft import count_params as jax_count_params
from mmgl_tpu.peft import trainable_mask as jax_trainable_mask
from mmgl_tpu.train.generate import greedy_generate as jax_generate
from mmgl_tpu.train.optim import build_optimizer as jax_build_optimizer
from mmgl_tpu.train.steps import create_train_state
from mmgl_tpu.train.steps import make_eval_step as jax_eval_step
from mmgl_tpu.train.steps import make_train_step as jax_train_step
from mmgl_tpu_torch import cli
from mmgl_tpu_torch.ops import attention as att
from mmgl_tpu_torch.peft.masks import apply_trainable_mask, count_params
from mmgl_tpu_torch.train.generate import greedy_generate
from mmgl_tpu_torch.train.optim import build_optimizer
from mmgl_tpu_torch.train.steps import make_eval_step, make_train_step
from mmgl_tpu_torch.utils import convert
from test_torch_embedding import PAD, TINY, _args, _batches, _close, _pair


@pytest.mark.parametrize("freeze_lm", [False, True])
def test_embedding_trainable_set_matches_jax(freeze_lm):
    """requires_grad and the trainable/total counts equal the JAX package's
    trainable_mask / count_params: the towers frozen; the pooler, the
    projections, the position tables, lpe_embeddings and gnn trainable."""
    for position_type in ("laplacian", "gnn"):
        args = _args("opt-tiny", "all", position_type)
        batch = _batches(args, 1)[0]
        _, params, model = _pair(args, batch)
        apply_trainable_mask(model, "none", freeze_lm)
        jmask = jax_trainable_mask(params, "none", freeze_lm)
        want = {convert._torch_name(path)[0]: bool(v)
                for path, v in convert._leaves(jmask)}
        got = {n: p.requires_grad for n, p in model.named_parameters()}
        assert got == want
        assert count_params(model) == jax_count_params(params, jmask)
        for root in ("text_pooler", "text_embeddings", "visual_embeddings",
                     "text_position_embeddings",
                     "visual_position_embeddings",
                     {"laplacian": "lpe_embeddings",
                      "gnn": "gnn"}[position_type]):
            assert all(v for k, v in got.items()
                       if k.split(".")[0] == root), root
            assert any(k.split(".")[0] == root for k in got), root
        assert not any(v for k, v in got.items()
                       if k.startswith(("text_model.", "visual_model.")))


def _params_close(model, jax_params, towers, atol):
    """The port's parameters against a flax tree: trainable ones within
    atol, the towers' bit-identical to their initial values."""
    got_params = dict(model.named_parameters())
    moved = 0
    for path, value in convert._leaves(jax.device_get(jax_params)):
        name, flip = convert._torch_name(path)
        p = got_params[name]
        if name in towers:
            assert not p.requires_grad
            assert torch.equal(p.detach(), towers[name]), name
            continue
        got = p.detach().numpy()
        _close(got.T if flip else got, value, atol, name)
        moved += 1
    assert moved > 0


def test_t5_embedding_trajectory_matches_make_train_step():
    """Four Adafactor updates of t5-tiny, section_all embedding (accum 2 x
    micro 2, a clip that fires) against make_train_step + build_optimizer:
    loss and summary_loss within rtol 1e-5 at every update; grad_norm within
    rtol 1e-5 and the trainable parameters within atol 1e-5 (steps of up to
    the learning rate, 1e-3) through the third update; both towers
    bit-identical. The fourth update is held to rtol 1e-3 (grad_norm) and
    atol 2e-3 (parameters): Adafactor scales each row and column of a
    matrix by its own RMS, so the projections' small gradients, summed in
    another order, leave the two runs ~5e-7 apart after three updates, and
    at this seed that moves one of t5-tiny's ReLU units across zero in the
    fourth batch, which changes its gradient by a whole unit's share (from
    the same parameters the gradients agree within 1e-4 of their largest,
    test_embedding_forward_and_grads_match_jax)."""
    args = _args("t5-tiny", "section_all", "none", "--grad_clip", "0.5",
                 "--learning_rate", "1e-3")
    batches = _batches(args, 4)
    jmodel, params, model = _pair(args, batches[0])
    towers = {k: v.clone() for k, v in model.state_dict().items()
              if k.startswith(("visual_model.", "text_model."))}
    mask = jax_trainable_mask(params)
    tx = jax_build_optimizer(args, mask)
    state = create_train_state(params, tx)
    jstep = jax.jit(jax_train_step(jmodel, tx, False, args.max_input_length,
                                   PAD, 2, mask))
    opt, sched = build_optimizer(args, model)
    step = make_train_step(model, opt, sched, False, args.max_input_length,
                           PAD, 2, args.grad_clip)
    norms = []
    for i, batch in enumerate(batches):
        jbatch = {k: v.reshape((2, 2) + v.shape[1:]) for k, v in batch.items()}
        state, want = jstep(state, jbatch, jax.random.PRNGKey(1))
        got = step(batch)
        for key in ("loss", "summary_loss", "grad_norm"):
            rtol = 1e-3 if key == "grad_norm" and i == 3 else 1e-5
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       rtol=rtol, err_msg=key)
        norms.append(float(got["grad_norm"]))
        if i == 2:
            _params_close(model, state.params, towers, 1e-5)
    assert max(norms) > args.grad_clip, "the clip never fired"
    _params_close(model, state.params, towers, 2e-3)


@pytest.mark.parametrize("model_name,context,position_type", [
    ("t5-tiny", "section_all", "none"), ("opt-tiny", "all", "laplacian"),
    ("opt-tiny", "all", "gnn"), ("opt-tiny", "text_only", "embedding")])
def test_embedding_eval_step_and_greedy_decode_match_jax(
        model_name, context, position_type):
    """The teacher-forced eval step (loss within 1e-5, predictions exact)
    and greedy decode of one batch, token for token: T5 encodes the fused
    sequence; OPT prefills [prompt; soft tokens] under the combined mask
    and takes its first token at n_valid - 1 of that mask, as the JAX
    package does."""
    args = _args(model_name, context, position_type)
    batch = _batches(args, 1, split=2)[0]
    jmodel, params, model = _pair(args, batch)
    want = jax.jit(jax_eval_step(jmodel, args.decoder_only,
                                 args.max_input_length, PAD))(params, batch)
    got = make_eval_step(model, args.decoder_only, args.max_input_length,
                         PAD)(batch)
    for key in ("loss", "summary_loss"):
        assert abs(float(got[key]) - float(want[key])) <= 1e-5, key
    np.testing.assert_array_equal(got["predictions"].numpy(),
                                  np.asarray(want["predictions"]))
    want = jax.jit(partial(jax_generate, jmodel, max_new_tokens=16))(
        {"params": params}, batch)
    got = greedy_generate(model, batch, max_new_tokens=16)
    assert got.shape == (4, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("model_name,context,position_type", [
    ("t5-tiny", "section_all", "none"), ("opt-tiny", "all", "gnn")])
def test_cli_embedding_training_and_test_pass(model_name, context,
                                              position_type, tmp_path):
    """--neighbor_mode embedding through the entry point: training (the
    epoch-0 val pass, updates, val, the best checkpoint, the test pass on
    it) with finite metrics, then --test on a fresh model."""
    argv = ["--model_name_or_path", model_name, "--context", context,
            "--position_type", position_type, *TINY, "--epochs", "1",
            "--log_dir", str(tmp_path)]
    got = cli.main(argv)
    assert got["train_updates"] == 2.0
    assert all(np.isfinite(v) for v in got.values())
    got = cli.main(argv + ["--test", "true"])
    assert got["n_eval_pairs"] == 2.0 and all(np.isfinite(v)
                                              for v in got.values())


@pytest.mark.parametrize("q_shape,route", [
    ((44, 512, 12, 64), "allheads"),     # Roberta over 11 texts x 4
    ((4, 704, 12, 64), "allheads"),      # OPT, 640 + 16 x 4 soft tokens
    ((4, 576, 12, 64), "allheads"),      # its prefill, 512 + 64
    ((20, 197, 12, 64), "fused_heads"),  # CLIP over 5 images x 4
    ((2, 300, 2, 64), "fused_heads"),    # inside K2's envelope (384)
    ((4, 1000, 12, 64), "flash"),        # past both envelopes
])
def test_embedding_mode_shapes_take_the_kernel_routes(q_shape, route):
    """Unaligned self-attention takes K2 inside the JAX package's
    fused-heads envelope (S padded to 128 at most 512), else K1 inside the
    all-heads envelope (so OPT's 704 tokens train through K3, not K2's
    plain-version backward), else K4; T5's 576-token encoder, with its
    bias, takes K7."""
    assert att.attention_route(q_shape, q_shape) == route
    enc = (4, 576, 12, 64)
    assert att.attention_route(enc, enc, bias=True) == "bias"
