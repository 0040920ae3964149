"""The port's training layer against the JAX package, on the CPU.

opt-tiny + tiny CLIP, task=section, context=all, raw neighbors, prompt 96 +
summary 32, 32 px images; fp32 (dropout 0, as the JAX package sets it for
tiny configs) unless a test says otherwise. The JAX model initializes the
weights, which reach the port through mmgl_tpu_torch.utils.convert; batches
come from the port's loader. Each test states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmgl_tpu.models import factory as jfactory
from mmgl_tpu.peft import count_params as jax_count_params
from mmgl_tpu.peft import trainable_mask as jax_trainable_mask
from mmgl_tpu.train.losses import causal_losses as jax_causal_losses
from mmgl_tpu.train.optim import build_optimizer as jax_build_optimizer
from mmgl_tpu.train.optim import lr_schedule as jax_lr_schedule
from mmgl_tpu.train.steps import create_train_state
from mmgl_tpu.train.steps import make_eval_step as jax_eval_step
from mmgl_tpu.train.steps import make_train_step as jax_train_step
from mmgl_tpu.utils.tokenizer import ByteTokenizer
from mmgl_tpu_torch import cli
from mmgl_tpu_torch.models import factory
from mmgl_tpu_torch.models.layers import Dropout
from mmgl_tpu_torch.peft.masks import count_params
from mmgl_tpu_torch.train.checkpoints import restore_checkpoint
from mmgl_tpu_torch.train.losses import causal_losses
from mmgl_tpu_torch.train.optim import build_optimizer, lr_factor
from mmgl_tpu_torch.train.steps import make_eval_step, make_train_step
from mmgl_tpu_torch.utils import convert

TINY = ["--model_name_or_path", "opt-tiny", "--task", "section",
        "--context", "all", "--neighbor_mode", "raw",
        "--max_input_length", "96", "--max_output_length", "32",
        "--per_device_train_batch_size", "2", "--grad_accumulation_steps",
        "2", "--per_device_val_batch_size", "2", "--val_steps_per_epoch", "1",
        "--steps_per_epoch", "4", "--print_freq", "1",
        "--dataloader_num_workers", "1", "--seed", "0", "--device", "cpu"]
PAD = ByteTokenizer().pad_token_id


def _args(*extra):
    args, _ = cli.parse_cli(TINY + list(extra))
    args.decoder_only = True
    return args


def _batches(args, n):
    """n loader batches of batch_size * accum training samples."""
    train_ds = cli.setup_data(args, ByteTokenizer())[0]
    loader = cli.PrefetchLoader(
        train_ds, num_workers=1,
        batch_size=args.per_device_train_batch_size
        * args.grad_accumulation_steps)
    batches = list(loader)[:n]
    assert len(batches) == n
    return batches


def _pair(args, batch):
    """(JAX model, its params, the port's model on the same weights)."""
    tok = ByteTokenizer()
    jmodel, _ = jfactory.build_model(args, vocab_size=tok.vocab_size,
                                     tokenizer=tok)
    micro = {k: v[:args.per_device_train_batch_size] for k, v in batch.items()}
    params = jax.device_get(
        jmodel.init(jax.random.PRNGKey(0), micro)["params"])
    model, _ = factory.build_model(args, torch.device("cpu"),
                                   vocab_size=tok.vocab_size, tokenizer=tok)
    model.load_state_dict(convert.state_dict_from_jax(params))
    return jmodel, params, model


def _torch_tree(tree):
    """A flax tree keyed by the port's parameter names."""
    return {convert._torch_name(path)[0]: (value.T if
                                           convert._torch_name(path)[1]
                                           else value)
            for path, value in convert._leaves(tree)}


# ---- cross-entropy -------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ce_function_matches_jax_grad(dtype):
    """Losses equal within 1e-6 (both fp32 from the same logits); gradients
    within 1e-7 in fp32 and one bf16 ulp of the largest entry in bf16."""
    rng = np.random.RandomState(0)
    logits = (rng.randn(2, 12, 50) * 3).astype(np.float32)
    labels = rng.randint(3, 50, (2, 12)).astype(np.int32)
    labels[0, 3] = -100
    labels[1, 9:] = PAD

    def jloss(x):
        loss, s_loss = jax_causal_losses(x, jnp.asarray(labels), 6, PAD)
        return loss + 0.5 * s_loss, (loss, s_loss)

    jl = jnp.asarray(logits).astype(dtype)
    (_, (want_loss, want_s)), want_grad = jax.value_and_grad(
        jloss, has_aux=True)(jl)

    tl = torch.from_numpy(logits).to(getattr(torch, dtype)).requires_grad_()
    loss, s_loss = causal_losses(tl, torch.from_numpy(labels).long(), 6, PAD)
    (loss + 0.5 * s_loss).backward()
    assert tl.grad.dtype == tl.dtype
    for got, want in ((loss, want_loss), (s_loss, want_s)):
        assert abs(float(got.detach()) - float(want)) <= 1e-6
    want_grad = np.asarray(want_grad.astype(jnp.float32))
    atol = 1e-7 if dtype == "float32" else 2 ** -8 * np.abs(want_grad).max()
    np.testing.assert_allclose(tl.grad.float().numpy(), want_grad, rtol=0,
                               atol=atol)


# ---- optimizer -------------------------------------------------------------

def test_lr_schedule_matches_jax():
    """Warmup over 3 updates, then a decay every 2: steps 0..10 cover the
    warmup and three decays; equal within fp32 rounding (rtol 1e-6)."""
    args = _args("--learning_rate", "3e-4", "--lr_warmup_steps", "3",
                 "--steps_per_epoch", "4", "--lr_schedule_step_size", "1",
                 "--lr_schedule_gamma", "0.5")
    want = jax_lr_schedule(args)
    got = lr_factor(args)
    for step in range(11):
        np.testing.assert_allclose(args.learning_rate * got(step),
                                   float(want(step)), rtol=1e-6)
    opt, sched = build_optimizer(args, [torch.nn.Parameter(torch.ones(2))])
    lrs = []
    for _ in range(11):
        lrs.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    np.testing.assert_allclose(lrs, [float(want(s)) for s in range(11)],
                               rtol=1e-6)


def test_trajectory_matches_make_train_step():
    """Four updates of accum 2 x micro 2, warmup 2, a decay at update 3 and a
    clip that fires, against make_train_step + build_optimizer: loss,
    summary_loss and grad_norm within rtol 1e-5, trainable parameters within
    atol 1e-5 (Adam steps of 1e-3 from sums in another order; the k_proj
    biases, see below, within the sum of the learning rates); the frozen
    tower stays bit-identical."""
    args = _args("--lr_warmup_steps", "2", "--steps_per_epoch", "2",
                 "--lr_schedule_step_size", "1", "--grad_clip", "0.5",
                 "--learning_rate", "1e-3")
    batches = _batches(args, 4)
    jmodel, params, model = _pair(args, batches[0])
    tower = {k: v.clone() for k, v in model.state_dict().items()
             if k.startswith("visual_model.")}

    mask = jax_trainable_mask(params)
    tx = jax_build_optimizer(args, mask)
    state = create_train_state(params, tx)
    jstep = jax.jit(jax_train_step(jmodel, tx, True, args.max_input_length,
                                   PAD, 2, mask))
    opt, sched = build_optimizer(args, model.parameters())
    step = make_train_step(model, opt, sched, True, args.max_input_length,
                           PAD, 2, args.grad_clip)
    norms, lrs = [], []
    for batch in batches:
        lrs.append(opt.param_groups[0]["lr"])
        jbatch = {k: v.reshape((2, 2) + v.shape[1:]) for k, v in batch.items()}
        state, want = jstep(state, jbatch, jax.random.PRNGKey(1))
        got = step(batch)
        for key in ("loss", "summary_loss", "grad_norm"):
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       rtol=1e-5, err_msg=key)
        norms.append(float(got["grad_norm"]))
    assert max(norms) > args.grad_clip, "the clip never fired"

    init = _torch_tree(params)
    want_params = _torch_tree(jax.device_get(state.params))
    got_params = dict(model.named_parameters())
    moved = 0
    for name, value in want_params.items():
        p = got_params[name]
        if name.startswith("visual_model."):
            assert not p.requires_grad
            torch.testing.assert_close(p.detach(), tower[name], rtol=0,
                                       atol=0)
            continue
        got = p.detach().numpy()
        if name.endswith("self_attn.k_proj.bias"):
            # a zero true gradient (softmax is invariant to a constant added
            # to a query's logits): Adam scales rounding noise to steps of
            # up to the learning rate on both sides, so only that bound holds
            assert np.abs(got - init[name]).max() <= sum(lrs)
            continue
        np.testing.assert_allclose(got, value, rtol=0, atol=1e-5,
                                   err_msg=name)
        moved += int(not np.array_equal(value, init[name]))
    assert moved > 0


def test_bf16_training_keeps_fp32_parameters_and_moments():
    """--bf16 true computes in bf16 but keeps the parameters and both Adam
    moments in fp32 (param_dtype); the bf16 eval loss matches the JAX
    package's bf16 eval loss within 2e-3 (bf16 rounding of activations
    whose order of operations differs)."""
    args = _args("--bf16", "true")
    batch = _batches(args, 1)[0]
    jmodel, params, model = _pair(args, batch)
    want = jax.jit(jax_eval_step(jmodel, True, args.max_input_length, PAD))(
        params, batch)
    got = make_eval_step(model, True, args.max_input_length, PAD)(batch)
    assert abs(float(got["loss"]) - float(want["loss"])) <= 2e-3

    opt, sched = build_optimizer(args, model.parameters())
    make_train_step(model, opt, sched, True, args.max_input_length, PAD, 2,
                    args.grad_clip)(batch)
    trainable = [p for p in model.parameters() if p.requires_grad]
    assert trainable and all(p.dtype == torch.float32 for p in trainable)
    for p in trainable:
        st = opt.state[p]
        assert st["exp_avg"].dtype == torch.float32
        assert st["exp_avg_sq"].dtype == torch.float32


@pytest.mark.parametrize("freeze_lm", [False, True])
def test_trainable_set_matches_jax(freeze_lm):
    """The model's requires_grad flags and trainable/total counts equal
    mmgl_tpu.peft.trainable_mask / count_params for peft_type=none."""
    args = _args("--freeze_lm", str(freeze_lm).lower())
    batch = _batches(args, 1)[0]
    _, params, model = _pair(args, batch)
    jmask = jax_trainable_mask(params, "none", freeze_lm)
    want = {convert._torch_name(path)[0]: bool(v)
            for path, v in convert._leaves(jmask)}
    got = {n: p.requires_grad for n, p in model.named_parameters()}
    assert got == want
    assert count_params(model) == jax_count_params(params, jmask)
    assert any(want.values()) and not all(want.values())


# ---- dropout ---------------------------------------------------------------

def test_dropout_keep_rate_scale_and_determinism():
    """Keep rate within 5 binomial sigmas of 0.9, kept values scaled by
    1/0.9, the identity in eval mode, the same mask from the same seed."""
    n, rate = 200_000, 0.1
    drop = Dropout(rate).train()
    x = torch.ones(n)
    y = drop(x, torch.Generator().manual_seed(0))
    kept = y != 0
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(float(kept.float().mean()) - (1 - rate)) <= 5 * sigma
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / (1 - rate)))
    assert torch.equal(drop(x, torch.Generator().manual_seed(0)), y)
    assert not torch.equal(drop(x, torch.Generator().manual_seed(1)), y)
    with pytest.raises(ValueError, match="generator"):
        drop(x)
    assert drop.eval()(x) is x


def test_dropout_rates_follow_the_jax_factory():
    """Hidden dropout 0.1 for OPT-125M, 0 for tiny configs
    (mmgl_tpu/models/factory.py:57); attention dropout is 0 in both."""
    for name, rate in (("opt-125m", 0.1), ("opt-tiny", 0.0)):
        args = _args("--model_name_or_path", name)
        got = factory.build_fusion_config(args).opt.dropout
        want = jfactory.build_fusion_config(args).opt
        assert got == want.dropout == rate
        assert want.attention_dropout == 0.0


def test_t5_dropout_rates_follow_the_jax_factory():
    """T5's dropout (hidden and attention probabilities, one rate) is 0.1
    for t5-base and 0 for t5-tiny, as mmgl_tpu/models/factory.py:72-82
    sets it; the decoder starts from the tokenizer's pad."""
    tok = ByteTokenizer()
    for name, rate in (("t5-base", 0.1), ("t5-tiny", 0.0)):
        args = _args("--model_name_or_path", name)
        got = factory.build_fusion_config(args, tokenizer=tok).t5
        want = jfactory.build_fusion_config(args, tokenizer=tok).t5
        assert got.dropout_rate == want.dropout_rate == rate
        assert (got.pad_token_id, got.eos_token_id,
                got.decoder_start_token_id) == (
            want.pad_token_id, want.eos_token_id,
            want.decoder_start_token_id) == (PAD, tok.eos_token_id, PAD)


def test_optimizer_is_chosen_by_model_name():
    """Adafactor at a constant rate for T5, AdamW under the schedule
    otherwise (mmgl_tpu/train/optim.py:45), each over the trainable
    parameters only."""
    from mmgl_tpu_torch.train.optim import Adafactor

    params = [torch.nn.Parameter(torch.ones(3, 2)),
              torch.nn.Parameter(torch.ones(2), requires_grad=False)]
    for name, kind in (("t5-base", Adafactor), ("opt-125m",
                                                torch.optim.AdamW)):
        opt, sched = build_optimizer(_args("--model_name_or_path", name),
                                     params)
        assert type(opt) is kind
        assert opt.param_groups[0]["params"] == params[:1]
        for _ in range(3):
            opt.step()
            sched.step()
        if kind is Adafactor:
            assert opt.param_groups[0]["lr"] == 1e-3


# ---- the training loop -----------------------------------------------------

def _force_dropout(monkeypatch, rate=0.1):
    """Build tiny models with hidden dropout on, so the dropout stream is
    part of what a replay must reproduce."""
    build = cli.build_model

    def build_with_dropout(*a, **kw):
        model, cfg = build(*a, **kw)
        for m in model.modules():
            if isinstance(m, Dropout):
                m.rate = rate
        return model, cfg

    monkeypatch.setattr(cli, "build_model", build_with_dropout)


def test_kill_and_resume_replays_the_uninterrupted_run(monkeypatch,
                                                       tmp_path):
    """Two epochs straight, against one epoch, then --resume for the second:
    the second epoch's losses and the epoch-1 checkpoint's parameters and
    optimizer moments are bit-identical; the towers are not saved."""
    _force_dropout(monkeypatch)
    flags = TINY + ["--save_every_epochs", "1", "--lr_warmup_steps", "2"]

    def train(log_dir, *extra):
        losses = {}
        cli.run(*cli.parse_cli(flags + ["--log_dir", str(log_dir), *extra]),
                lambda scalars, step: losses.setdefault(
                    step, scalars.get("train/loss")))
        return {s: v for s, v in losses.items() if v is not None}

    straight = train(tmp_path / "a", "--epochs", "2")
    train(tmp_path / "b", "--epochs", "1")
    resumed = train(tmp_path / "b", "--epochs", "2", "--resume", "default_0")
    assert sorted(straight) == [1, 2, 3, 4] and sorted(resumed) == [3, 4]
    assert [straight[s] for s in (3, 4)] == [resumed[3], resumed[4]]

    want = restore_checkpoint(str(tmp_path / "a/default_0/ckpt_latest"))
    got = restore_checkpoint(str(tmp_path / "b/default_1/ckpt_latest"))
    assert want["epoch"] == got["epoch"] == 1
    assert want["step"] == got["step"] == 4
    assert sorted(want["params"]) == sorted(got["params"])
    assert not any(k.startswith("visual_model.") for k in got["params"])
    assert any(k.startswith("visual_embeddings.") for k in got["params"])
    for k, v in want["params"].items():
        assert torch.equal(v, got["params"][k]), k
    for i, st in want["optimizer"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(st[key], got["optimizer"]["state"][i][key])
