"""The port's PEFT against the JAX package, on the CPU: training updates and
greedy decode. The cases, helpers and their reasons are in
tests/test_torch_peft.py. Each test states its tolerance.
"""

import copy
from functools import partial

import jax
import numpy as np
import pytest
import torch

from mmgl_tpu.peft import trainable_mask as jax_trainable_mask
from mmgl_tpu.train.generate import greedy_generate as jax_generate
from mmgl_tpu.train.optim import build_optimizer as jax_build_optimizer
from mmgl_tpu.train.steps import _make_grads_fn, create_train_state
from mmgl_tpu.train.steps import make_train_step as jax_train_step
from mmgl_tpu_torch.train.generate import greedy_generate
from mmgl_tpu_torch.train.optim import Adafactor, build_optimizer
from mmgl_tpu_torch.train.steps import make_train_step
from mmgl_tpu_torch.utils import convert
from test_torch_embedding import PAD, _batches, _close
from test_torch_peft import CASES, jax_pair, port_model


def _torch_tree(params):
    return {convert._torch_name(path)[0]: (
        value.T if convert._torch_name(path)[1] else value)
        for path, value in convert._leaves(params)}


def _noise(grads, skip):
    """The largest |g| of the leaves named in ``skip``, asserted to be at
    most 1e-6 of the largest |g| of all: rounding noise."""
    top = max(float(np.abs(np.asarray(g)).max()) for g in grads.values())
    got = max(float(np.abs(np.asarray(g)).max()) for n, g in grads.items()
              if any(s in n for s in skip))
    assert got <= 1e-6 * top, (got, top)
    return got


def _noise_step(opt_step, model, skip, noise, *a, **kw):
    """The port's optimizer step, after recording the skipped leaves'
    gradient noise (the accumulated, clipped gradient the step takes)."""
    noise["port"] = max(noise["port"], _noise(
        {n: p.grad for n, p in model.named_parameters()
         if p.grad is not None}, skip))
    return opt_step(*a, **kw)


def check_updates(name, cases=CASES, updates=2, skip=(), chunked_ce=0):
    """``updates`` updates of accum 2 x micro 2 with a clip that fires,
    against make_train_step + build_optimizer (AdamW for OPT and MPT,
    Adafactor for T5): loss and summary_loss rtol 1e-5 at each, then every
    trainable parameter atol 1e-5, the frozen ones bit-identical. The
    learning rate is 1e-3 from the first update (no warmup), so an update
    moves a parameter by up to 1e-3, a hundred times the tolerance.

    The names in ``skip`` have a zero true gradient: in each package their
    gradient at every update is rounding noise, at most 1e-6 of the
    largest. Adam's step of such a leaf is then noise too, at most lr x
    max|g| / eps plus its weight decay, and differs between the packages
    by as much; so each package's move of it is held to that bound, from
    its own gradients, and not to the other's. ``chunked_ce`` n > 0: both
    steps take the vocab-chunked CE over n chunks."""
    args, _, jmodel, params = jax_pair(name, cases)
    args = copy.copy(args)
    args.grad_clip, args.learning_rate, args.lr_warmup_steps = 0.5, 1e-3, 1
    batches = _batches(args, updates)
    model = port_model(args, params)
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    mask = jax_trainable_mask(params, args.peft_type, args.freeze_lm)
    tx = jax_build_optimizer(args, mask)
    state = create_train_state(params, tx)
    jstep = jax.jit(jax_train_step(jmodel, tx, args.decoder_only,
                                   args.max_input_length, PAD, 2, mask,
                                   chunked_ce=chunked_ce))
    opt, sched = build_optimizer(args, model)
    step = make_train_step(model, opt, sched, args.decoder_only,
                           args.max_input_length, PAD, 2, args.grad_clip,
                           chunked_ce=chunked_ce)
    lrs = []
    noise = {"port": 0.0, "jax": 0.0}    # the skipped leaves' largest |g|
    if skip:
        trainable = {n for n, p in model.named_parameters()
                     if p.requires_grad}
        jgrads = jax.jit(_make_grads_fn(jmodel, tx, args.decoder_only,
                                        args.max_input_length, PAD, 2, mask,
                                        chunked_ce=chunked_ce))
        opt.step = partial(_noise_step, opt.step, model, skip, noise)
    for batch in batches:
        lrs.append(opt.param_groups[0]["lr"])
        jbatch = {k: v.reshape((2, 2) + v.shape[1:]) for k, v in batch.items()}
        if skip:
            grads = _torch_tree(jax.device_get(jgrads(
                state.params, jbatch, jax.random.PRNGKey(1))[0]))
            noise["jax"] = max(noise["jax"], _noise(
                {n: g for n, g in grads.items() if n in trainable}, skip))
        state, want = jstep(state, jbatch, jax.random.PRNGKey(1))
        got = step(batch)
        for key in ("loss", "summary_loss"):
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       rtol=1e-5, err_msg=key)
    got_params = dict(model.named_parameters())
    moved = 0
    for pname, value in _torch_tree(jax.device_get(state.params)).items():
        p = got_params[pname]
        if not p.requires_grad:
            assert torch.equal(p.detach(), init[pname]), pname
            continue
        got = p.detach().numpy()
        if any(s in pname for s in skip):
            start = init[pname].numpy()
            decay = args.weight_decay * max(np.abs(start).max(),
                                            np.abs(got).max())
            eps = opt.param_groups[0]["eps"]
            for who, end in (("port", got), ("jax", value)):
                bound = sum(lrs) * (noise[who] / eps + decay)
                assert np.abs(end - start).max() <= bound, (pname, who)
            continue
        _close(got, value, 1e-5, pname)
        moved += int(not torch.equal(p.detach(), init[pname]))
    assert moved > 0


@pytest.mark.parametrize("name", ["opt-lora", "opt-prefix", "t5-prefix"])
def test_peft_two_updates_match_jax(name):
    """Two training updates (AdamW for OPT, Adafactor for T5's prefix,
    whose 5-D table it factors over its two largest dims as optax does):
    loss rtol 1e-5, parameters atol 1e-5; the LM and the towers frozen."""
    check_updates(name)


def test_adafactor_factors_the_prefix_table_as_optax():
    """The (layers, 2, P, H, D) prefix table's factored dims are optax's
    (the two largest, by argsort of the shape): P and D at T5-base's
    (12, 2, 20, 12, 64)."""
    opt = Adafactor([torch.nn.Parameter(torch.zeros(1))], lr=1e-3)
    assert opt._factored_dims((12, 2, 20, 12, 64)) == (2, 4)


@pytest.mark.parametrize("name", ["opt-prompt", "opt-prefix", "t5-prefix"])
def test_peft_greedy_tokens_match_jax(name):
    """Greedy decode of one test batch, token for token against the JAX
    package. Prompt tuning prefills [virtual tokens; prompt; soft tokens].
    Prefix tuning pins the JAX package's behaviour of running generation
    without the prefix: the tokens stay the same when the prefix table is
    replaced, in both packages."""
    args, _, jmodel, params = jax_pair(name)
    batch = _batches(args, 1, split=2)[0]
    model = port_model(args, params)
    gen = jax.jit(partial(jax_generate, jmodel, max_new_tokens=8))
    want = gen({"params": params}, batch)
    got = greedy_generate(model, batch, max_new_tokens=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if args.peft_type == "prefix":
        params = {**params, "prefix_tuning": {
            "kv": params["prefix_tuning"]["kv"] * -50.0}}
        with torch.no_grad():
            model.prefix_tuning.kv.mul_(-50.0)
        np.testing.assert_array_equal(
            greedy_generate(model, batch, max_new_tokens=8).numpy(),
            got.numpy())
        np.testing.assert_array_equal(
            np.asarray(gen({"params": params}, batch)), got.numpy())
        # the teacher-forced forward does take it
        micro = {k: v[:2] for k, v in batch.items()}
        a = model(micro)["logits"].detach()
        with torch.no_grad():
            model.prefix_tuning.kv.zero_()
        assert not torch.equal(a, model(micro)["logits"].detach())
