"""OPT-350M's architecture in the port against the JAX package, on the CPU.

OPT-350M is post-LN, and its 512-wide embeddings go through project_in to
the 1024-wide hidden states and project_out back before the tied head. The
tests run that architecture at tiny widths (hidden 64, embeddings 32, 2
layers, 4 heads of 16) in fp32: the JAX model initializes the weights, which
reach the port through mmgl_tpu_torch.utils.convert; inputs come from numpy
or the port's loader with a seed. Sequences of 128 tokens take K1's route
(its plain version here), of 1024 K4's with K6's plain version as its
backward (the blocked backward's flag on). Each test states its tolerance.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mmgl_tpu.models import factory as jfactory
from mmgl_tpu.models import opt as jopt
from mmgl_tpu.models.fusion import MMGLModel as JaxMMGLModel
from mmgl_tpu.peft import trainable_mask as jax_trainable_mask
from mmgl_tpu.train.generate import greedy_generate as jax_generate
from mmgl_tpu.train.optim import build_optimizer as jax_build_optimizer
from mmgl_tpu.train.steps import create_train_state
from mmgl_tpu.train.steps import make_train_step as jax_train_step
from mmgl_tpu.utils.tokenizer import ByteTokenizer
from mmgl_tpu_torch import cli
from mmgl_tpu_torch.models import factory, opt
from mmgl_tpu_torch.models.fusion import MMGLModel
from mmgl_tpu_torch.ops import attention as att
from mmgl_tpu_torch.ops import flash_attention as fa
from mmgl_tpu_torch.peft.masks import apply_trainable_mask
from mmgl_tpu_torch.train.generate import greedy_generate
from mmgl_tpu_torch.train.optim import build_optimizer
from mmgl_tpu_torch.train.steps import make_train_step
from mmgl_tpu_torch.utils import convert

# OPT-350M's shape at tiny widths: post-LN, project_in/out
POST_LN = dict(hidden_size=64, word_embed_proj_dim=32, num_hidden_layers=2,
               num_attention_heads=4, ffn_dim=128, do_layer_norm_before=False)
PAD = ByteTokenizer().pad_token_id


def _flat(tree):
    """A flax tree keyed by the port's parameter names, as numpy."""
    out = {}
    for path, value in convert._leaves(jax.device_get(tree)):
        name, transpose = convert._torch_name(path)
        out[name] = np.asarray(value.T if transpose else value)
    return out


def _lm_pair(vocab=97):
    kw = dict(POST_LN, vocab_size=vocab, pad_token_id=0, eos_token_id=2,
              bos_token_id=1)
    return (jopt.OPTForCausalLM(jopt.OPTConfig(dropout=0.0, **kw)),
            opt.OPTForCausalLM(opt.OPTConfig(dropout=0.0, **kw)))


def _hole_mask(b, s, seed):
    """A prompt, then a summary, each right-padded; key 0 valid."""
    rng = np.random.RandomState(seed)
    mask = np.ones((b, s), np.int32)
    cut = s * 7 // 8
    for i in range(b):
        mask[i, rng.randint(cut // 4, cut):cut] = 0
        mask[i, cut + rng.randint(1, s - cut):] = 0
    return mask


@pytest.mark.parametrize("s,route", [(128, "allheads"), (1024, "flash")])
def test_post_ln_opt_logits_and_grads_match_jax(monkeypatch, s, route):
    """Logits (atol 1e-4) and the gradient of a token cross-entropy with
    respect to every parameter, project_in/out included (atol 2e-5 x the
    largest gradient: sums over 2 x s tokens in another order), against
    jax.grad through mmgl_tpu's OPT; at 1024 tokens through K4 and, under
    the flag, K6's plain version."""
    monkeypatch.setattr(fa, "BLOCKED_BWD", True)
    jmodel, model = _lm_pair()
    assert att.attention_route((2, s, 4, 16), (2, s, 4, 16)) == route
    rng = np.random.RandomState(s)
    ids = rng.randint(3, 97, (2, s)).astype(np.int32)
    labels = rng.randint(3, 97, (2, s)).astype(np.int32)
    mask = _hole_mask(2, s, seed=s)
    params = jmodel.init(jax.random.PRNGKey(3), jnp.asarray(ids),
                         jnp.asarray(mask))["params"]
    assert {"project_in", "project_out"} <= set(params["decoder"])
    assert "final_layer_norm" not in params["decoder"]

    def jloss(params):
        logits, _ = jmodel.apply({"params": params}, jnp.asarray(ids),
                                 jnp.asarray(mask))
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, jnp.asarray(labels)[..., None], -1)
        return nll.mean(), logits

    (_, want_logits), want_grads = jax.value_and_grad(jloss, has_aux=True)(
        params)
    model.load_state_dict({
        k[len("lm."):]: v for k, v in convert.state_dict_from_jax(
            {"lm": jax.device_get(params)}).items()})
    calls = []
    blocked = fa.flash_attention_blocked_bwd
    monkeypatch.setattr(fa, "flash_attention_blocked_bwd", lambda *a, **kw: (
        calls.append(1), blocked(*a, **kw))[1])
    logits, _ = model(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    F.cross_entropy(logits.reshape(-1, 97),
                    torch.from_numpy(labels).long().reshape(-1)).backward()
    assert len(calls) == (2 if route == "flash" else 0)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), rtol=0, atol=1e-4)
    want = _flat(want_grads)
    top = max(float(np.abs(g).max()) for g in want.values())
    got = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].numpy(), g, rtol=0,
                                   atol=2e-5 * top, err_msg=name)
    assert float(got["decoder.project_in.weight"].abs().max()) > 0
    assert float(got["decoder.project_out.weight"].abs().max()) > 0


def _fusion_args(max_in=96, max_out=32, *extra):
    args, _ = cli.parse_cli([
        "--model_name_or_path", "opt-tiny", "--task", "section",
        "--context", "all", "--neighbor_mode", "raw",
        "--max_input_length", str(max_in), "--max_output_length",
        str(max_out), "--per_device_train_batch_size", "2",
        "--grad_accumulation_steps", "2", "--steps_per_epoch", "2",
        "--lr_warmup_steps", "2", "--lr_schedule_step_size", "1",
        "--learning_rate", "1e-3", "--grad_clip", "0.5", "--seed", "0",
        "--device", "cpu", *extra])
    args.decoder_only = True
    return args


def _fusion_pair(args, batch):
    """(JAX MMGLModel, its params, the port's MMGLModel on them) with the
    tiny post-LN OPT as the LM, raw neighbours, context=all."""
    tok = ByteTokenizer()
    jcfg = jfactory.build_fusion_config(args, tok.vocab_size, tokenizer=tok)
    jcfg = replace(jcfg, opt=replace(jcfg.opt, **POST_LN))
    jmodel = JaxMMGLModel(jcfg)
    micro = {k: v[:args.per_device_train_batch_size] for k, v in batch.items()}
    params = jax.device_get(
        jmodel.init(jax.random.PRNGKey(0), micro)["params"])
    cfg = factory.build_fusion_config(args, tok.vocab_size, tokenizer=tok)
    cfg = replace(cfg, opt=replace(cfg.opt, **POST_LN))
    model = MMGLModel(cfg)
    model.load_state_dict(convert.state_dict_from_jax(params))
    apply_trainable_mask(model, args.peft_type, args.freeze_lm)
    return jmodel, params, model.train()


def _loader_batches(args, n):
    train_ds = cli.setup_data(args, ByteTokenizer())[0]
    loader = cli.PrefetchLoader(
        train_ds, num_workers=1,
        batch_size=args.per_device_train_batch_size
        * args.grad_accumulation_steps)
    batches = list(loader)[:n]
    assert len(batches) == n
    return batches


def test_post_ln_fusion_raw_all_and_greedy_tokens_match_jax():
    """MMGLModel with the post-LN LM, raw neighbours, context=all: the
    visual soft tokens are sized by the 32-wide embedding (embed_dim), the
    fused logits match (atol 1e-4), and greedy KV-cache decode (prefill,
    then 31 single-token steps) gives the JAX package's tokens exactly."""
    args = _fusion_args()
    batch = _loader_batches(args, 1)[0]
    jmodel, params, model = _fusion_pair(args, batch)
    assert model.visual_embeddings.out_features == 32 * args.n_visual_tokens
    assert params["visual_embeddings"]["kernel"].shape[1] == 32 * 4
    want = jmodel.apply({"params": params}, batch)
    with torch.no_grad():
        got = model.eval()(batch)
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(want["labels"]))
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), rtol=0, atol=1e-4)
    want_ids = jax.jit(lambda p, b: jax_generate(jmodel, p, b,
                                                 max_new_tokens=32))(
        {"params": params}, batch)
    got_ids = greedy_generate(model, batch, max_new_tokens=32)
    assert got_ids.shape == (4, 32)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))


def test_post_ln_trainable_set_matches_jax():
    """project_in and project_out train under peft_type=none; the trainable
    flags equal mmgl_tpu.peft.trainable_mask's, with and without
    --freeze_lm."""
    for freeze in ("false", "true"):
        args = _fusion_args(96, 32, "--freeze_lm", freeze)
        batch = _loader_batches(args, 1)[0]
        _, params, model = _fusion_pair(args, batch)
        jmask = jax_trainable_mask(params, "none", freeze == "true")
        want = {convert._torch_name(path)[0]: bool(v)
                for path, v in convert._leaves(jmask)}
        got = {n: p.requires_grad for n, p in model.named_parameters()}
        assert got == want
        for name in ("lm.decoder.project_in.weight",
                     "lm.decoder.project_out.weight"):
            assert got[name] is (freeze == "false")


def test_factory_opt350m_config_matches_jax_field_by_field():
    """The factory's opt-350m config equals the JAX package's _opt_config
    in every field the port has: hidden 1024, 24 layers, 16 heads of 64,
    ffn 4096, embeddings 512, post-LN, no final LayerNorm, dropout 0.1; the
    soft tokens are 512 wide; and every parameter of the port's OPT-350M
    (built on the meta device) has the shape of the JAX one's after
    conversion."""
    tok = ByteTokenizer()
    args = _fusion_args(1920, 128)
    args.model_name_or_path = "opt-350m"
    got = factory.build_fusion_config(args, 50272, tokenizer=tok)
    want = jfactory.build_fusion_config(args, 50272, tokenizer=tok)
    for field in ("vocab_size", "hidden_size", "num_hidden_layers",
                  "num_attention_heads", "ffn_dim", "max_position_embeddings",
                  "word_embed_proj_dim", "do_layer_norm_before",
                  "remove_final_layer_norm", "activation_function",
                  "dropout", "layerdrop", "pad_token_id", "bos_token_id",
                  "eos_token_id", "embed_dim", "head_dim"):
        assert getattr(got.opt, field) == getattr(want.opt, field), field
    assert (got.opt.hidden_size, got.opt.num_hidden_layers,
            got.opt.num_attention_heads, got.opt.head_dim, got.opt.ffn_dim,
            got.opt.embed_dim, got.opt.do_layer_norm_before,
            got.opt.dropout) == (1024, 24, 16, 64, 4096, 512, False, 0.1)
    assert got.embed_dim == want.embed_dim == 512
    assert not got.opt.has_final_layer_norm

    ids = jnp.zeros((1, 8), jnp.int32)
    shapes = jax.eval_shape(
        lambda: jopt.OPTForCausalLM(want.opt).init(jax.random.PRNGKey(0),
                                                   ids))["params"]
    want_shapes = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        name, transpose = convert._torch_name(tuple(p.key for p in path))
        want_shapes[name] = leaf.shape[::-1] if transpose else leaf.shape
    with torch.device("meta"):
        model = opt.OPTForCausalLM(got.opt)
    got_shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert got_shapes == want_shapes
    n = sum(int(np.prod(s)) for s in got_shapes.values())
    assert 331_000_000 < n < 332_000_000, n


def test_post_ln_trajectory_at_1024_tokens_through_k4_and_k6(monkeypatch):
    """Four updates (accum 2 x micro 2) at --max_input_length 896
    --max_output_length 128, 1024 tokens, past K1's envelope: the port's
    attention runs K4 forward and, with the blocked backward's flag on,
    K6's plain version backward (2 layers x 2 micro-batches per update),
    against make_train_step + build_optimizer of the JAX package: loss,
    summary_loss and grad_norm within rtol 1e-5, trainable parameters
    within atol 1e-5 (the k_proj biases, whose true gradient is 0, within
    the summed learning rates, as in tests/test_torch_train.py); the frozen
    tower stays bit-identical."""
    monkeypatch.setattr(fa, "BLOCKED_BWD", True)
    calls = {"fwd": 0, "bwd": 0}
    for name, key in (("flash_attention", "fwd"),
                      ("flash_attention_blocked_bwd", "bwd")):
        orig = getattr(fa, name)
        monkeypatch.setattr(fa, name, lambda *a, _o=orig, _k=key, **kw: (
            calls.__setitem__(_k, calls[_k] + 1), _o(*a, **kw))[1])
    args = _fusion_args(896, 128)
    batches = _loader_batches(args, 4)
    assert batches[0]["input_ids"].shape == (4, 1024)
    jmodel, params, model = _fusion_pair(args, batches[0])
    tower = {k: v.clone() for k, v in model.state_dict().items()
             if k.startswith("visual_model.")}
    mask = jax_trainable_mask(params)
    tx = jax_build_optimizer(args, mask)
    state = create_train_state(params, tx)
    jstep = jax.jit(jax_train_step(jmodel, tx, True, args.max_input_length,
                                   PAD, 2, mask))
    optimizer, sched = build_optimizer(args, model.parameters())
    step = make_train_step(model, optimizer, sched, True,
                           args.max_input_length, PAD, 2, args.grad_clip)
    lrs = []
    for batch in batches:
        lrs.append(optimizer.param_groups[0]["lr"])
        jbatch = {k: v.reshape((2, 2) + v.shape[1:]) for k, v in batch.items()}
        state, want = jstep(state, jbatch, jax.random.PRNGKey(1))
        got = step(batch)
        for key in ("loss", "summary_loss", "grad_norm"):
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       rtol=1e-5, err_msg=key)
    assert calls == {"fwd": 4 * 2 * 2, "bwd": 4 * 2 * 2}

    init, want_params = _flat(params), _flat(state.params)
    got_params = dict(model.named_parameters())
    assert sorted(got_params) == sorted(want_params)
    for name, value in want_params.items():
        p = got_params[name].detach()
        if name.startswith("visual_model."):
            torch.testing.assert_close(p, tower[name], rtol=0, atol=0)
        elif name.endswith("self_attn.k_proj.bias"):
            assert np.abs(p.numpy() - init[name]).max() <= sum(lrs)
        else:
            np.testing.assert_allclose(p.numpy(), value, rtol=0, atol=1e-5,
                                       err_msg=name)
    for name in ("lm.decoder.project_in.weight",
                 "lm.decoder.project_out.weight"):
        assert not np.array_equal(got_params[name].detach().numpy(),
                                  init[name]), name
