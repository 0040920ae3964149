"""The port's T5 against the JAX package, on the CPU, in fp32, dropout off.

Weights are initialized by the JAX package and carried over through
mmgl_tpu_torch.utils.convert; inputs come from numpy with a seed, batches
from the port's loader. Lengths are chosen so every attention takes the
route it takes on T5-base: the encoder's self-attention with its bias and
the decoder's causal self-attention with its bias K7's (its plain version
here), the cross-attention (sq != sk, no bias) K4's, decode steps the
reference. Each test states its tolerance.
"""

import copy
from dataclasses import replace
from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmgl_tpu import cli as jcli
from mmgl_tpu.models import factory as jfactory
from mmgl_tpu.models import t5 as jt5
from mmgl_tpu.peft import count_params as jax_count_params
from mmgl_tpu.peft import trainable_mask as jax_trainable_mask
from mmgl_tpu.train.generate import greedy_generate as jax_generate
from mmgl_tpu.train.optim import build_optimizer as jax_build_optimizer
from mmgl_tpu.train.steps import create_train_state
from mmgl_tpu.train.steps import make_eval_step as jax_eval_step
from mmgl_tpu.train.steps import make_train_step as jax_train_step
from mmgl_tpu.utils.tokenizer import ByteTokenizer
from mmgl_tpu_torch import cli
from mmgl_tpu_torch.models import t5
from mmgl_tpu_torch.models.factory import build_model
from mmgl_tpu_torch.models.layers import Dropout
from mmgl_tpu_torch.ops import attention as att
from mmgl_tpu_torch.peft.masks import count_params
from mmgl_tpu_torch.train.checkpoints import restore_checkpoint
from mmgl_tpu_torch.train.generate import greedy_generate
from mmgl_tpu_torch.train.optim import Adafactor, build_optimizer
from mmgl_tpu_torch.train.steps import make_eval_step, make_train_step
from mmgl_tpu_torch.utils import convert

PAD = ByteTokenizer().pad_token_id
TINY = ["--model_name_or_path", "t5-tiny", "--task", "section",
        "--context", "all", "--neighbor_mode", "raw",
        "--max_input_length", "96", "--max_output_length", "32",
        "--per_device_train_batch_size", "2", "--grad_accumulation_steps",
        "2", "--per_device_val_batch_size", "2", "--val_steps_per_epoch", "1",
        "--steps_per_epoch", "4", "--print_freq", "1",
        "--dataloader_num_workers", "1", "--seed", "0", "--device", "cpu"]

# (d_model, d_kv, d_ff, heads, feed_forward_proj): t5-tiny's shape with
# each FFN, and one with T5-base's head dim 64
MODEL_CASES = [(64, 16, 128, 4, "relu"), (64, 16, 128, 4, "gated-gelu"),
               (128, 64, 256, 2, "relu")]


def _configs(d_model, d_kv, d_ff, heads, ffn, vocab=97):
    kw = dict(vocab_size=vocab, d_model=d_model, d_kv=d_kv, d_ff=d_ff,
              num_layers=2, num_decoder_layers=2, num_heads=heads,
              feed_forward_proj=ffn, dropout_rate=0.0, pad_token_id=0,
              eos_token_id=2, decoder_start_token_id=0)
    return jt5.T5Config(use_pallas=False, **kw), t5.T5Config(**kw)


def _port_weights(params, prefix="lm"):
    sd = convert.state_dict_from_jax({prefix: jax.device_get(params)})
    return {k[len(prefix) + 1:]: v for k, v in sd.items()}


def _hole_mask(b, s, seed):
    rng = np.random.RandomState(seed)
    mask = np.ones((b, s), np.int32)
    for i in range(b):
        mask[i, rng.randint(s // 4, s // 2):s // 2] = 0
        mask[i, s - rng.randint(1, s // 8):] = 0
    return mask


def _model_pair(case, s_enc=64, s_dec=40, seed=0):
    jcfg, cfg = _configs(*case)
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, 97, (3, s_enc)).astype(np.int32)
    mask = _hole_mask(3, s_enc, seed)
    labels = rng.randint(3, 97, (3, s_dec)).astype(np.int32)
    labels[:, -5:] = -100
    jmodel = jt5.T5ForConditionalGeneration(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(ids),
                         jnp.asarray(mask), jnp.asarray(labels))["params"]
    model = t5.T5ForConditionalGeneration(cfg).eval()
    model.load_state_dict(_port_weights(params))
    return jmodel, params, model, (ids, mask, labels)


@pytest.mark.parametrize("case", MODEL_CASES)
def test_t5_logits_match_jax(case):
    """T5ForConditionalGeneration logits from ids, a pad-holed encoder mask
    and -100 labels (shifted right into the decoder): atol 1e-4, as the OPT
    logits test."""
    jmodel, params, model, (ids, mask, labels) = _model_pair(case)
    want = jmodel.apply({"params": params}, jnp.asarray(ids),
                        jnp.asarray(mask), jnp.asarray(labels))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                    labels=torch.from_numpy(labels).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def test_t5_prefix_bias_built_once_a_stack_matches_jax(monkeypatch):
    """t5-tiny's shape with decoder prefixes (5 keys, so each decoder
    self-attention has 40 + 5 = 45 keys, a ragged row), a pad-holed decoder
    mask and encoder mask: the stack builds the position bias with the
    prefix's zero columns and its rows padded to 48 once, and every decoder
    layer's K7 (its plain version here) gets that same view, its mask the
    prefix's ones; loss, logits and every gradient (the relative-position
    tables and the prefixes included) those of the JAX T5 with the same
    prefixes, through the CE loss of the labels: logits atol 1e-4,
    gradients atol 1e-4 of the largest entry plus 1e-7
    (tests/test_torch_peft.py's tolerances)."""
    from mmgl_tpu.train.losses import seq2seq_loss
    from mmgl_tpu_torch.ops import flash_attention as fa

    case, p = MODEL_CASES[0], 5
    jmodel, params, model, (ids, mask, labels) = _model_pair(case)
    b, s_dec = labels.shape
    h, d = case[3], case[1]
    rng = np.random.RandomState(11)
    prefix = [tuple(rng.randn(p, h, d).astype(np.float32) for _ in range(2))
              for _ in range(2)]
    dmask = _hole_mask(b, s_dec, seed=3)

    def jax_loss(params, prefix):
        logits = jmodel.apply({"params": params}, jnp.asarray(ids),
                              jnp.asarray(mask), jnp.asarray(labels),
                              decoder_attention_mask=jnp.asarray(dmask),
                              prefix_kvs=prefix)
        return seq2seq_loss(logits, jnp.asarray(labels)), logits

    grad_fn = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)
    (want_loss, want_logits), (want_g, want_pg) = jax.jit(grad_fn)(
            params, [tuple(jnp.asarray(t) for t in kv) for kv in prefix])

    seen = []
    kernel = fa.flash_attention_bias

    def spy(q, k, v, *, bias=None, kv_mask=None, **kw):
        if q.shape[1] == s_dec and k.shape[1] == s_dec + p:
            seen.append((bias, kv_mask))
        return kernel(q, k, v, bias=bias, kv_mask=kv_mask, **kw)

    monkeypatch.setattr(fa, "flash_attention_bias", spy)
    kvs = [tuple(torch.from_numpy(t).requires_grad_() for t in kv)
           for kv in prefix]
    logits = model(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                   labels=torch.from_numpy(labels).long(),
                   decoder_attention_mask=torch.from_numpy(dmask),
                   prefix_kvs=kvs)
    loss = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]),
        torch.from_numpy(labels).long().reshape(-1), ignore_index=-100)
    loss.backward()
    assert len(seen) == 2                      # each decoder layer, on K7
    bias, kv_mask = seen[0]
    assert all(x is bias and y is kv_mask for x, y in seen)
    assert bias.shape == (1, h, s_dec, s_dec + p) and bias.stride(2) == 48
    assert kv_mask.dtype == torch.int32 and bool((kv_mask[:, :p] == 1).all())
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    got = dict(model.named_parameters())
    checked = []
    for path, g in convert._leaves({"lm": jax.device_get(want_g)}):
        name, flip = convert._torch_name(path)
        grad = got[name[len("lm."):]].grad.numpy()
        g = np.asarray(g)
        np.testing.assert_allclose(grad.T if flip else grad, g, rtol=0,
                                   atol=1e-4 * np.abs(g).max() + 1e-7,
                                   err_msg=name)
        checked.append(name)
    assert any("relpos_bias" in n and "decoder" in n for n in checked)
    for kv, want in zip(kvs, want_pg):
        for t, g in zip(kv, want):
            g = np.asarray(g)
            np.testing.assert_allclose(t.grad.numpy(), g, rtol=0,
                                       atol=1e-4 * np.abs(g).max() + 1e-7)


def test_t5_cached_decode_matches_full_forward():
    """Encoder once, then one decoder token per step over the in-place cache
    (bias at query offset t over the whole buffer, reference route), against
    the decoder over all tokens at once (K7's route): atol 1e-5."""
    jmodel, params, model, (ids, mask, labels) = _model_pair(MODEL_CASES[2])
    dec = torch.from_numpy(np.where(labels < 0, 0, labels)).long()
    steps = 6
    with torch.no_grad():
        enc = model.encode(torch.from_numpy(ids).long(),
                           torch.from_numpy(mask))
        full, _ = model.decode(dec, enc, torch.from_numpy(mask))
        caches = t5.t5_init_cache(model.config, 3, steps, torch.device("cpu"))
        for t in range(steps):
            step, _ = model.decode(dec[:, t:t + 1], enc,
                                   torch.from_numpy(mask), caches=caches,
                                   position_offset=t)
            # the step attends keys 0..t of a buffer of `steps`; the full
            # pass's row t sees the same keys causally
            np.testing.assert_allclose(step[:, 0].numpy(),
                                       full[:, t].numpy(), rtol=0, atol=1e-5)
    assert all(c.index == steps for c in caches)


def test_shift_right_and_position_buckets_match_jax():
    """shift_right, the bucket function (both directions, distances past
    max_distance) and the (1, H, q, k) bias with a decode offset: exact."""
    rng = np.random.RandomState(0)
    labels = rng.randint(3, 50, (3, 9)).astype(np.int32)
    labels[:, 6:] = -100
    np.testing.assert_array_equal(
        t5.shift_right(torch.from_numpy(labels).long(), 0, 1).numpy(),
        np.asarray(jt5.shift_right(jnp.asarray(labels), 0, 1)))
    rel = np.arange(-400, 401)
    for bidirectional in (True, False):
        want = jt5._relative_position_bucket(jnp.asarray(rel), bidirectional,
                                             32, 128)
        got = t5._relative_position_bucket(torch.from_numpy(rel),
                                           bidirectional, 32, 128)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    table = rng.randn(32, 4).astype(np.float32)
    for q, k, off, bi in ((17, 17, 0, True), (1, 40, 23, False),
                          (12, 300, 0, False)):
        want = jt5.compute_position_bias(jnp.asarray(table), q, k, bi, 32,
                                         128, q_offset=off)
        got = t5.compute_position_bias(torch.from_numpy(table), q, k, bi, 32,
                                       128, q_offset=off)
        assert got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rms_norm_matches_jax_in_fp32_and_bf16():
    """RMSNorm, eps 1e-6: equal within 1e-6 in fp32 and to the bf16 ulp in
    bf16 (the variance in fp32, then rounded once)."""
    from mmgl_tpu.models.layers import RMSNorm as JRMSNorm
    from mmgl_tpu_torch.models.layers import RMSNorm

    rng = np.random.RandomState(3)
    x = (rng.randn(4, 7, 48) * 3).astype(np.float32)
    w = rng.randn(48).astype(np.float32)
    for jdt, tdt, atol in ((jnp.float32, torch.float32, 1e-6),
                           (jnp.bfloat16, torch.bfloat16, 0.0)):
        jx = jnp.asarray(x).astype(jdt)
        want = JRMSNorm(1e-6, jdt).apply({"params": {"weight": w}}, jx)
        norm = RMSNorm(48, compute_dtype=tdt)
        norm.weight.data.copy_(torch.from_numpy(w))
        got = norm(torch.from_numpy(x).to(tdt))
        assert norm.eps == 1e-6 and got.dtype == tdt
        np.testing.assert_allclose(got.float().detach().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=0, atol=atol)


# ---- the MMGL model: fusion, eval step, greedy decode, convert -------------

def _args(*extra):
    args, _ = cli.parse_cli(TINY + list(extra))
    args.decoder_only = False
    return args


def _batches(args, n, split=0):
    ds = cli.setup_data(args, ByteTokenizer())[split]
    b = (args.per_device_train_batch_size * args.grad_accumulation_steps
         if split == 0 else 4)
    loader = cli.PrefetchLoader(ds, num_workers=1, batch_size=b)
    batches = list(loader)[:n]
    assert len(batches) == n
    return batches


def _pair(args, batch):
    """(JAX model, its params, the port's model on the same weights)."""
    tok = ByteTokenizer()
    jmodel, _ = jfactory.build_model(args, vocab_size=tok.vocab_size,
                                     tokenizer=tok)
    micro = {k: v[:2] for k, v in batch.items()}
    params = jax.device_get(
        jmodel.init(jax.random.PRNGKey(0), micro)["params"])
    model, _ = build_model(args, torch.device("cpu"),
                           vocab_size=tok.vocab_size, tokenizer=tok)
    model.load_state_dict(convert.state_dict_from_jax(params))
    return jmodel, params, model


@pytest.fixture(scope="module")
def test_pair():
    args = _args()
    batch = _batches(args, 1, split=2)[0]
    return (args, batch) + _pair(args, batch)


def test_state_dict_from_jax_covers_t5(test_pair):
    """Every parameter of the port's T5 + CLIP model comes from the JAX
    tree, with the same shape; RMSNorm weights and the bucket tables
    included."""
    args, batch, jmodel, params, model = test_pair
    sd = convert.state_dict_from_jax(params)
    own = model.state_dict()
    assert sorted(sd) == sorted(own)
    assert all(sd[k].shape == own[k].shape for k in own)
    for key in ("lm.shared.weight", "lm.encoder.relpos_bias.weight",
                "lm.decoder.layers.1.cross_attn_norm.weight",
                "lm.decoder.layers.0.cross_attn.q.weight",
                "lm.encoder.final_layer_norm.weight"):
        assert key in sd, key


def test_fusion_t5_matches_jax_raw_all(test_pair):
    """t5-tiny + tiny CLIP, raw all: image soft tokens spliced into the
    encoder input, padded image slots dropped, labels left alone: labels
    exact, logits atol 1e-4."""
    args, batch, jmodel, params, model = test_pair
    assert (batch["image_positions"] == args.max_input_length).any()
    want = jmodel.apply({"params": params}, batch)
    with torch.no_grad():
        got = model(batch)
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(want["labels"]))
    np.testing.assert_array_equal(got["labels"].numpy(), batch["labels"])
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), rtol=0, atol=1e-4)


def test_t5_eval_step_matches_jax(test_pair):
    """The teacher-forced eval step: loss and summary loss within 1e-5,
    predictions (argmax over all decoder positions) exact."""
    args, batch, jmodel, params, model = test_pair
    want = jax.jit(jax_eval_step(jmodel, False, args.max_input_length,
                                 PAD))(params, batch)
    got = make_eval_step(model, False, args.max_input_length, PAD)(batch)
    for key in ("loss", "summary_loss"):
        assert abs(float(got[key]) - float(want[key])) <= 1e-5, key
    np.testing.assert_array_equal(got["predictions"].numpy(),
                                  np.asarray(want["predictions"]))


def test_t5_greedy_generate_matches_jax(test_pair):
    """Encoder once, decode from the start token with the cache: token for
    token, 32 tokens."""
    args, batch, jmodel, params, model = test_pair
    want = jax.jit(partial(jax_generate, jmodel, max_new_tokens=32))(
        {"params": params}, batch)
    got = greedy_generate(model, batch, max_new_tokens=32)
    assert got.shape == (4, 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- training: Adafactor, trajectory, trainable set, resume -----------------

@pytest.mark.parametrize("transposed", [False, True])
def test_adafactor_matches_optax(transposed):
    """Three updates on a square matrix, a wide one, a (32, 12) table, a 3-D
    tensor and a vector, against optax.adafactor(lr,
    multiply_by_parameter_scale=False, min_dim_size_to_factor=2): atol 3e-7
    on parameters of order 1, two fp32 ulps (the same fp32 ops, sums in
    another order). With ``transposed`` the port holds the matrices
    transposed (as Linear weights) and factors them in the flax layout."""
    rng = np.random.RandomState(0)
    shapes = [(16, 16), (8, 40), (32, 12), (3, 5, 7), (9,)]
    init = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[(rng.randn(*s) * 10 ** rng.uniform(-3, 1)).astype(np.float32)
              for s in shapes] for _ in range(3)]
    tx = optax.adafactor(1e-2, multiply_by_parameter_scale=False,
                         min_dim_size_to_factor=2)
    jparams = [jnp.asarray(p) for p in init]
    state = tx.init(jparams)
    flip = [transposed and len(s) == 2 for s in shapes]
    params = [torch.nn.Parameter(torch.from_numpy((p.T if f else p).copy()))
              for p, f in zip(init, flip)]
    opt = Adafactor(params, lr=1e-2,
                    transposed=[p for p, f in zip(params, flip) if f])
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state,
                                   jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, x, f in zip(params, g, flip):
            p.grad = torch.from_numpy(x.T.copy() if f else x)
        opt.step()
    for p, want, f, start in zip(params, jparams, flip, init):
        got = p.detach().numpy()
        np.testing.assert_allclose(got.T if f else got, np.asarray(want),
                                   rtol=0, atol=3e-7)
        assert not np.array_equal(np.asarray(want), start)


def test_t5_trajectory_matches_make_train_step():
    """Four Adafactor updates of accum 2 x micro 2 with a clip that fires,
    against make_train_step + build_optimizer: loss, summary_loss and
    grad_norm within rtol 1e-5, trainable parameters within atol 1e-5
    (steps of up to the learning rate, 1e-3, from sums in another order);
    the frozen tower stays bit-identical."""
    args = _args("--grad_clip", "0.5", "--learning_rate", "1e-3")
    batches = _batches(args, 4)
    jmodel, params, model = _pair(args, batches[0])
    tower = {k: v.clone() for k, v in model.state_dict().items()
             if k.startswith("visual_model.")}

    mask = jax_trainable_mask(params)
    tx = jax_build_optimizer(args, mask)
    state = create_train_state(params, tx)
    jstep = jax.jit(jax_train_step(jmodel, tx, False, args.max_input_length,
                                   PAD, 2, mask))
    opt, sched = build_optimizer(args, model)
    assert isinstance(opt, Adafactor)
    step = make_train_step(model, opt, sched, False, args.max_input_length,
                           PAD, 2, args.grad_clip)
    norms = []
    for batch in batches:
        jbatch = {k: v.reshape((2, 2) + v.shape[1:]) for k, v in batch.items()}
        state, want = jstep(state, jbatch, jax.random.PRNGKey(1))
        got = step(batch)
        for key in ("loss", "summary_loss", "grad_norm"):
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       rtol=1e-5, err_msg=key)
        norms.append(float(got["grad_norm"]))
    assert max(norms) > args.grad_clip, "the clip never fired"

    want_params = jax.device_get(state.params)
    got_params = dict(model.named_parameters())
    moved = 0
    for path, value in convert._leaves(want_params):
        name, flip = convert._torch_name(path)
        p = got_params[name]
        if name.startswith("visual_model."):
            assert not p.requires_grad
            torch.testing.assert_close(p.detach(), tower[name], rtol=0,
                                       atol=0)
            continue
        got = p.detach().numpy()
        np.testing.assert_allclose(got.T if flip else got, value, rtol=0,
                                   atol=1e-5, err_msg=name)
        moved += 1
    assert moved > 0
    # state only for the trainable tensors: v_row/v_col or v each
    trainable = [p for p in model.parameters() if p.requires_grad]
    assert set(map(id, opt.state)) == set(map(id, trainable))


@pytest.mark.parametrize("freeze_lm", [False, True])
def test_t5_trainable_set_matches_jax(freeze_lm, test_pair):
    """requires_grad and the trainable/total counts equal the JAX package's
    trainable_mask / count_params for T5 under peft_type=none."""
    params, model = test_pair[3], copy.deepcopy(test_pair[4])
    from mmgl_tpu_torch.peft.masks import apply_trainable_mask
    apply_trainable_mask(model, "none", freeze_lm)
    jmask = jax_trainable_mask(params, "none", freeze_lm)
    want = {convert._torch_name(path)[0]: bool(v)
            for path, v in convert._leaves(jmask)}
    got = {n: p.requires_grad for n, p in model.named_parameters()}
    assert got == want
    assert count_params(model) == jax_count_params(params, jmask)
    assert any(want.values()) and not all(want.values())


def _force_dropout(monkeypatch, rate=0.1):
    """t5-tiny with hidden and attention-prob dropout on, so both streams
    are part of what a replay must reproduce."""
    build = cli.build_model

    def build_with_dropout(*a, **kw):
        model, cfg = build(*a, **kw)
        for m in model.modules():
            if isinstance(m, Dropout):
                m.rate = rate
            if isinstance(m, t5.T5Attention):
                m.cfg = replace(m.cfg, dropout_rate=rate)
        return model, cfg

    monkeypatch.setattr(cli, "build_model", build_with_dropout)


def test_t5_kill_and_resume_replays_the_uninterrupted_run(monkeypatch,
                                                          tmp_path):
    """Two epochs straight, against one epoch then --resume for the second,
    with both dropouts on: the second epoch's losses, the epoch-1
    checkpoint's parameters and the Adafactor state are bit-identical."""
    _force_dropout(monkeypatch)
    flags = TINY + ["--save_every_epochs", "1"]

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
    assert want["epoch"] == got["epoch"] == 1 and want["step"] == 4
    for k, v in want["params"].items():
        assert torch.equal(v, got["params"][k]), k
    states = want["optimizer"]["state"]
    assert states and all(st["step"] == 4 for st in states.values())
    for i, st in states.items():
        for key, v in st.items():
            other = got["optimizer"]["state"][i][key]
            assert (torch.equal(v, other) if torch.is_tensor(v)
                    else v == other), (i, key)


def test_attention_dropout_draws_from_the_generator():
    """In training mode the T5 attention draws its dropout key from the
    generator it is given: the same generator state gives the same output,
    another gives another, and none raises."""
    _, cfg = _configs(128, 64, 256, 2, "relu")
    attn = t5.T5Attention(replace(cfg, dropout_rate=0.1)).train()
    x = torch.randn(2, 40, 128, generator=torch.Generator().manual_seed(0))
    a = attn(x, generator=torch.Generator().manual_seed(1))
    b = attn(x, generator=torch.Generator().manual_seed(1))
    c = attn(x, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="generator"):
        attn(x)
    seed = att.draw_dropout_seed(torch.Generator().manual_seed(1))
    assert seed.shape == (2,) and seed.dtype == torch.int64


# ---- the CLI ---------------------------------------------------------------

def _jax_test_pass_keys(batch):
    """The metric keys of the JAX package's evaluate_loop test pass for an
    encoder-decoder model (on stub steps: the keys do not depend on it)."""
    b = batch["input_ids"].shape[0]
    args = _args("--test", "true")
    return jcli.evaluate_loop(
        [batch], None, SimpleNamespace(params={}),
        lambda params, x: {"loss": jnp.float32(1.0)},
        lambda variables, x: jnp.full((b, 32), 4 + ord("a"), jnp.int32),
        ByteTokenizer(), args, SimpleNamespace(decoder_only=False),
        jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                          ("data", "model")), 0, lambda *a: None,
        prefix="test")


def test_cli_t5_test_pass_and_training(test_pair, tmp_path):
    """t5-tiny through the entry point: the test pass returns the JAX
    package's metric keys; training (epoch-0 val, two Adafactor updates,
    val and best checkpoint, the test pass on it) returns them plus
    train_updates."""
    keys = sorted(_jax_test_pass_keys(test_pair[1]))
    got = cli.main(TINY + ["--test", "true", "--val_steps_per_epoch", "2"])
    assert sorted(got) == keys and got["n_eval_pairs"] == 4.0
    assert all(np.isfinite(v) for v in got.values())
    got = cli.main(TINY + ["--epochs", "1", "--log_dir", str(tmp_path)])
    assert got.pop("train_updates") == 2.0
    assert sorted(got) == keys
    assert (tmp_path / "default_0" / "ckpt" / "checkpoint.pt").exists()
