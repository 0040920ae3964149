"""mmgl_tpu_torch models against the JAX package's, on the CPU, in fp32.

Weights are initialized by the JAX package and carried over through
mmgl_tpu_torch.utils.convert; inputs come from numpy with a seed. Shapes are
chosen so the port's attention takes each route: head dim 64 with S % 128 ==
0 (K1's plain version), other S >= 32 (K2's), S < 32 (the reference).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmgl_tpu.config import Arguments
from mmgl_tpu.models import clip as jclip
from mmgl_tpu.models import factory as jfactory
from mmgl_tpu.models import opt as jopt
from mmgl_tpu.utils.tokenizer import ByteTokenizer
from mmgl_tpu_torch.data.assemble import AssemblerConfig, WikiWeb2MAssembler
from mmgl_tpu_torch.data.loader import PrefetchLoader
from mmgl_tpu_torch.data.synthetic import make_synthetic_corpus
from mmgl_tpu_torch.models import clip, opt
from mmgl_tpu_torch.models.factory import build_model
from mmgl_tpu_torch.utils.convert import state_dict_from_jax


def _port_weights(params, prefix):
    """Converted state dict of one sub-tree, keys relative to it."""
    sd = state_dict_from_jax({prefix: jax.device_get(params)})
    return {k[len(prefix) + 1:]: v for k, v in sd.items()}


# (hidden, heads, image_size, patch): 17 tokens at head dim 16 (reference
# route), 37 tokens at head dim 64 (K2 route)
@pytest.mark.parametrize("hidden,heads,image,patch", [(32, 2, 32, 8),
                                                      (128, 2, 48, 8)])
def test_clip_vision_tower_matches_jax(hidden, heads, image, patch):
    kw = dict(hidden_size=hidden, num_hidden_layers=2,
              num_attention_heads=heads, intermediate_size=2 * hidden,
              image_size=image, patch_size=patch)
    jmodel = jclip.CLIPVisionModel(jclip.CLIPVisionConfig(**kw))
    rng = np.random.RandomState(0)
    pixels = rng.randint(0, 256, (3, 3, image, image)).astype(np.uint8)
    valid = np.array([1, 0, 1], bool)
    jpix = jclip.normalize_pixels(jnp.asarray(pixels), jnp.asarray(valid))
    params = jmodel.init(jax.random.PRNGKey(1), jpix)["params"]
    _, want = jmodel.apply({"params": params}, jpix)

    model = clip.CLIPVisionModel(clip.CLIPVisionConfig(**kw))
    model.load_state_dict(_port_weights(params, "visual_model"))
    tpix = clip.normalize_pixels(torch.from_numpy(pixels),
                                 torch.from_numpy(valid))
    np.testing.assert_array_equal(tpix.numpy(), np.asarray(jpix))
    with torch.no_grad():
        _, got = model(tpix)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def _opt_pair(vocab=97):
    kw = dict(vocab_size=vocab, hidden_size=128, num_hidden_layers=2,
              num_attention_heads=2, ffn_dim=256, pad_token_id=0,
              eos_token_id=2, bos_token_id=1)
    jmodel = jopt.OPTForCausalLM(jopt.OPTConfig(dropout=0.0, **kw))
    model = opt.OPTForCausalLM(opt.OPTConfig(**kw)).eval()
    return jmodel, model


def _padded_mask(b, s, seed):
    """Prompt-then-summary masks with pads in the middle."""
    rng = np.random.RandomState(seed)
    mask = np.ones((b, s), np.int32)
    for i in range(b):
        mask[i, rng.randint(s // 4, s // 2):s // 2] = 0
        mask[i, s - rng.randint(0, s // 8):] = 0
    return mask


@pytest.mark.parametrize("s", [128, 72])           # K1 route, K2 route
def test_opt_logits_match_jax_with_padded_mask(s):
    jmodel, model = _opt_pair()
    rng = np.random.RandomState(s)
    ids = rng.randint(0, 97, (3, s)).astype(np.int32)
    mask = _padded_mask(3, s, seed=s)
    params = jmodel.init(jax.random.PRNGKey(2), jnp.asarray(ids),
                         jnp.asarray(mask))["params"]
    want, _ = jmodel.apply({"params": params}, jnp.asarray(ids),
                           jnp.asarray(mask))
    model.load_state_dict(_port_weights(params, "lm"))
    with torch.no_grad():
        got, _ = model(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def test_opt_prefill_and_cached_decode_match_full_forward():
    """Prefill 128 slots (K1 route, causal over the segment), then four
    single-token steps over the cache (reference route), against one
    forward over all 132 tokens."""
    _, model = _opt_pair()
    torch.manual_seed(0)
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.2)
    rng = np.random.RandomState(5)
    prompt, steps = 128, 4
    ids = torch.from_numpy(rng.randint(0, 97, (2, prompt + steps))).long()
    mask = torch.from_numpy(_padded_mask(2, prompt, seed=5))
    full_mask = torch.cat([mask, torch.ones(2, steps, dtype=mask.dtype)], 1)
    with torch.no_grad():
        full, _ = model(ids, full_mask)
        caches = opt.init_cache(model.config, 2, prompt + steps,
                                torch.device("cpu"))
        pre, _ = model(ids[:, :prompt], mask, caches=caches)
        np.testing.assert_allclose(pre.numpy(), full[:, :prompt].numpy(),
                                   rtol=0, atol=1e-5)
        pos = mask.sum(1)
        for t in range(steps):
            step, _ = model(ids[:, prompt + t:prompt + t + 1], mask,
                            caches=caches, position_ids=(pos + t)[:, None])
            np.testing.assert_allclose(step[:, 0].numpy(),
                                       full[:, prompt + t].numpy(), rtol=0,
                                       atol=1e-5)
    assert all(c.index == prompt + steps for c in caches)


def _fusion_batch(args, tok):
    cfg = AssemblerConfig.from_args(args)
    cfg.image_size = 32
    store, ids, provider = make_synthetic_corpus(num_pages=8, image_size=32,
                                                 seed=1)
    ds = WikiWeb2MAssembler(cfg, store, ids, tok, provider)
    return next(iter(PrefetchLoader(ds, batch_size=4, num_workers=1)))


@pytest.mark.parametrize("max_in,max_out", [(96, 32), (64, 24)])
def test_fusion_model_matches_jax_raw_all(max_in, max_out):
    """MMGLModel, opt-tiny, raw neighbors, context=all: image soft tokens
    spliced at image_positions, padded image slots dropped, -100 labels.
    S = 128 takes K1's route, S = 88 K2's."""
    tok = ByteTokenizer()
    args = Arguments(model_name_or_path="opt-tiny", context="all",
                     neighbor_mode="raw", max_input_length=max_in,
                     max_output_length=max_out, seed=0, decoder_only=True)
    batch = _fusion_batch(args, tok)
    s = max_in + max_out
    assert (batch["image_positions"] == s).any(), "no padded image slot"
    assert batch["images_valid"].sum() > 0

    jmodel, _ = jfactory.build_model(args, vocab_size=tok.vocab_size,
                                     tokenizer=tok)
    params = jmodel.init(jax.random.PRNGKey(0), batch)["params"]
    want = jmodel.apply({"params": params}, batch)

    model, _ = build_model(args, torch.device("cpu"),
                           vocab_size=tok.vocab_size, tokenizer=tok)
    model.load_state_dict(state_dict_from_jax(jax.device_get(params)))
    with torch.no_grad():
        got = model(batch)
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(want["labels"]))
    assert (got["labels"].numpy() == -100).sum() > 0
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), rtol=0, atol=1e-4)


def test_convert_rejects_unported_parameters():
    """Modules the port does not have (the text tower converts since the
    embedding mode, PEFT's virtual tokens and LoRA's adapters since PEFT)
    and unknown leaves raise."""
    with pytest.raises(KeyError, match="cached_pooled"):
        state_dict_from_jax({"lm": {}, "cached_pooled": {}})
    with pytest.raises(KeyError, match="lora_c"):
        state_dict_from_jax({"lm": {"q_proj": {"lora_c": np.zeros((2, 2))}}})
    got = state_dict_from_jax({"lm": {"q_proj": {"lora_a": np.zeros((2, 3))}},
                               "prompt_tuning": {"embedding": np.zeros(4)}})
    assert got["lm.q_proj.lora_a"].shape == (2, 3)   # kept (in, r)
    assert set(got) == {"lm.q_proj.lora_a", "prompt_tuning.weight"}


def test_kept_casts_follow_every_write_and_keep_the_graph():
    """cast_at_use keeps a parameter's bf16 cast only where no gradient can
    flow into it, and a kept cast never outlives a write: an optimizer step
    and load_state_dict both give the freshly cast values (exact)."""
    from mmgl_tpu_torch.models import layers

    torch.manual_seed(0)
    lin = layers.Linear(8, 4, compute_dtype=torch.bfloat16)
    emb = layers.Embedding(10, 8, compute_dtype=torch.bfloat16)
    x, ids = torch.randn(3, 8), torch.tensor([[1, 4, 9]])

    def fresh():
        return (torch.nn.functional.linear(
                    x.bfloat16(), lin.weight.bfloat16(), lin.bias.bfloat16()),
                emb.weight[ids].bfloat16(),
                x.bfloat16() @ emb.weight.bfloat16().T)

    def run():
        return lin(x), emb(ids), emb.attend(x)

    with torch.no_grad():
        first = run()
        kept = layers.cast_at_use(lin.weight, torch.bfloat16)
        assert layers.cast_at_use(lin.weight, torch.bfloat16) is kept
        for got, want in zip(first, fresh()):
            torch.testing.assert_close(got, want, rtol=0, atol=0)

    # with grad: a cast in the graph, the kept one freed
    out = sum(t.float().sum() for t in run())
    assert out.grad_fn is not None and "_kept_cast" not in lin.weight.__dict__
    out.backward()
    assert float(lin.weight.grad.abs().sum()) > 0
    assert float(emb.weight.grad.abs().sum()) > 0
    torch.optim.AdamW(list(lin.parameters()) + list(emb.parameters()),
                      lr=0.1).step()
    with torch.no_grad():
        for got, want in zip(run(), fresh()):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
        run()                                     # keep the casts again
        lin.load_state_dict({"weight": torch.randn(4, 8),
                             "bias": torch.randn(4)})
        emb.load_state_dict({"weight": torch.randn(10, 8)})
        for got, want in zip(run(), fresh()):
            torch.testing.assert_close(got, want, rtol=0, atol=0)

    # a frozen parameter keeps its cast with grad mode on
    lin.requires_grad_(False)
    assert (layers.cast_at_use(lin.weight, torch.bfloat16)
            is layers.cast_at_use(lin.weight, torch.bfloat16))
    assert layers.cast_at_use(lin.weight, torch.float32) is lin.weight


def test_layer_norm_rounds_like_flax_in_bf16():
    """The port's LayerNorm on a bf16 input with fp32 scale and bias equals
    flax's LayerNorm(dtype=bfloat16, param_dtype=float32)."""
    import flax.linen as fnn

    from mmgl_tpu_torch.models import layers

    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 16).astype(np.float32)
    scale, bias = rng.randn(16).astype(np.float32), rng.randn(16).astype(
        np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = fnn.LayerNorm(epsilon=1e-5, dtype=jnp.bfloat16).apply(
        {"params": {"scale": scale, "bias": bias}}, xb)
    ln = layers.LayerNorm(16, eps=1e-5, compute_dtype=torch.bfloat16)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
        got = ln(torch.from_numpy(np.array(xb.astype(jnp.float32))
                                  ).bfloat16())
    assert got.dtype == torch.bfloat16
    # bf16 outputs: at most one rounding step apart (fp32 summation order)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=2 ** -7)
