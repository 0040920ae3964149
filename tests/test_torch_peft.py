"""The port's PEFT (LoRA, prefix and prompt tuning) against the JAX package,
on the CPU.

BASELINE families 3 (OPT + LoRA, text_only), 5 (prefix tuning with the
Laplacian encoding, without its mesh) and 6 (prompt tuning with the GCN),
and T5's decoder prefixes and encoder prompt, at tiny sizes in fp32 with
dropout off. The JAX package (``use_pallas=False``) gets the port's seeded
weights in a tree shaped by ``jax.eval_shape`` of its init (no init is
compiled), and the port's model under test gets them back through
mmgl_tpu_torch.utils.convert. LoRA's B starts at zero, so it is set to
seeded non-zero values on both sides before any comparison, or A would
have nothing to compare. The tiny flags are tests/test_torch_embedding.py's.
Each test states its tolerance.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from mmgl_tpu.models import factory as jfactory
from mmgl_tpu.peft import count_params as jax_count_params
from mmgl_tpu.peft import trainable_mask as jax_trainable_mask
from mmgl_tpu.utils.tokenizer import ByteTokenizer
from mmgl_tpu_torch.models.factory import build_model
from mmgl_tpu_torch.peft.masks import apply_trainable_mask, count_params
from mmgl_tpu_torch.train.steps import losses_of
from mmgl_tpu_torch.utils import convert
from test_torch_embedding import PAD, _args, _batches, _close

# (model, context, position_type, peft flags): the families and T5's forms
CASES = {
    "opt-lora": ("opt-tiny", "text_only", "none",
                 ("--peft_type", "lora", "--lora_r", "4", "--lora_alpha",
                  "2")),
    "opt-prefix": ("opt-tiny", "all", "laplacian", ("--peft_type", "prefix")),
    "opt-prompt": ("opt-tiny", "all", "gnn", ("--peft_type", "prompt")),
    "t5-prefix": ("t5-tiny", "section_all", "none",
                  ("--peft_type", "prefix")),
    "t5-prompt": ("t5-tiny", "section_all", "none",
                  ("--peft_type", "prompt")),
}
# leaves that start at zero and are given seeded values before a check
_ZERO_AT_INIT = ("lora_b", "gating1", "gating2")
_PAIRS = {}


def perturb(params, seed=7):
    """The flax tree with every leaf of _ZERO_AT_INIT drawn from a seeded
    normal(0, 0.5): LoRA's B and the flamingo gates."""
    rng = np.random.RandomState(seed)

    def walk(tree):
        return {k: (walk(v) if isinstance(v, dict) else
                    rng.normal(0, 0.5, np.shape(v)).astype(np.float32)
                    if k in _ZERO_AT_INIT else v)
                for k, v in tree.items()}
    return walk(params)


def shape_pair(args, batch):
    """(the JAX model (``use_pallas=False``), its parameter tree holding
    the port's seeded weights, the port's model from build_model). The
    JAX tree's structure and shapes come from ``jax.eval_shape`` of its
    init, which traces and compiles nothing; each leaf is the port's
    tensor in the flax layout (utils/convert.py's map backwards), so both
    packages run on the same numbers."""
    tok = ByteTokenizer()
    jargs = copy.copy(args)
    jargs.use_pallas = False
    jmodel, _ = jfactory.build_model(jargs, vocab_size=tok.vocab_size,
                                     tokenizer=tok)
    micro = {k: v[:2] for k, v in batch.items()}
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), micro)
    model, _ = build_model(args, torch.device("cpu"),
                           vocab_size=tok.vocab_size, tokenizer=tok)
    state = model.state_dict()

    def fill(tree, prefix=()):
        out = {}
        for key, leaf in tree.items():
            if isinstance(leaf, dict):
                out[key] = fill(leaf, prefix + (key,))
                continue
            name, flip = convert._torch_name(prefix + (key,))
            value = state[name].numpy()
            out[key] = np.array(value.T if flip else value)  # a copy
            assert out[key].shape == leaf.shape, name
        return out
    return jmodel, fill(shapes["params"]), model


def check_trainable_set(args, batch, peft_type):
    """For both --freeze_lm values: requires_grad equal to the JAX
    trainable_mask leaf for leaf, and the counts to its count_params.
    Returns {name: trainable} under --freeze_lm true."""
    _, params, model = shape_pair(args, batch)
    assert set(convert.state_dict_from_jax(params)) == set(
        model.state_dict())
    for freeze_lm in (False, True):
        apply_trainable_mask(model, peft_type, freeze_lm)
        jmask = jax_trainable_mask(params, peft_type, freeze_lm)
        want = {convert._torch_name(path)[0]: bool(v)
                for path, v in convert._leaves(jmask)}
        got = {n: p.requires_grad for n, p in model.named_parameters()}
        assert got == want, freeze_lm
        assert count_params(model) == jax_count_params(params, jmask)
    return got


def case_args(model, context, position_type, flags):
    return _args(model, context, position_type, *flags)


def jax_pair(name, cases=CASES):
    """(args, a training batch, the JAX model, its params with LoRA's B and
    the gates seeded), cached per case."""
    if name not in _PAIRS:
        args = case_args(*cases[name])
        batch = _batches(args, 1)[0]
        jmodel, params, _ = shape_pair(args, batch)
        _PAIRS[name] = (args, batch, jmodel, perturb(params))
    return _PAIRS[name]


def port_model(args, params):
    """The port's model from build_model, on the flax tree's weights."""
    tok = ByteTokenizer()
    model, _ = build_model(args, torch.device("cpu"),
                           vocab_size=tok.vocab_size, tokenizer=tok)
    model.load_state_dict(convert.state_dict_from_jax(params))
    return model


def jax_loss(jmodel, args, batch):
    from mmgl_tpu.train.losses import causal_losses, seq2seq_loss

    def loss(params):
        """(the loss, the forward's logits and labels)."""
        out = jmodel.apply({"params": params}, batch)
        if args.decoder_only:
            return causal_losses(out["logits"], out["labels"],
                                 args.max_input_length, PAD)[0], out
        return seq2seq_loss(out["logits"], out["labels"]), out
    return loss


def check_forward_and_grads(args, batch, jmodel, params, model):
    """Labels exact, logits atol 1e-4; every trainable tensor's gradient
    within 1e-4 of its largest entry (plus 1e-7); a frozen one gets none.
    Returns the names checked."""
    micro = {k: v[:2] for k, v in batch.items()}
    (_, want), want_g = jax.jit(jax.value_and_grad(
        jax_loss(jmodel, args, micro), has_aux=True))(params)
    out = model(micro)
    np.testing.assert_array_equal(out["labels"].numpy(),
                                  np.asarray(want["labels"]))
    _close(out["logits"].detach(), want["logits"], 1e-4, "logits")
    loss, _ = losses_of(out, args.decoder_only, args.max_input_length, PAD)
    loss.backward()
    got = dict(model.named_parameters())
    off = model.gradless_prefixes
    checked = []
    for path, g in convert._leaves(want_g):
        name, flip = convert._torch_name(path)
        p = got[name]
        if not p.requires_grad:
            assert p.grad is None, name
            continue
        if p.grad is None:
            assert name.startswith(off) and not np.any(g), name
            continue
        grad = p.grad.numpy()
        _close(grad.T if flip else grad, g, 1e-4 * np.abs(g).max() + 1e-7,
               name)
        checked.append(name)
    return checked


@pytest.mark.parametrize("peft_type", ["none", "lora", "prefix", "prompt",
                                       "flamingo"])
def test_peft_trainable_set_matches_jax(peft_type):
    """requires_grad and the trainable/total counts equal the JAX package's
    trainable_mask / count_params for OPT (family 3's text_only layout) and
    T5 (section_all), with and without --freeze_lm: under lora only the
    adapters train in the LM (OPT ties its head, so no name holds lm_head),
    under prefix, prompt and flamingo none of the LM does; the virtual
    tokens and the fusion-side modules always train, the towers never."""
    for model_name, context in (("opt-tiny", "text_only"),
                                ("t5-tiny", "section_all")):
        args = _args(model_name, context, "none", "--peft_type", peft_type,
                     "--lora_r", "4")
        got = check_trainable_set(args, _batches(args, 1)[0], peft_type)
        lm = {n: v for n, v in got.items() if n.startswith("lm.")}
        adapters = {n for n in lm if "lora_" in n}
        assert {n for n, v in lm.items() if v} == (
            adapters if peft_type == "lora" else set())
        assert all(v for n, v in got.items() if n.startswith(
            ("text_embeddings.", "prefix_tuning.", "prompt_tuning.")))
        names = set(got)
        assert (peft_type == "lora" and model_name == "opt-tiny") == any(
            "lora_a" in n for n in names)
        assert ("prefix_tuning.kv" in names) == (peft_type == "prefix")
        assert ("prompt_tuning.weight" in names) == (peft_type == "prompt")


@pytest.mark.parametrize("name", list(CASES))
def test_peft_forward_and_grads_match_jax(name):
    """The fused forward of each PEFT form with the JAX package's weights
    (LoRA's B non-zero): adjusted labels exact (prompt tuning: -100 over
    OPT's virtual tokens; T5's labels untouched), logits atol 1e-4; every
    trainable tensor's gradient atol 1e-4 of its largest entry plus 1e-7
    (fp32 sums over a few hundred terms in another order), lora_a, lora_b
    and the virtual-token tables among them."""
    args, batch, jmodel, params = jax_pair(name)
    model = port_model(args, params)
    checked = check_forward_and_grads(args, batch, jmodel, params, model)
    want = {"opt-lora": "lm.decoder.layers.0.self_attn.v_proj.lora_a",
            "opt-prefix": "prefix_tuning.kv",
            "opt-prompt": "prompt_tuning.weight",
            "t5-prefix": "prefix_tuning.kv",
            "t5-prompt": "prompt_tuning.weight"}[name]
    assert want in checked
    assert len(checked) == sum(
        p.requires_grad and not n.startswith(model.gradless_prefixes)
        for n, p in model.named_parameters())
