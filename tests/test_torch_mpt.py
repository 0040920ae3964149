"""The port's MPT (OPT with gated cross layers over the neighbour memory)
against the JAX package, on the CPU.

BASELINE family 4 (MPT + flamingo, context all) at mpt-tiny, fp32, dropout
off, and MPT without PEFT in text_only: the neighbour block of Roberta and
CLIP soft tokens goes to the decoder as cross-attention memory, not into
its input. The flamingo gates start at zero, so they are set to seeded
non-zero values on both sides before a comparison (else the cross layers
would have nothing to compare). The helpers are
tests/test_torch_peft.py's and tests/test_torch_embedding.py's. Each test
states its tolerance.
"""

from functools import partial

import jax
import numpy as np
import pytest
import torch

from mmgl_tpu.train.generate import greedy_generate as jax_generate
from mmgl_tpu_torch import cli
from mmgl_tpu_torch.models.factory import build_fusion_config, build_model
from mmgl_tpu_torch.ops import attention as att
from mmgl_tpu_torch.train.generate import greedy_generate
from mmgl_tpu_torch.train.optim import build_optimizer
from mmgl_tpu_torch.train.steps import losses_of, make_train_step
from mmgl_tpu_torch.utils.tokenizer import get_tokenizer
from test_torch_embedding import PAD, _args, _batches
from test_torch_peft import (check_forward_and_grads, check_trainable_set,
                             jax_pair, port_model)
from test_torch_peft_train import check_updates

MPT_CASES = {
    "mpt-flamingo": ("mpt-tiny", "all", "none", ("--peft_type", "flamingo")),
    "mpt-text": ("mpt-tiny", "text_only", "none", ()),
    # the JAX package creates MPT's prefix table and never hands it to the
    # decoder: trainable, with a zero gradient
    "mpt-prefix": ("mpt-tiny", "all", "none", ("--peft_type", "prefix")),
}


def _model(args):
    """The port's seeded model from build_model, on the CPU."""
    tok = get_tokenizer(args.tokenizer_path)
    return build_model(args, torch.device("cpu"), vocab_size=tok.vocab_size,
                       tokenizer=tok)[0]


@pytest.mark.parametrize("context,neighbor_mode,peft_type,cross", [
    ("all", "embedding", "flamingo", True),
    ("text_only", "embedding", "none", True),
    ("all", "embedding", "lora", True),
    ("all", "embedding", "prefix", True),
    ("section_only", "embedding", "flamingo", False),
    ("all", "raw", "flamingo", False),
])
def test_mpt_trainable_set_matches_jax(context, neighbor_mode, peft_type,
                                       cross):
    """The parameters and requires_grad of mpt-tiny equal the JAX package's
    tree and trainable_mask, with and without --freeze_lm: the cross
    layers exist only where the decoder gets a memory (the embedding mode
    past section_only; the JAX package creates them at their first call),
    always train, and hold the gates only under flamingo; flamingo freezes
    the rest of the LM."""
    args = _args("mpt-tiny", context, "none", "--neighbor_mode",
                 neighbor_mode, "--peft_type", peft_type, "--lora_r", "4")
    if neighbor_mode == "raw":   # no neighbour slots to blank
        ds = cli.setup_data(args, get_tokenizer(args.tokenizer_path))[0]
        batch = next(iter(cli.PrefetchLoader(ds, batch_size=2,
                                             num_workers=1)))
    else:
        batch = _batches(args, 1)[0]
    got = check_trainable_set(args, batch, peft_type)
    layers = [n for n in got if ".neighbor_layers." in n]
    assert bool(layers) == cross
    assert all(got[n] for n in layers)
    assert any(n.endswith("gating1") for n in layers) == (
        cross and peft_type == "flamingo")
    if peft_type == "flamingo":
        assert not any(v for n, v in got.items() if n.startswith("lm.")
                       and n not in layers)


def test_mpt_interleave_rule_and_memory_shapes():
    """A cross layer runs after decoder layer idx when (idx + 1) %
    neighbor_layer_wise == 0, with neighbor_layer_wise = layers //
    --num_neighbor_layers: after both of mpt-tiny's two layers by default
    (4 asked, 2 // 4 -> 1), after the second alone with 1. Each reads the
    whole memory: (3 texts + 2 images) x 2 soft tokens."""
    for n_cross, want in ((4, [0, 1]), (1, [1])):
        args = _args("mpt-tiny", "all", "none", "--peft_type", "flamingo",
                     "--num_neighbor_layers", str(n_cross))
        cfg = build_fusion_config(args)
        assert cfg.opt.cross_attention and cfg.has_memory
        model = _model(args)
        order = []
        for i, layer in enumerate(model.lm.decoder.layers):
            layer.register_forward_hook(
                lambda m, a, o, i=i: order.append(("layer", i)))
        for i, layer in enumerate(model.lm.decoder.neighbor_layers):
            layer.register_forward_hook(
                lambda m, a, kw, o, i=i: order.append(
                    ("cross", i, tuple(kw["neighbor_embeds"].shape))),
                with_kwargs=True)
        batch = _batches(args, 1)[0]
        model({k: v[:2] for k, v in batch.items()})
        crosses = [e for e in order if e[0] == "cross"]
        assert [order[order.index(c) - 1][1] for c in crosses] == want
        assert all(c[2] == (2, 10, 64) for c in crosses)


@pytest.mark.parametrize("name", list(MPT_CASES))
def test_mpt_forward_and_grads_match_jax(name):
    """MPT's forward with the JAX package's weights and non-zero gates:
    labels exact, logits atol 1e-4; every trainable tensor's gradient
    (the cross layers and gates among them) atol 1e-4 of its largest entry
    plus 1e-7; under prefix tuning the prefix table, which the decoder
    never sees, gets none (the train step gives it jax.grad's zero)."""
    args, batch, jmodel, params = jax_pair(name, MPT_CASES)
    model = port_model(args, params)
    checked = check_forward_and_grads(args, batch, jmodel, params, model)
    assert "lm.decoder.neighbor_layers.0.self_attn.k_proj.weight" in checked
    if name == "mpt-flamingo":
        assert "lm.decoder.neighbor_layers.1.gating2" in checked
    if name == "mpt-prefix":
        assert model.gradless_prefixes == ("text_pooler.", "prefix_tuning.")
        assert "prefix_tuning.kv" not in checked
        assert model.prefix_tuning.kv.grad is None


def test_zero_gates_and_zero_lora_b_give_zero_gradients():
    """At init (gates 0, LoRA's B 0), MPT's cross layers and LoRA's A get
    gradients of exactly zero, not none, as jax.grad gives them: the train
    step takes them without its missing-gradient raise."""
    for flags in (("--peft_type", "flamingo"), ("--peft_type", "lora",
                                                "--lora_r", "4")):
        args = _args("mpt-tiny", "all", "none", *flags)
        model = _model(args)
        batch = _batches(args, 1)[0]
        out = model({k: v[:2] for k, v in batch.items()})
        losses_of(out, True, args.max_input_length, PAD)[0].backward()
        zero = [n for n, p in model.named_parameters() if p.requires_grad
                and ("neighbor_layers" in n or "lora_a" in n)
                and not n.endswith(("gating1", "gating2"))]
        assert zero
        named = dict(model.named_parameters())
        for n in zero:
            want_zero = "lora_a" in n or flags[1] == "flamingo"
            assert named[n].grad is not None, n
            assert (not named[n].grad.any()) == want_zero, n
        model.zero_grad(set_to_none=True)
        opt, sched = build_optimizer(args, model)
        step = make_train_step(model, opt, sched, True,
                               args.max_input_length, PAD, 1)
        assert torch.isfinite(step({k: v[:2] for k, v in batch.items()})[
            "grad_norm"])


def test_mpt_two_updates_match_jax():
    """Two AdamW updates of family 4 (flamingo, non-zero gates): loss rtol
    1e-5, every trainable parameter atol 1e-5, the LM and the towers
    bit-identical; the cross layers' k_proj biases (a zero true gradient:
    softmax ignores a constant added to a query's logits) within the sum of
    the learning rates."""
    check_updates("mpt-flamingo", MPT_CASES, skip=("k_proj.bias",))


def test_mpt_greedy_tokens_match_jax():
    """Greedy decode of a test batch with the memory in the prefill and in
    every step, token for token against the JAX package."""
    args, _, jmodel, params = jax_pair("mpt-flamingo", MPT_CASES)
    batch = _batches(args, 1, split=2)[0]
    model = port_model(args, params)
    want = jax.jit(partial(jax_generate, jmodel, max_new_tokens=8))(
        {"params": params}, batch)
    got = greedy_generate(model, batch, max_new_tokens=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mpt_cross_attention_takes_k4():
    """MPT-1.3B's cross-attention, 640 queries against the 64-token memory
    (16 neighbours x 4 soft tokens), and its 512-query prefill take K4 (sq
    != sk); a decode step's one query the plain route."""
    mem = (4, 64, 32, 64)
    assert att.attention_route((4, 640, 32, 64), mem) == "flash"
    assert att.attention_route((4, 512, 32, 64), mem) == "flash"
    assert att.attention_route((4, 1, 32, 64), mem) == "reference"


@pytest.mark.parametrize("family", [
    ("--model_name_or_path", "opt-tiny", "--context", "text_only",
     "--peft_type", "lora", "--lora_r", "4"),
    ("--model_name_or_path", "mpt-tiny", "--context", "all",
     "--peft_type", "flamingo"),
    ("--model_name_or_path", "opt-tiny", "--context", "all",
     "--position_type", "laplacian", "--peft_type", "prefix"),
    ("--model_name_or_path", "opt-tiny", "--context", "all",
     "--position_type", "gnn", "--peft_type", "prompt"),
], ids=["3-lora", "4-mpt-flamingo", "5-prefix", "6-prompt"])
def test_cli_baseline_families_train_and_test(family, tmp_path):
    """BASELINE families 3-6 (5 without its mesh) through the entry point at
    a tiny size: training (the epoch-0 val pass, two updates, val, the best
    checkpoint, the test pass on it) with finite metrics."""
    from test_torch_embedding import TINY

    got = cli.main([*family, *TINY, "--epochs", "1", "--log_dir",
                    str(tmp_path)])
    assert got["train_updates"] == 2.0
    assert all(np.isfinite(v) for v in got.values())
