"""The port's layerdrop and remat against the JAX package, on the CPU.

Layerdrop (``--layerdrop p``) bypasses each decoder layer, and the cross
layer that follows it, with probability p in training only
(mmgl_tpu/models/opt.py:335-363); remat (``--remat true``) recomputes
every decoder and cross layer in the backward (:294-302). opt-tiny (family
3's LoRA layout) and mpt-tiny (family 4's flamingo) in fp32; the helpers
are tests/test_torch_peft.py's and tests/test_torch_embedding.py's. The
keep decisions are draws of the port's own generator, which cannot
reproduce JAX's bits (as dropout cannot), so the JAX package is matched
where the draw is certain (p = 1) and the draw itself is held to its
rate. Each test states its tolerance.
"""

import math

import jax
import numpy as np
import pytest
import torch

from mmgl_tpu.train.losses import causal_losses as jax_causal_losses
from mmgl_tpu_torch import cli
from mmgl_tpu_torch.models.layers import Dropout
from mmgl_tpu_torch.models import opt as opt_module
from mmgl_tpu_torch.models.opt import OPTConfig, OPTDecoder
from mmgl_tpu_torch.train.generate import greedy_generate
from mmgl_tpu_torch.train.steps import losses_of
from mmgl_tpu_torch.utils import convert
from test_torch_embedding import PAD, _args, _batches, _close
from test_torch_peft import check_forward_and_grads, jax_pair, port_model

LORA = ("--peft_type", "lora", "--lora_r", "4", "--lora_alpha", "2")
FLAMINGO = ("--peft_type", "flamingo")
CASES = {
    "opt-lora-drop1": ("opt-tiny", "text_only", "none",
                       LORA + ("--layerdrop", "1.0")),
    "mpt-flamingo-drop1": ("mpt-tiny", "all", "none",
                           FLAMINGO + ("--layerdrop", "1.0")),
    "opt-lora-remat": ("opt-tiny", "text_only", "none",
                       LORA + ("--remat", "true")),
    "opt-lora-frozen-remat": ("opt-tiny", "text_only", "none",
                              LORA + ("--freeze_lm", "true", "--remat",
                                      "true")),
    "mpt-flamingo-remat": ("mpt-tiny", "all", "none",
                           FLAMINGO + ("--remat", "true")),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny shapes: more only contend with
    the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _micro(batch):
    return {k: v[:2] for k, v in batch.items()}


@pytest.mark.parametrize("name", ["opt-lora-drop1", "mpt-flamingo-drop1"])
def test_layerdrop_one_matches_jax(name):
    """p = 1 in training: every decoder layer and every cross layer is
    bypassed, in both packages. The training-mode loss rtol 1e-5 against
    the JAX model's (``deterministic=False``), every trainable gradient
    atol 1e-4 of its largest entry plus 1e-7; the layers' and cross layers'
    tensors get gradients of exactly 0."""
    args, batch, jmodel, params = jax_pair(name, CASES)
    micro = _micro(batch)

    def jloss(p):
        out = jmodel.apply({"params": p}, micro, deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(3)})
        return jax_causal_losses(out["logits"], out["labels"],
                                 args.max_input_length, PAD)[0]

    want, want_g = jax.jit(jax.value_and_grad(jloss))(params)
    model = port_model(args, params).train()
    loss, _ = losses_of(model(micro, generator=torch.Generator()), True,
                        args.max_input_length, PAD)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    got = dict(model.named_parameters())
    layers = 0
    for path, g in convert._leaves(want_g):
        pname, flip = convert._torch_name(path)
        p = got[pname]
        if not p.requires_grad or p.grad is None:
            continue
        grad = p.grad.numpy()
        _close(grad.T if flip else grad, g, 1e-4 * np.abs(g).max() + 1e-7,
               pname)
        if ".layers." in pname or "neighbor_layers." in pname:
            assert not p.grad.any(), pname
            layers += 1
    assert layers > 0


def test_layerdrop_zero_equals_no_flag():
    """p = 0 in training: the logits equal, bit for bit, the model built
    without the flag, and no keep decision is drawn (the generator is left
    where it was)."""
    base = _args("opt-tiny", "text_only", "none", *LORA)
    flagged = _args("opt-tiny", "text_only", "none", *LORA, "--layerdrop",
                    "0")
    batch = _micro(_batches(base, 1)[0])
    out = []
    for args in (base, flagged):
        tok = cli.get_tokenizer(args.tokenizer_path)
        model, _ = cli.build_model(args, torch.device("cpu"),
                                   vocab_size=tok.vocab_size, tokenizer=tok)
        g = torch.Generator().manual_seed(5)
        state = g.get_state()
        out.append(model.train()(batch, generator=g)["logits"].detach())
        assert torch.equal(g.get_state(), state)
    assert torch.equal(out[0], out[1])


def test_layerdrop_is_ignored_in_eval_and_decode():
    """In eval mode, p = 0.5 gives the logits of p = 0 bit for bit, and the
    same greedy tokens: the teacher-forced eval, the prefill and decode
    ignore the flag."""
    batch = _batches(_args("mpt-tiny", "all", "none", *FLAMINGO), 1,
                     split=2)[0]
    logits, tokens = [], []
    for p in ("0", "0.5"):
        args = _args("mpt-tiny", "all", "none", *FLAMINGO, "--layerdrop", p)
        tok = cli.get_tokenizer(args.tokenizer_path)
        model, _ = cli.build_model(args, torch.device("cpu"),
                                   vocab_size=tok.vocab_size, tokenizer=tok)
        with torch.no_grad():
            logits.append(model.eval()(_micro(batch))["logits"])
        tokens.append(greedy_generate(model, batch, max_new_tokens=4))
    assert torch.equal(logits[0], logits[1])
    assert torch.equal(tokens[0], tokens[1])


def test_cli_test_pass_with_layerdrop_equals_the_run_without():
    """ROADMAP C5: the --test pass with --layerdrop 0.1 runs, as the JAX
    package's does, and returns the metrics of the run at 0."""
    flags = ["--model_name_or_path", "opt-tiny", "--task", "section",
             "--context", "section_only", "--neighbor_mode", "raw",
             "--test", "true", "--max_input_length", "32",
             "--max_output_length", "16", "--per_device_val_batch_size", "2",
             "--val_steps_per_epoch", "1", "--dataloader_num_workers", "1",
             "--seed", "0", "--device", "cpu"]
    got = cli.main(flags + ["--layerdrop", "0.1"])
    assert got == cli.main(flags)


def test_layerdrop_keep_fraction_and_zero_gradients(monkeypatch):
    """p = 0.5: over one training forward of a 400-layer decoder whose
    layers are stubbed to add 1 (so the final norm's input is the first
    layer's plus the number of layers kept) the fraction kept is within 4
    sigma of 1 - p. Then a 4-layer OPT decoder (8 wide), one training forward with
    a gradient: the tensors of a bypassed layer (read off the hidden
    states: a kept layer's output is the next layer's input, a bypassed
    one's input is) get gradients of exactly 0, those of a kept one not."""
    p = 0.5

    def decoder(n):
        return OPTDecoder(OPTConfig(
            vocab_size=16, hidden_size=8, num_hidden_layers=n,
            num_attention_heads=1, ffn_dim=16, dropout=0.0, layerdrop=p,
            use_pallas=False)).train()

    x = torch.randn(1, 4, 8, generator=torch.Generator().manual_seed(2))
    seen = []

    def add_one(layer, remat, h, *a, **kw):
        seen.append(h)
        return h + 1.0

    big = decoder(400)
    big.final_layer_norm.register_forward_hook(
        lambda m, a, o: seen.append(a[0]))
    with monkeypatch.context() as mp, torch.no_grad():
        mp.setattr(opt_module, "_run_layer", add_one)
        big(inputs_embeds=x, generator=torch.Generator().manual_seed(11))
    # the final norm's input less the first layer's
    counts = (seen[-1] - seen[0]).round()
    assert bool((counts == counts.flatten()[0]).all())
    frac = float(counts.flatten()[0]) / 400
    sigma = math.sqrt(p * (1 - p) / 400)
    assert abs(frac - (1 - p)) <= 4 * sigma, (frac, sigma)

    small, seen = decoder(4), []
    for m in (*small.layers, small.final_layer_norm):
        m.register_forward_hook(lambda m, a, o: seen.append((a[0], o)))
    out = small(inputs_embeds=x, generator=torch.Generator().manual_seed(5))
    # a weighted sum: the plain sum of the final norm's output is constant
    (out * torch.randn(out.shape, generator=torch.Generator().manual_seed(6))
     ).sum().backward()
    kept = []
    for (x_in, y), (nxt, _) in zip(seen[:-1], seen[1:]):
        assert torch.equal(nxt, y) != torch.equal(nxt, x_in)
        kept.append(torch.equal(nxt, y))
    assert any(kept) and not all(kept), kept   # both kinds in this draw
    for layer, k in zip(small.layers, kept):
        grads = [q.grad for q in layer.parameters()]
        assert all(gr is not None for gr in grads)
        assert any(gr.any() for gr in grads) == k


def _dropout_on(model, rate=0.1):
    """Every dropout of the model (hidden and LoRA's) at ``rate``: the tiny
    configuration has none."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = rate
    return model


def test_remat_replays_the_dropout_masks():
    """Remat with the hidden and LoRA dropouts on (0.1): one training
    micro-step's loss and every gradient equal the step without remat bit
    for bit, and the dropout stream ends where it does without remat (the
    recompute replays the forward's masks from a fork; it neither draws new
    ones nor rewinds the step's stream). The LoRA adapters get their
    gradients under --freeze_lm."""
    flags = LORA + ("--lora_dropout", "0.1", "--freeze_lm", "true")
    runs = []
    for remat in ("false", "true"):
        args = _args("opt-tiny", "text_only", "none", *flags, "--remat",
                     remat)
        tok = cli.get_tokenizer(args.tokenizer_path)
        model, _ = cli.build_model(args, torch.device("cpu"),
                                   vocab_size=tok.vocab_size, tokenizer=tok)
        assert model.lm.decoder.cfg.remat == (remat == "true")
        with torch.no_grad():
            for name, q in model.named_parameters():
                if "lora_b" in name:
                    q.copy_(torch.randn(q.shape,
                                        generator=torch.Generator()
                                        .manual_seed(3)))
        _dropout_on(model)
        g = torch.Generator().manual_seed(9)
        batch = _micro(_batches(args, 1)[0])
        loss, _ = losses_of(model.train()(batch, generator=g), True,
                            args.max_input_length, PAD)
        loss.backward()
        # the text pooler sits behind the tower's stop_gradient: no grad
        grads = {n: q.grad.clone() for n, q in model.named_parameters()
                 if q.grad is not None}
        runs.append((loss.detach(), grads, g.get_state()))
    (l0, g0, s0), (l1, g1, s1) = runs
    assert torch.equal(l0, l1)
    assert torch.equal(s0, s1)
    assert any("lora_a" in n for n in g1) and g0.keys() == g1.keys()
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
        if "lora_" in name:
            assert g1[name].any(), name


@pytest.mark.parametrize("name", ["opt-lora-remat", "opt-lora-frozen-remat",
                                  "mpt-flamingo-remat"])
def test_remat_forward_and_grads_match_jax(name):
    """Remat in both packages (``nn.remat`` over the JAX layers), dropout
    off: labels exact, logits atol 1e-4, every trainable gradient atol 1e-4
    of its largest entry plus 1e-7 (check_forward_and_grads), LoRA's A and
    B among them under --freeze_lm, MPT's cross layers and gates under
    flamingo."""
    args, batch, jmodel, params = jax_pair(name, CASES)
    model = port_model(args, params)
    assert model.lm.decoder.cfg.remat
    checked = check_forward_and_grads(args, batch, jmodel, params, model)
    want = ("lm.decoder.neighbor_layers.1.gating2" if "mpt" in name
            else "lm.decoder.layers.1.self_attn.q_proj.lora_b")
    assert want in checked
