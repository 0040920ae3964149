"""The port's embedding neighbor mode against the JAX package, on the CPU.

The paper's method (BASELINE configs 2-7): neighbor texts through the frozen
Roberta tower and its pooler, neighbor images through the frozen CLIP
tower, each projected to soft tokens, interleaved by page location, given
graph position encodings (Laplacian or GCN) in context all, and appended to
the LM's input. Tiny configs in fp32, dropout off; the JAX package
initializes the weights, which reach the port through
mmgl_tpu_torch.utils.convert, and runs with ``use_pallas=False`` (as
tests/test_baseline_configs.py does); the port takes its kernel routes,
whose plain versions run here. Batches come from the port's loader (its
data layer gives the JAX package's batches, tests/test_torch_data.py), one
neighbor slot of the first sample fully masked (an all-zero attention mask,
which the byte tokenizer never gives an empty text but another tokenizer
may). Each test states its tolerance.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmgl_tpu.models import factory as jfactory
from mmgl_tpu.models.fusion import MMGLModel as JaxMMGLModel
from mmgl_tpu.models.graph import GCN as JaxGCN
from mmgl_tpu.train.losses import causal_losses as jax_causal_losses
from mmgl_tpu.train.losses import seq2seq_loss as jax_seq2seq_loss
from mmgl_tpu.utils.tokenizer import ByteTokenizer
from mmgl_tpu_torch import cli
from mmgl_tpu_torch.models.factory import build_model
from mmgl_tpu_torch.models.graph import GCN
from mmgl_tpu_torch.train.steps import losses_of
from mmgl_tpu_torch.utils import convert

PAD = ByteTokenizer().pad_token_id
# 32-token prompts and neighbor texts, a 16-token summary, 3 text and 2
# image neighbors of 2 soft tokens each: a 10-token neighbor block
TINY = ["--task", "section", "--neighbor_mode", "embedding",
        "--max_input_length", "32", "--max_output_length", "16",
        "--max_text_neighbors", "3", "--max_image_neighbors", "2",
        "--n_text_tokens", "2", "--n_visual_tokens", "2",
        "--per_device_train_batch_size", "2", "--grad_accumulation_steps",
        "2", "--per_device_val_batch_size", "2", "--val_steps_per_epoch", "1",
        "--steps_per_epoch", "4", "--print_freq", "1",
        "--dataloader_num_workers", "1", "--seed", "0", "--device", "cpu"]

# (context, position_type): every context, and every position encoding
# where it applies (the graph ones in context all)
FUSION_CASES = [("section_only", "none"), ("text_only", "embedding"),
                ("section_all", "none"), ("section_all", "embedding"),
                ("all", "none"), ("all", "embedding"), ("all", "laplacian"),
                ("all", "gnn")]


def _args(model, context="section_all", position_type="none", *extra):
    args, _ = cli.parse_cli(["--model_name_or_path", model, "--context",
                             context, "--position_type", position_type,
                             *TINY, *extra])
    args.decoder_only = "t5" not in model
    return args


def _batches(args, n, split=0, batch_size=4):
    """n batches of the split, the first sample's last neighbor text made a
    padded slot (position 0) with an all-zero mask."""
    ds = cli.setup_data(args, ByteTokenizer())[split]
    loader = cli.PrefetchLoader(ds, num_workers=1, batch_size=batch_size)
    batches = list(loader)[:n]
    assert len(batches) == n
    for batch in batches:
        batch["neighbor_pos_ids"][0, -1] = 0
        batch["neighbor_attention_mask"][0, -1] = 0
    return batches


def _pair(args, batch):
    """(JAX model, its params, the port's model on the same weights); the
    JAX model with use_pallas=False, the port on its kernel routes."""
    tok = ByteTokenizer()
    jargs = copy.copy(args)
    jargs.use_pallas = False
    jmodel, _ = jfactory.build_model(jargs, vocab_size=tok.vocab_size,
                                     tokenizer=tok)
    micro = {k: v[:2] for k, v in batch.items()}
    params = jax.device_get(
        jax.jit(jmodel.init)(jax.random.PRNGKey(0), micro)["params"])
    model, _ = build_model(args, torch.device("cpu"),
                           vocab_size=tok.vocab_size, tokenizer=tok)
    model.load_state_dict(convert.state_dict_from_jax(params))
    return jmodel, params, model


def _jax_loss(jmodel, args, batch):
    def loss(params):
        out = jmodel.apply({"params": params}, batch)
        if args.decoder_only:
            return jax_causal_losses(out["logits"], out["labels"],
                                     args.max_input_length, PAD)[0]
        return jax_seq2seq_loss(out["logits"], out["labels"])
    return loss


def _close(got, want, atol, name=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def t5_pair():
    args = _args("t5-tiny")
    batch = _batches(args, 1, split=2)[0]
    return (args, batch) + _pair(args, batch)


def test_roberta_and_pooled_text_match_jax(t5_pair):
    """The Roberta tower's last hidden states (atol 1e-5, LayerNorm'd
    values of order 1) and the pooled, projected text features (atol
    1e-5) for every neighbor slot, the fully masked one included (its
    attention averages V over the keys, as xla_attention does)."""
    args, batch, jmodel, params, model = t5_pair
    ids = batch["neighbor_input_ids"].reshape(-1, args.max_input_length)
    mask = batch["neighbor_attention_mask"].reshape(ids.shape)
    assert (mask.sum(-1) == 0).sum() == 1
    want_h = jmodel.apply({"params": params}, ids, mask,
                          method=lambda m, i, a: m.text_model(i, a))
    want_p = jmodel.apply({"params": params}, ids, mask,
                          method=JaxMMGLModel.pool_text)
    want_e = jmodel.apply({"params": params}, batch["neighbor_input_ids"],
                          batch["neighbor_attention_mask"],
                          batch["neighbor_pos_ids"],
                          method=JaxMMGLModel.get_text_embs)
    ti, tm = torch.from_numpy(ids), torch.from_numpy(mask)
    with torch.no_grad():
        got_h = model.text_model(ti.long(), tm)
    got_p = model.pool_text(ti, tm)
    got_e = model.get_text_embs(*(torch.from_numpy(batch[k]) for k in (
        "neighbor_input_ids", "neighbor_attention_mask", "neighbor_pos_ids")))
    assert got_h.shape == want_h.shape and got_e.shape == want_e.shape
    _close(got_h, want_h, 1e-5, "hidden")
    _close(got_p, want_p, 1e-5, "pooled")
    _close(got_e.detach(), want_e, 1e-5, "text soft tokens")


@pytest.mark.parametrize("seed", [0, 1])
def test_gcn_matches_jax(seed):
    """The GCN over a normalized page graph with a null root: output (atol
    1e-5) and the gradients of w1 and w2 (atol 1e-5 of the largest)."""
    rng = np.random.RandomState(seed)
    b, n, d, hidden, out_dim = 2, 5, 12, 8, 12
    x = rng.randn(b, n, d).astype(np.float32)
    adj = rng.uniform(size=(b, n + 1, n + 1)).astype(np.float32)
    adj = (adj + adj.transpose(0, 2, 1)) / 2
    jgcn = JaxGCN(output_dim=out_dim, hidden_dim=hidden)
    params = jax.device_get(jgcn.init(jax.random.PRNGKey(seed), x, adj))
    gcn = GCN(d, out_dim, hidden)
    sd = convert.state_dict_from_jax({"gnn": params["params"]})
    gcn.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    want = jgcn.apply(params, x, adj)
    want_g = jax.grad(lambda p: jnp.sum(jgcn.apply(p, x, adj) ** 2))(params)
    got = gcn(torch.from_numpy(x), torch.from_numpy(adj))
    (got ** 2).sum().backward()
    assert got.shape == (b, n, out_dim)
    _close(got.detach(), want, 1e-5)
    for w in ("w1", "w2"):
        g = np.asarray(want_g["params"][w]["kernel"])
        _close(getattr(gcn, w).weight.grad.T, g, 1e-5 * np.abs(g).max(), w)


@pytest.mark.parametrize("context,position_type", FUSION_CASES)
@pytest.mark.parametrize("model_name", ["t5-tiny", "opt-tiny"])
def test_embedding_forward_and_grads_match_jax(model_name, context,
                                               position_type):
    """The fused forward: adjusted labels exact, logits atol 1e-4; then the
    loss's gradient of every trainable tensor, atol 1e-4 of the tensor's
    largest entry plus 1e-7 (fp32 sums over a few hundred terms in another
    order), the text pooler's exactly 0 (behind the tower's stop)."""
    args = _args(model_name, context, position_type)
    batch = _batches(args, 1)[0]
    micro = {k: v[:2] for k, v in batch.items()}
    jmodel, params, model = _pair(args, batch)
    names = {k for k in model.state_dict()}
    assert ("lpe_embeddings.weight" in names) == (
        context == "all" and position_type == "laplacian")
    assert ("gnn.w1.weight" in names) == (context == "all"
                                          and position_type == "gnn")
    assert ("text_position_embeddings.weight" in names) == (
        position_type != "none")

    want = jax.jit(jmodel.apply)({"params": params}, micro)
    want_g = jax.jit(jax.grad(_jax_loss(jmodel, args, micro)))(params)
    out = model(micro)
    np.testing.assert_array_equal(out["labels"].numpy(),
                                  np.asarray(want["labels"]))
    _close(out["logits"].detach(), want["logits"], 1e-4, "logits")
    loss, _ = losses_of(out, args.decoder_only, args.max_input_length, PAD)
    loss.backward()
    got = dict(model.named_parameters())
    checked = 0
    for path, g in convert._leaves(want_g):
        name, flip = convert._torch_name(path)
        p = got[name]
        if not p.requires_grad:
            continue
        grad = (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
        if name.startswith("text_pooler."):
            assert p.grad is None and not np.any(g), name
        _close(grad.T if flip else grad, g, 1e-4 * np.abs(g).max() + 1e-7,
               name)
        checked += 1
    assert checked == sum(p.requires_grad for p in got.values())
