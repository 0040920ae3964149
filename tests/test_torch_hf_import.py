"""Pretrained HF checkpoints in the port (mmgl_tpu_torch/utils/hf_import.py
and ``models/factory.maybe_import_pretrained``) against the JAX package's
importer (mmgl_tpu/utils/hf_import.py, mmgl_tpu/models/factory.py:184-217),
on the CPU.

Tiny random-init ``transformers`` models are built here (no download) and
saved with ``save_pretrained`` in both formats (``model.safetensors`` and,
with ``safe_serialization=False``, ``pytorch_model.bin``); the reference's
MPT, which ``transformers`` does not hold, is an OPT state dict with
cross layers and flamingo gates added, saved by ``safetensors.torch`` and
``torch.save``. Each directory is read by both packages' readers and
importers: the flax-layout trees must be equal leaf for leaf, bit for bit,
and the port's model, built on them, must compute what the JAX module and
the HF module compute, in fp32, within the tolerance each test states.
Through ``build_model`` the port's parameters must equal
``state_dict_from_jax`` of the JAX package's overlay on the same seeded
weights. The checkpoint directories are named as a user names them
(``opt-tiny``) relative to a working directory of their own, since the
factory selects the model by substrings of the name.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from mmgl_tpu.models import factory as jfactory
from mmgl_tpu.models.clip import CLIPTextConfig as JCLIPTextConfig
from mmgl_tpu.models.clip import CLIPTextModel as JCLIPTextModel
from mmgl_tpu.models.clip import CLIPVisionConfig as JCLIPVisionConfig
from mmgl_tpu.models.clip import CLIPVisionModel as JCLIPVisionModel
from mmgl_tpu.models.opt import OPTConfig as JOPTConfig
from mmgl_tpu.models.opt import OPTForCausalLM as JOPTForCausalLM
from mmgl_tpu.models.roberta import RobertaConfig as JRobertaConfig
from mmgl_tpu.models.roberta import RobertaModel as JRobertaModel
from mmgl_tpu.models.t5 import T5Config as JT5Config
from mmgl_tpu.models.t5 import T5ForConditionalGeneration as JT5
from mmgl_tpu.utils import hf_import as jhf
from mmgl_tpu.utils.tokenizer import ByteTokenizer
from mmgl_tpu_torch import cli
from mmgl_tpu_torch.data.neighbor_cache import CachedNeighborDataset
from mmgl_tpu_torch.models.clip import (CLIPTextConfig, CLIPTextModel,
                                        CLIPVisionConfig, CLIPVisionModel)
from mmgl_tpu_torch.models.factory import build_model
from mmgl_tpu_torch.models.opt import OPTConfig, OPTForCausalLM
from mmgl_tpu_torch.models.roberta import RobertaConfig, RobertaModel
from mmgl_tpu_torch.models.t5 import T5Config, T5ForConditionalGeneration
from mmgl_tpu_torch.utils import convert
from mmgl_tpu_torch.utils import hf_import as hf
from test_torch_embedding import TINY

VOCAB = ByteTokenizer().vocab_size
FORMATS = ("safetensors", "bin")
# fp32 forwards of two-layer models, the same math in another order
ATOL = 2e-4


def _hf_opt(seed, hidden=64, layers=2, heads=2, proj=None, pre_ln=True,
            positions=2048):
    import transformers

    torch.manual_seed(seed)
    return transformers.OPTForCausalLM(transformers.OPTConfig(
        vocab_size=VOCAB, hidden_size=hidden, num_hidden_layers=layers,
        num_attention_heads=heads, ffn_dim=2 * hidden,
        max_position_embeddings=positions, word_embed_proj_dim=proj or hidden,
        do_layer_norm_before=pre_ln, dropout=0.0, attention_dropout=0.0,
        pad_token_id=0, attn_implementation="eager")).eval()


def _hf_t5(seed):
    import transformers

    torch.manual_seed(seed)
    return transformers.T5ForConditionalGeneration(transformers.T5Config(
        vocab_size=VOCAB, d_model=64, d_kv=16, d_ff=128, num_layers=2,
        num_decoder_layers=2, num_heads=4, dropout_rate=0.0,
        feed_forward_proj="relu", tie_word_embeddings=True,
        decoder_start_token_id=0, attn_implementation="eager")).eval()


def _hf_roberta(seed):
    import transformers

    torch.manual_seed(seed)
    return transformers.RobertaModel(transformers.RobertaConfig(
        vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=514, type_vocab_size=1, pad_token_id=1,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        layer_norm_eps=1e-5, attn_implementation="eager"),
        add_pooling_layer=False).eval()


def _clip_vision_cfg():
    import transformers

    return transformers.CLIPVisionConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, image_size=32, patch_size=8,
        attention_dropout=0.0)


def _clip_text_cfg():
    import transformers

    # the highest id is the EOT token, so HF's pooling at the first EOT and
    # the argmax-id pooling of both packages pick the same position
    return transformers.CLIPTextConfig(
        vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=77, attention_dropout=0.0,
        eos_token_id=VOCAB - 1, bos_token_id=VOCAB - 2, pad_token_id=0)


def _hf_clip_vision(seed):
    import transformers

    torch.manual_seed(seed)
    return transformers.CLIPVisionModel(_clip_vision_cfg()).eval()


def _hf_clip_text(seed):
    import transformers

    torch.manual_seed(seed)
    return transformers.CLIPTextModel(_clip_text_cfg()).eval()


def _hf_clip(seed):
    """A CLIPModel holding both towers (``vision_model.*``,
    ``text_model.*``), as openai/clip-vit-base-patch16 is saved."""
    import transformers

    torch.manual_seed(seed)
    cfg = transformers.CLIPConfig(text_config=_clip_text_cfg().to_dict(),
                                  vision_config=_clip_vision_cfg().to_dict(),
                                  projection_dim=16)
    cfg._attn_implementation = "eager"
    return transformers.CLIPModel(cfg).eval()


def _mpt_state_dict(seed):
    """The reference's MPTForCausalLM layout: an OPT state dict with one
    cross layer after each of its two layers (``neighbor_layers.i``, an
    OPT layer's tensors) and their flamingo gates."""
    sd = dict(_hf_opt(seed).state_dict())
    donor = _hf_opt(seed + 100).state_dict()
    g = torch.Generator().manual_seed(seed)
    for i in range(2):
        for key, value in donor.items():
            pre = f"model.decoder.layers.{i}."
            if key.startswith(pre):
                sd[f"model.decoder.neighbor_layers.{i}." + key[len(pre):]] = \
                    value.clone()
        for gate in ("gating1", "gating2"):
            sd[f"model.decoder.neighbor_layers.{i}.{gate}"] = torch.randn(
                (), generator=g)
    return sd


def _save(model_or_sd, path, fmt):
    """save_pretrained in ``fmt``, or a plain state dict (MPT) in the same
    file names."""
    path.mkdir(parents=True, exist_ok=True)
    if isinstance(model_or_sd, dict):
        sd = {k: v.contiguous() for k, v in model_or_sd.items()
              if k != "lm_head.weight"}
        if fmt == "safetensors":
            import safetensors.torch

            safetensors.torch.save_file(sd, str(path / "model.safetensors"))
        else:
            torch.save(sd, path / "pytorch_model.bin")
        return
    model_or_sd.save_pretrained(str(path),
                                safe_serialization=(fmt == "safetensors"))


# family -> (HF builder, importer name)
FAMILIES = {
    "opt": (lambda: _hf_opt(0), "import_opt"),
    "opt350": (lambda: _hf_opt(1, proj=32, pre_ln=False), "import_opt"),
    "mpt": (lambda: _mpt_state_dict(2), "import_mpt"),
    "t5": (lambda: _hf_t5(3), "import_t5"),
    "roberta": (lambda: _hf_roberta(4), "import_roberta"),
    "clip_vision": (lambda: _hf_clip_vision(5), "import_clip_vision"),
    "clip_text": (lambda: _hf_clip_text(6), "import_clip_text"),
}


def _trees_equal(got, want, path=()):
    assert set(got) == set(want), path
    for key in want:
        if isinstance(want[key], dict):
            _trees_equal(got[key], want[key], path + (key,))
        else:
            a, b = np.asarray(got[key]), np.asarray(want[key])
            assert a.dtype == b.dtype and a.shape == b.shape, path + (key,)
            np.testing.assert_array_equal(a, b, err_msg=str(path + (key,)))


def _both_trees(family, fmt, tmp_path):
    """(the port's tree, the JAX package's) of one saved checkpoint."""
    build, importer = FAMILIES[family]
    path = tmp_path / family
    _save(build(), path, fmt)
    port = getattr(hf, importer)(hf.load_state_dict(str(path)))
    want = getattr(jhf, importer)(jhf.load_state_dict(str(path)))
    return port, want


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_import_trees_equal_jax(family, fmt, tmp_path):
    """Each importer, on each file format, gives the JAX package's flax
    tree leaf for leaf, in the same dtype, bit for bit; and so the same
    port state dict (utils/convert.py). OPT-350M's layout carries
    project_in/out and no final LayerNorm; MPT its cross layers and
    gates."""
    port, want = _both_trees(family, fmt, tmp_path)
    _trees_equal(port, want)
    if family == "opt350":
        assert "project_in" in port["decoder"]
        assert "final_layer_norm" not in port["decoder"]
    if family == "mpt":
        assert "gating2" in port["decoder"]["neighbor_layers_1"]
    module = "lm" if family in ("opt", "opt350", "mpt", "t5") else \
        "text_model" if family in ("roberta", "clip_text") else "visual_model"
    got = convert.state_dict_from_jax({module: port})
    ref = convert.state_dict_from_jax({module: want})
    assert got.keys() == ref.keys()
    assert all(torch.equal(got[k], ref[k]) for k in ref)


def test_import_opt_into_mpt_matches_jax(tmp_path):
    """OPT's pretrained tensors overlaid on an MPT tree: the port's tree
    equals the JAX package's, the cross layers and gates keep their
    values, the OPT layers take the file's, and the MPT tree handed in is
    left as it was (a copy, as jax.tree_util's)."""
    _save(_hf_opt(30), tmp_path / "opt", "safetensors")
    mpt = hf.import_mpt({k: v.numpy() for k, v in
                         _mpt_state_dict(31).items()})
    before = copy.deepcopy(mpt)
    got = hf.import_opt_into_mpt(hf.load_state_dict(str(tmp_path / "opt")),
                                 mpt)
    want = jhf.import_opt_into_mpt(
        jhf.load_state_dict(str(tmp_path / "opt")), copy.deepcopy(mpt))
    _trees_equal(got, want)
    _trees_equal(mpt, before)
    dec = got["decoder"]
    assert dec["neighbor_layers_1"]["gating1"] is mpt["decoder"][
        "neighbor_layers_1"]["gating1"]
    assert not np.array_equal(dec["layers_0"]["fc1"]["kernel"],
                              mpt["decoder"]["layers_0"]["fc1"]["kernel"])



def test_torch_state_dict_to_numpy_copies_like_jax():
    """An in-memory torch state dict (fp32 and bf16 tensors) to fp32 numpy:
    the port's arrays equal the JAX package's, and they are copies, so an
    in-place update of the live tensor afterwards leaves them as read."""
    g = torch.Generator().manual_seed(0)
    sd = {"a": torch.randn(3, 4, generator=g),
          "b": torch.randn(5, generator=g).to(torch.bfloat16)}
    got = hf.torch_state_dict_to_numpy(sd)
    want = jhf.torch_state_dict_to_numpy(sd)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype == np.float32, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    sd["a"].add_(1.0)
    np.testing.assert_array_equal(got["a"], want["a"])

def _port_module(module, tree):
    """A standalone port module with the tree's weights."""
    sd = convert.state_dict_from_jax({"lm": tree})
    module.load_state_dict({k[len("lm."):]: v for k, v in sd.items()})
    return module.eval()


def _ids(b, s, seed, low=4, high=VOCAB - 2):
    rng = np.random.RandomState(seed)
    return rng.randint(low, high, size=(b, s)).astype(np.int64)


def _close(got, want, name):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=ATOL,
                               atol=ATOL, err_msg=name)


@pytest.mark.parametrize("pre_ln,proj", [(True, None), (False, 32)])
def test_opt_forward_matches_hf_and_jax(pre_ln, proj, tmp_path):
    """OPT-125M's layout and OPT-350M's (post-LN, project_in/out), from a
    saved checkpoint: the port's logits on left-padded ids against HF's
    and the JAX module's on the same files, atol and rtol 2e-4 at the
    valid positions."""
    hf_model = _hf_opt(7, proj=proj, pre_ln=pre_ln, positions=64)
    _save(hf_model, tmp_path / "opt", "bin")
    tree = hf.import_opt(hf.load_state_dict(str(tmp_path / "opt")))
    kw = dict(vocab_size=VOCAB, hidden_size=64, num_hidden_layers=2,
              num_attention_heads=2, ffn_dim=128, max_position_embeddings=64,
              word_embed_proj_dim=proj, do_layer_norm_before=pre_ln,
              dropout=0.0)
    model = _port_module(OPTForCausalLM(OPTConfig(**kw, pad_token_id=0)),
                         tree)
    ids = _ids(2, 12, 0)
    mask = np.ones_like(ids)
    mask[0, :3] = 0
    with torch.no_grad():
        got = model(input_ids=torch.from_numpy(ids),
                    attention_mask=torch.from_numpy(mask))[0].numpy()
        ref = hf_model(input_ids=torch.from_numpy(ids),
                       attention_mask=torch.from_numpy(mask)).logits.numpy()
    jtree = jhf.import_opt(jhf.load_state_dict(str(tmp_path / "opt")))
    jmodel = JOPTForCausalLM(JOPTConfig(**kw, attention_dropout=0.0))
    jgot = np.asarray(jmodel.apply({"params": jtree}, input_ids=ids,
                                   attention_mask=mask)[0])
    valid = mask.astype(bool)
    _close(got[valid], ref[valid], "logits vs HF")
    _close(got[valid], jgot[valid], "logits vs JAX")


def test_mpt_forward_matches_jax(tmp_path):
    """The reference's MPT layout (two flamingo cross layers, non-zero
    gates), from a saved checkpoint: the port's logits with a neighbour
    memory (sample 1 without neighbours) against the JAX module's, atol and
    rtol 2e-4. No HF module holds MPT."""
    _save(_mpt_state_dict(8), tmp_path / "mpt", "safetensors")
    tree = hf.import_mpt(hf.load_state_dict(str(tmp_path / "mpt")))
    kw = dict(vocab_size=VOCAB, hidden_size=64, num_hidden_layers=2,
              num_attention_heads=2, ffn_dim=128, dropout=0.0,
              cross_attention=True, neighbor_layer_wise=1,
              peft_type="flamingo")
    model = _port_module(OPTForCausalLM(OPTConfig(**kw)), tree)
    ids = _ids(2, 10, 1)
    mask = np.ones_like(ids)
    rng = np.random.RandomState(2)
    memory = rng.normal(size=(2, 6, 64)).astype(np.float32)
    mem_mask = np.ones((2, 6), np.int64)
    mem_mask[1] = 0
    with torch.no_grad():
        got = model(input_ids=torch.from_numpy(ids),
                    attention_mask=torch.from_numpy(mask),
                    neighbor_embeds=torch.from_numpy(memory),
                    neighbor_mask=torch.from_numpy(mem_mask))[0].numpy()
    jtree = jhf.import_mpt(jhf.load_state_dict(str(tmp_path / "mpt")))
    jmodel = JOPTForCausalLM(JOPTConfig(**kw, attention_dropout=0.0))
    want = jmodel.apply({"params": jtree}, input_ids=ids,
                        attention_mask=mask, neighbor_embeds=memory,
                        neighbor_mask=mem_mask)[0]
    _close(got, want, "logits vs JAX")


def test_t5_forward_matches_hf_and_jax(tmp_path):
    """T5 from a saved checkpoint (HF's tied head and shared table): the
    port's logits on a right-padded encoder input and teacher-forced labels
    against HF's and the JAX module's, atol and rtol 2e-4."""
    hf_model = _hf_t5(9)
    _save(hf_model, tmp_path / "t5", "safetensors")
    tree = hf.import_t5(hf.load_state_dict(str(tmp_path / "t5")))
    kw = dict(vocab_size=VOCAB, d_model=64, d_kv=16, d_ff=128,
              num_layers=2, num_decoder_layers=2, num_heads=4,
              feed_forward_proj="relu", dropout_rate=0.0)
    model = T5ForConditionalGeneration(T5Config(**kw))
    sd = convert.state_dict_from_jax({"lm": tree})
    # HF keeps its tied head: the port's head is the shared table
    sd.pop("lm.lm_head.weight", None)
    model.load_state_dict({k[len("lm."):]: v for k, v in sd.items()})
    model.eval()
    ids = _ids(2, 9, 3)
    mask = np.ones_like(ids)
    mask[1, 6:] = 0
    labels = _ids(2, 5, 4)
    with torch.no_grad():
        got = model(input_ids=torch.from_numpy(ids),
                    attention_mask=torch.from_numpy(mask),
                    labels=torch.from_numpy(labels)).numpy()
        ref = hf_model(input_ids=torch.from_numpy(ids),
                       attention_mask=torch.from_numpy(mask),
                       labels=torch.from_numpy(labels)).logits.numpy()
    jtree = jhf.import_t5(jhf.load_state_dict(str(tmp_path / "t5")))
    want = JT5(JT5Config(**kw)).apply({"params": jtree}, input_ids=ids,
                                      attention_mask=mask, labels=labels)
    _close(got, ref, "logits vs HF")
    _close(got, want, "logits vs JAX")


def test_towers_forward_match_hf_and_jax(tmp_path):
    """Roberta, CLIP vision and CLIP text from one directory each (the
    CLIP towers from one saved CLIPModel, as ViT-B/16 ships): the port's
    outputs against HF's and the JAX modules', atol and rtol 2e-4; Roberta
    and CLIP text on right-padded ids, compared at the valid positions
    (HF's padded rows differ by its mask convention), the CLIP text's
    pooled output at each text's EOT."""
    rob = _hf_roberta(10)
    _save(rob, tmp_path / "roberta", "safetensors")
    clip = _hf_clip(11)
    _save(clip, tmp_path / "clip", "bin")
    cfg = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
               intermediate_size=64)

    ids = _ids(2, 10, 5)
    mask = np.ones_like(ids)
    mask[1, 7:] = 0
    ids[1, 7:] = 1
    tree = hf.import_roberta(hf.load_state_dict(str(tmp_path / "roberta")))
    model = RobertaModel(RobertaConfig(vocab_size=VOCAB, **cfg))
    sd = convert.state_dict_from_jax({"text_model": tree})
    model.load_state_dict({k[len("text_model."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
        ref = rob(input_ids=torch.from_numpy(ids),
                  attention_mask=torch.from_numpy(mask)
                  ).last_hidden_state.numpy()
    jtree = jhf.import_roberta(jhf.load_state_dict(str(tmp_path / "roberta")))
    want = JRobertaModel(JRobertaConfig(vocab_size=VOCAB, **cfg)).apply(
        {"params": jtree}, ids, mask)
    valid = mask.astype(bool)
    _close(got[valid], ref[valid], "roberta vs HF")
    _close(got[valid], np.asarray(want)[valid], "roberta vs JAX")

    sd_np = hf.load_state_dict(str(tmp_path / "clip"))
    jsd = jhf.load_state_dict(str(tmp_path / "clip"))
    pixels = np.random.RandomState(6).randn(2, 3, 32, 32).astype(np.float32)
    vision = CLIPVisionModel(CLIPVisionConfig(image_size=32, patch_size=8,
                                              **cfg))
    sd = convert.state_dict_from_jax(
        {"visual_model": hf.import_clip_vision(sd_np)})
    vision.load_state_dict({k[len("visual_model."):]: v
                            for k, v in sd.items()})
    with torch.no_grad():
        got_h, got_p = vision(torch.from_numpy(pixels))
        out = clip.vision_model(pixel_values=torch.from_numpy(pixels))
    want_h, want_p = JCLIPVisionModel(JCLIPVisionConfig(
        image_size=32, patch_size=8, **cfg)).apply(
            {"params": jhf.import_clip_vision(jsd)}, pixels)
    _close(got_h, out.last_hidden_state, "vision hidden vs HF")
    _close(got_p, out.pooler_output, "vision pooled vs HF")
    _close(got_h, want_h, "vision hidden vs JAX")
    _close(got_p, want_p, "vision pooled vs JAX")

    lengths = (10, 6)
    ids = _ids(2, 10, 7)
    mask = np.zeros_like(ids)
    for i, n in enumerate(lengths):
        ids[i, 0], ids[i, n - 1], ids[i, n:] = VOCAB - 2, VOCAB - 1, 0
        mask[i, :n] = 1
    text = CLIPTextModel(CLIPTextConfig(vocab_size=VOCAB, **cfg))
    sd = convert.state_dict_from_jax(
        {"text_model": hf.import_clip_text(sd_np)})
    text.load_state_dict({k[len("text_model."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got_h, got_p = text(torch.from_numpy(ids), torch.from_numpy(mask))
        out = clip.text_model(input_ids=torch.from_numpy(ids),
                              attention_mask=torch.from_numpy(mask))
    want_h, want_p = JCLIPTextModel(JCLIPTextConfig(
        vocab_size=VOCAB, **cfg)).apply(
            {"params": jhf.import_clip_text(jsd)}, ids, mask)
    valid = mask.astype(bool)
    _close(got_h.numpy()[valid], out.last_hidden_state.numpy()[valid],
           "text hidden vs HF")
    _close(got_p, out.pooler_output, "text pooled vs HF")
    _close(got_h, want_h, "text hidden vs JAX")
    _close(got_p, want_p, "text pooled vs JAX")


# ---- through build_model ---------------------------------------------------

def _args(model, *extra, context="all", neighbor_mode="raw"):
    args, _ = cli.parse_cli(["--model_name_or_path", model, "--context",
                             context, *TINY, "--neighbor_mode", neighbor_mode,
                             *extra])
    args.decoder_only = "t5" not in model
    return args


def _build(args):
    tok = ByteTokenizer()
    return build_model(args, torch.device("cpu"), vocab_size=tok.vocab_size,
                       tokenizer=tok)[0]


def _jax_overlay(args, seeded):
    """The JAX package's ``maybe_import_pretrained`` on the port's seeded
    weights in the flax layout (the tree shaped by ``jax.eval_shape`` of
    the JAX model's init: nothing is compiled), back in the port's names."""
    tok = ByteTokenizer()
    jargs = copy.copy(args)
    jargs.use_pallas = False
    jmodel, _ = jfactory.build_model(jargs, vocab_size=tok.vocab_size,
                                     tokenizer=tok)
    batch = next(iter(cli.PrefetchLoader(cli.setup_data(args, tok)[0],
                                         batch_size=2, num_workers=1)))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), batch)
    state = seeded.state_dict()

    def fill(tree, prefix=()):
        out = {}
        for key, leaf in tree.items():
            if isinstance(leaf, dict):
                out[key] = fill(leaf, prefix + (key,))
                continue
            name, flip = convert._torch_name(prefix + (key,))
            value = state[name].numpy()
            out[key] = np.array(value.T if flip else value)
            assert out[key].shape == leaf.shape, name
        return out
    params = jfactory.maybe_import_pretrained(fill(shapes["params"]), jargs)
    return convert.state_dict_from_jax(params)


# (the port's model name, neighbour mode, flags, {directory: (builder,
#  format)}, the modules the checkpoints overlay)
BUILD_CASES = {
    "opt-bin": ("opt-tiny", "raw", (), {"opt-tiny": ("opt", "bin")},
                ("lm",)),
    "opt-safetensors": ("opt-tiny", "raw", (),
                        {"opt-tiny": ("opt", "safetensors")}, ("lm",)),
    "opt-visual": ("opt-tiny", "raw", ("--visual_model", "clip-tiny"),
                   {"opt-tiny": ("opt", "bin"),
                    "clip-tiny": ("clip", "safetensors")},
                   ("lm", "visual_model")),
    "mpt-reads-opt": ("mpt-tiny", "embedding",
                      ("--peft_type", "flamingo", "--text_model",
                       "clip-text-tiny"),
                      {"opt-tiny": ("opt", "safetensors"),
                       "clip-text-tiny": ("clip_text", "bin")},
                      ("lm", "text_model")),
    "t5-roberta": ("t5-tiny", "embedding",
                   ("--text_model", "roberta-tiny", "--visual_model",
                    "clip-tiny"),
                   {"t5-tiny": ("t5", "safetensors"),
                    "roberta-tiny": ("roberta", "bin"),
                    "clip-tiny": ("clip", "bin")},
                   ("lm", "text_model", "visual_model")),
}
BUILDERS = {"opt": lambda: _hf_opt(12), "clip": lambda: _hf_clip(13),
            "clip_text": lambda: _hf_clip_text(14), "t5": lambda: _hf_t5(15),
            "roberta": lambda: _hf_roberta(16)}


@pytest.mark.parametrize("case", list(BUILD_CASES))
def test_build_model_imports_where_jax_does(case, tmp_path, monkeypatch):
    """build_model with local checkpoint directories: every parameter of
    the port's model equals ``state_dict_from_jax`` of the JAX package's
    overlay (maybe_import_pretrained) on the same seeded weights, bit for
    bit: the imported modules hold the files' tensors (every matrix and
    table differs from the seeded one), the rest (MPT's cross layers, the
    fusion's projections) keep their seeded init. An ``mpt-`` name reads
    the ``opt-`` directory of its size."""
    monkeypatch.chdir(tmp_path)
    name, neighbor_mode, flags, dirs, modules = BUILD_CASES[case]
    args = _args(name, *flags, neighbor_mode=neighbor_mode)
    seeded = _build(args)         # no directory exists yet
    for path, (builder, fmt) in dirs.items():
        _save(BUILDERS[builder](), tmp_path / path, fmt)
    model = _build(args)
    want = _jax_overlay(args, seeded)
    got, before = model.state_dict(), seeded.state_dict()
    assert got.keys() == want.keys()
    for key in want:
        assert torch.equal(got[key], want[key]), key
        if got[key].dim() == 2:
            imported = key.startswith(tuple(m + "." for m in modules)) and (
                ".neighbor_layers." not in key)
            assert torch.equal(got[key], before[key]) != imported, key


def test_a_missing_path_keeps_the_seeded_init(tmp_path, monkeypatch):
    """Names that are not directories (the default hub names, a path that
    does not exist) are skipped silently: the model equals the seeded one
    bit for bit, as the JAX package keeps its random init."""
    monkeypatch.chdir(tmp_path)
    seeded = _build(_args("opt-tiny")).state_dict()
    for name in ("nowhere/opt-tiny", str(tmp_path / "opt-tiny")):
        got = _build(_args(name, "--visual_model", "nowhere/clip")
                     ).state_dict()
        assert all(torch.equal(got[k], v) for k, v in seeded.items())


def test_a_checkpoint_of_another_size_raises(tmp_path, monkeypatch):
    """A checkpoint whose tensors do not fit the model the name selects
    (OPT 32 wide under an opt-tiny name, 64 wide) raises ValueError naming
    the tensor, where the JAX package would carry it into its tree."""
    monkeypatch.chdir(tmp_path)
    _save(_hf_opt(17, hidden=32), tmp_path / "opt-tiny", "bin")
    with pytest.raises(ValueError, match="embed_tokens"):
        _build(_args("opt-tiny"))


def test_neighbor_cache_key_follows_the_imported_tower(tmp_path,
                                                       monkeypatch):
    """The neighbour cache's fingerprint covers the towers' weights: the
    same checkpoint gives the same key, another checkpoint of the same
    shape another key, and so does the seeded init."""
    monkeypatch.chdir(tmp_path)
    flags = ("--text_model", "clip-text-tiny")
    keys = []
    for seed in (20, 20, 21, None):
        if seed is not None:
            _save(_hf_clip_text(seed), tmp_path / f"ckpt{seed}" /
                  "clip-text-tiny", "safetensors")
            monkeypatch.chdir(tmp_path / f"ckpt{seed}")
        else:
            monkeypatch.chdir(tmp_path)
        args = _args("opt-tiny", *flags, neighbor_mode="embedding")
        model = _build(args)
        cache = CachedNeighborDataset.__new__(CachedNeighborDataset)
        cache.dataset = cli.setup_data(args, ByteTokenizer())[0]
        keys.append(cache._fingerprint(model, "train"))
    assert keys[0] == keys[1] and len(set(keys)) == 3


def _safetensors_file(path, dtypes):
    import safetensors.numpy

    rng = np.random.RandomState(0)
    arrays = {f"t_{np.dtype(d).name}": (rng.normal(size=(3, 5)) * 50).astype(d)
              for d in dtypes}
    arrays["scalar"] = np.array(1.5, np.float32)
    arrays["empty"] = np.zeros((0, 4), np.float16)
    safetensors.numpy.save_file(arrays, str(path),
                                metadata={"format": "np"})
    return arrays


def test_safetensors_reader_equals_safetensors_numpy(tmp_path):
    """The port's reader against ``safetensors.numpy.load_file``: the same
    names, dtypes, shapes and bytes for every dtype both take (a scalar and
    an empty tensor among them), and for the files HF writes."""
    import safetensors.numpy

    path = tmp_path / "x.safetensors"
    _safetensors_file(path, (np.float64, np.float32, np.float16, np.int64,
                             np.int32, np.int16, np.int8, np.uint8,
                             np.bool_))
    for f in (path, None):
        if f is None:
            _save(_hf_clip(22), tmp_path / "clip", "safetensors")
            f = tmp_path / "clip" / "model.safetensors"
        want = safetensors.numpy.load_file(str(f))
        got = hf.read_safetensors(str(f))
        assert got.keys() == want.keys()
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("fmt", FORMATS)
def test_bfloat16_checkpoints_read_as_float32(fmt, tmp_path):
    """A bfloat16 checkpoint (either file) reads as float32 holding the
    same values: ``safetensors.numpy``'s bfloat16 (through the
    ml_dtypes that jax installs) and torch's, widened; and the imported
    OPT tree then converts to the JAX package's state dict exactly."""
    path = tmp_path / "opt"
    model = _hf_opt(25).to(torch.bfloat16)
    _save(model, path, fmt)
    got = hf.load_state_dict(str(path))
    want = model.state_dict()
    for key, value in got.items():
        assert value.dtype == np.float32, key
        assert torch.equal(torch.from_numpy(np.array(value)),
                           want[key].float()), key
    if fmt == "safetensors":
        ref = convert.state_dict_from_jax(
            {"lm": jhf.import_opt(jhf.load_state_dict(str(path)))})
        port = convert.state_dict_from_jax({"lm": hf.import_opt(got)})
        assert all(torch.equal(port[k], ref[k]) for k in ref)


def test_cli_test_pass_from_a_checkpoint(tmp_path, monkeypatch):
    """The entry point's --test pass with --model_name_or_path naming a
    saved OPT and --visual_model a saved CLIPModel: the weights are the
    files' and the metrics finite."""
    monkeypatch.chdir(tmp_path)
    _save(_hf_opt(23), tmp_path / "opt-tiny", "safetensors")
    _save(_hf_clip(24), tmp_path / "clip-tiny", "bin")
    built = []
    real = cli.build_model

    def spy(*a, **kw):
        model, cfg = real(*a, **kw)
        built.append(model)
        return model, cfg

    monkeypatch.setattr(cli, "build_model", spy)
    got = cli.main(["--model_name_or_path", "opt-tiny", "--visual_model",
                    "clip-tiny", "--context", "all", *TINY,
                    "--neighbor_mode", "raw", "--test", "true"])
    assert all(np.isfinite(v) for v in got.values())
    sd = hf.load_state_dict("opt-tiny")
    want = sd["model.decoder.layers.1.fc2.weight"]
    assert torch.equal(built[0].lm.decoder.layers[1].fc2.weight.detach(),
                       torch.from_numpy(np.array(want)))
