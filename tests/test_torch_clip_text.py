"""The port's CLIP text tower (``--text_model clip*``, models/clip.py)
against the JAX package's, on the CPU.

The tower alone at 16 and 77 tokens, over right-padded texts and an empty
one, with the JAX tower's weights carried across by utils/convert.py; the
78-token case, where the port raises and the JAX tower returns NaN (a
divergence kept on purpose: HF's CLIPTextModel refuses it too); and the
fusion model with the tower at tiny sizes: BASELINE family 7 (MPT +
flamingo + CLIP text, ``mpt-cliptext-all`` of
tests/test_baseline_configs.py), T5 and OPT in the embedding mode. The
fusion helpers (seeded weights shared through ``jax.eval_shape``, the
flamingo gates seeded non-zero) are tests/test_torch_peft.py's. fp32,
dropout off; each test states its tolerance.
"""

from functools import partial

import jax
import numpy as np
import pytest
import torch

from mmgl_tpu.models.clip import CLIPTextConfig as JCLIPTextConfig
from mmgl_tpu.models.clip import CLIPTextModel as JCLIPTextModel
from mmgl_tpu.train.generate import greedy_generate as jax_generate
from mmgl_tpu.train.steps import make_eval_step as jax_eval_step
from mmgl_tpu.utils.tokenizer import ByteTokenizer
from mmgl_tpu_torch import cli
from mmgl_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
from mmgl_tpu_torch.models.factory import build_fusion_config, build_model
from mmgl_tpu_torch.ops import attention as att
from mmgl_tpu_torch.train.generate import greedy_generate
from mmgl_tpu_torch.train.steps import losses_of, make_eval_step
from mmgl_tpu_torch.utils import convert
from test_torch_embedding import PAD, TINY, _batches
from test_torch_peft import (check_forward_and_grads, check_trainable_set,
                             jax_pair, port_model)
from test_torch_peft_train import check_updates

VOCAB = ByteTokenizer().vocab_size
TOWER = dict(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
             num_attention_heads=2, intermediate_size=64)
CLIP = ("--text_model", "clip-tiny")
# (model, context, position_type, flags): family 7, and the tower under T5
# and OPT in the embedding mode
CASES = {
    "mpt-cliptext": ("mpt-tiny", "all", "none",
                     ("--peft_type", "flamingo", *CLIP)),
    "t5-cliptext": ("t5-tiny", "section_all", "none", CLIP),
    "opt-cliptext": ("opt-tiny", "all", "none", CLIP),
}


def _texts(s, seed=0):
    """Four texts of s tokens: full, right-padded at two lengths, and empty
    (all pad, all masked); each non-empty one ends in the highest id, its
    EOT."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, VOCAB - 1, size=(4, s)).astype(np.int32)
    mask = np.zeros((4, s), np.int32)
    for i, n in enumerate((s, s // 2, 3, 0)):
        ids[i, n:] = 0
        if n:
            ids[i, n - 1] = VOCAB - 1
        mask[i, :n] = 1
    return ids, mask


def _towers(seed=0):
    """(the JAX tower, its params, the port's tower on the same weights)."""
    jmodel = JCLIPTextModel(JCLIPTextConfig(**TOWER))
    ids, mask = _texts(8)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(seed), ids,
                                        mask)["params"])
    model = CLIPTextModel(CLIPTextConfig(**TOWER)).eval()
    sd = convert.state_dict_from_jax({"text_model": params})
    model.load_state_dict({k[len("text_model."):]: v for k, v in sd.items()})
    return jmodel, params, model


@pytest.mark.parametrize("s", [16, 77])
def test_clip_text_tower_matches_jax(s):
    """The last hidden state (every row, the empty text's included) and the
    pooled output at the EOT, atol and rtol 1e-5, at 16 tokens (the plain
    route) and at 77 (K2's route, its plain version here); padded texts and
    the empty one give the JAX tower's values too."""
    jmodel, params, model = _towers()
    ids, mask = _texts(s, seed=s)
    want_h, want_p = jmodel.apply({"params": params}, ids, mask)
    with torch.no_grad():
        got_h, got_p = model(torch.from_numpy(ids).long(),
                             torch.from_numpy(mask))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-5,
                               atol=1e-5)
    route = att.attention_route((4, s, 2, 16), (4, s, 2, 16))
    assert route == ("reference" if s < att.MIN_KERNEL_SQ else "fused_heads")


def test_78_tokens_raise_where_the_jax_tower_returns_nan():
    """Past the 77-row position table the port raises ValueError before
    any launch, naming the table, where the JAX tower reads the missing
    rows as NaN and returns NaN in every row of every text and in the
    pooled output (the divergence kept on purpose; HF refuses it)."""
    jmodel, params, model = _towers()
    ids, mask = _texts(78)
    want_h, want_p = jmodel.apply({"params": params}, ids, mask)
    assert np.isnan(np.asarray(want_h)).all()
    assert np.isnan(np.asarray(want_p)).all()
    with pytest.raises(ValueError, match="77 entries"):
        model(torch.from_numpy(ids).long(), torch.from_numpy(mask))


def test_the_factory_builds_the_clip_text_tower():
    """``--text_model clip*`` gives the CLIP text tower: base is CLIP
    ViT-B/16's (512 wide, 12 layers, 8 heads of 64, 2048, vocabulary
    49408, 77 positions), tiny takes the tokenizer's vocabulary; any other
    text model Roberta. The fusion model holds no text pooler then."""
    args, _ = cli.parse_cli(["--model_name_or_path", "mpt-2.7b", "--context",
                             "all", "--neighbor_mode", "embedding",
                             "--text_model", "openai/clip-vit-base-patch16",
                             "--max_input_length", "77", "--device", "cpu"])
    cfg = build_fusion_config(args).text
    assert isinstance(cfg, CLIPTextConfig)
    assert (cfg.hidden_size, cfg.num_hidden_layers, cfg.num_attention_heads,
            cfg.head_dim, cfg.intermediate_size, cfg.vocab_size,
            cfg.max_position_embeddings) == (512, 12, 8, 64, 2048, 49408, 77)
    args, _ = cli.parse_cli(["--model_name_or_path", "opt-tiny", "--context",
                             "all", "--neighbor_mode", "embedding", *CLIP,
                             "--max_input_length", "77", "--device", "cpu"])
    assert build_fusion_config(args, vocab_size=VOCAB).text == CLIPTextConfig(
        **TOWER)
    args.text_model = "roberta-base"
    assert not isinstance(build_fusion_config(args).text, CLIPTextConfig)


def test_the_factory_refuses_texts_past_the_table():
    """The neighbour texts are tokenized to --max_input_length: past 77
    the model with the CLIP text tower raises ValueError naming the table
    at the tower's first call, before any launch. A configuration that
    builds no text tower (MPT without neighbours) is not refused: it runs
    at the default 512, as the JAX package does."""
    argv = ["--context", "all", *CLIP, *TINY, "--max_input_length", "78"]
    args, _ = cli.parse_cli(["--model_name_or_path", "opt-tiny", *argv])
    args.decoder_only = True
    model, cfg = build_model(args, torch.device("cpu"), vocab_size=VOCAB,
                             tokenizer=ByteTokenizer())
    assert cfg.clip_text and cfg.text.max_position_embeddings == 77
    with pytest.raises(ValueError, match="holds 77 entries"):
        model.eval()(_batches(args, 1)[0])
    args, _ = cli.parse_cli(["--model_name_or_path", "mpt-tiny", *argv,
                             "--context", "section_only",
                             "--max_input_length", "512"])
    args.decoder_only = True
    model, cfg = build_model(args, torch.device("cpu"), vocab_size=VOCAB,
                             tokenizer=ByteTokenizer())
    assert not cfg.needs_text_tower and not hasattr(model, "text_model")
    with torch.no_grad():
        loss, _ = losses_of(model.eval()(_batches(args, 1)[0]), True, 512,
                            PAD)
    assert torch.isfinite(loss)


@pytest.mark.parametrize("name", list(CASES))
def test_clip_text_trainable_set_matches_jax(name):
    """requires_grad equal to the JAX package's trainable_mask and the
    counts to its count_params: the CLIP text tower is frozen and there is
    no text pooler; its projection trains."""
    args, batch, _, _ = jax_pair(name, CASES)
    got = check_trainable_set(args, batch, args.peft_type)
    assert not any(n.startswith("text_pooler.") for n in got)
    assert not any(v for n, v in got.items() if n.startswith("text_model."))
    assert got["text_embeddings.weight"]


@pytest.mark.parametrize("name", list(CASES))
def test_clip_text_forward_and_grads_match_jax(name):
    """The fused forward with the CLIP text tower (the JAX package's
    weights, the gates non-zero): labels exact, logits atol 1e-4; every
    trainable tensor's gradient atol 1e-4 of its largest entry plus 1e-7;
    the text projection, 32 wide (the tower's), among them."""
    args, batch, jmodel, params = jax_pair(name, CASES)
    model = port_model(args, params)
    assert model.text_embeddings.weight.shape[1] == TOWER["hidden_size"]
    checked = check_forward_and_grads(args, batch, jmodel, params, model)
    assert "text_embeddings.weight" in checked
    if name == "mpt-cliptext":
        assert "lm.decoder.neighbor_layers.1.gating2" in checked


def test_family_7_two_updates_match_jax():
    """Two AdamW updates of family 7 (MPT + flamingo + CLIP text, gates
    non-zero): loss rtol 1e-5, every trainable parameter atol 1e-5, the LM
    and both towers bit-identical; the cross layers' k_proj biases (a zero
    true gradient) within the sum of the learning rates."""
    check_updates("mpt-cliptext", CASES, skip=("k_proj.bias",))


@pytest.mark.parametrize("name", ["mpt-cliptext", "t5-cliptext"])
def test_clip_text_eval_step_and_greedy_decode_match_jax(name):
    """The teacher-forced eval step (loss within 1e-5, predictions exact)
    and greedy decode of one test batch, token for token."""
    args, _, jmodel, params = jax_pair(name, CASES)
    batch = _batches(args, 1, split=2)[0]
    model = port_model(args, params)
    want = jax.jit(jax_eval_step(jmodel, args.decoder_only,
                                 args.max_input_length, PAD))(params, batch)
    got = make_eval_step(model, args.decoder_only, args.max_input_length,
                         PAD)(batch)
    for key in ("loss", "summary_loss"):
        assert abs(float(got[key]) - float(want[key])) <= 1e-5, key
    np.testing.assert_array_equal(got["predictions"].numpy(),
                                  np.asarray(want["predictions"]))
    want = jax.jit(partial(jax_generate, jmodel, max_new_tokens=8))(
        {"params": params}, batch)
    got = greedy_generate(model, batch, max_new_tokens=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cli_family_7_trains_and_tests(tmp_path):
    """BASELINE family 7 through the entry point at a tiny size: training
    (the epoch-0 val pass, two updates, val, the best checkpoint, the test
    pass on it) with finite metrics."""
    got = cli.main(["--model_name_or_path", "mpt-tiny", "--context", "all",
                    "--peft_type", "flamingo", *CLIP, *TINY, "--epochs", "1",
                    "--log_dir", str(tmp_path)])
    assert got["train_updates"] == 2.0
    assert all(np.isfinite(v) for v in got.values())
