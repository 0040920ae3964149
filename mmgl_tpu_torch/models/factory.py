"""Model factory: Arguments -> MMGLModel (counterpart of
mmgl_tpu/models/factory.py:27-181).

Same substring selection on ``model_name_or_path`` and the same tabled OPT,
T5, CLIP-vision, CLIP-text and Roberta shapes as the JAX package.
``build_model`` initializes the weights from a ``torch.Generator`` seeded
with ``--seed`` (on the CPU, so one seed gives the same weights on every
device), overlays the local HF checkpoints that ``--model_name_or_path``,
``--text_model`` and ``--visual_model`` name (``maybe_import_pretrained``;
a name that is not a directory keeps the seeded weights), and moves the
model to ``device`` with its parameters in ``--param_dtype`` (float32);
each layer computes in the compute dtype (models/layers.py).
``requires_grad`` follows the trainable mask of peft/masks.py.

``mpt-<size>`` is OPT of that size with MPT's cross layers over the
neighbour memory, one every ``layers // --num_neighbor_layers`` layers
(mmgl_tpu/models/factory.py:51-70, 113-114, 135), where the embedding
mode gives it a memory. The PEFT fields (``--peft_type``, ``--lora_r``,
``--lora_alpha``, ``--lora_dropout``) go into the OPT config and the
fusion config.

On a CUDA device the attention kernels take the head dims of every
published size here: 64, 80 (OPT and MPT at 2.7B) and 128 (6.7B), in fp32,
bf16 and fp16 (``--compute_dtype``); the tiny test shapes run on the CPU.
"""

from __future__ import annotations

import os
from dataclasses import replace
from typing import Optional, Tuple

import torch

from mmgl_tpu_torch.config import Arguments
from mmgl_tpu_torch.models.clip import CLIPTextConfig, CLIPVisionConfig
from mmgl_tpu_torch.models.fusion import FusionConfig, MMGLModel
from mmgl_tpu_torch.models.layers import init_weights
from mmgl_tpu_torch.models.opt import OPTConfig
from mmgl_tpu_torch.models.roberta import RobertaConfig
from mmgl_tpu_torch.models.t5 import T5Config
from mmgl_tpu_torch.peft.masks import apply_trainable_mask
from mmgl_tpu_torch.utils import hf_import
from mmgl_tpu_torch.utils.convert import state_dict_from_jax

# (hidden, layers, heads, ffn, word_embed_proj)
_OPT_SIZES = {
    "tiny": (64, 2, 2, 128, None),         # test-scale
    "125m": (768, 12, 12, 3072, None),
    "350m": (1024, 24, 16, 4096, 512),
    "1.3b": (2048, 24, 32, 8192, None),
    "2.7b": (2560, 32, 32, 10240, None),
    "6.7b": (4096, 32, 32, 16384, None),
}

# (d_model, d_kv, d_ff, layers, heads, gated)
_T5_SIZES = {
    "tiny": (64, 16, 128, 2, 4, False),    # test-scale
    "small": (512, 64, 2048, 6, 8, False),
    "base": (768, 64, 3072, 12, 12, False),
    "large": (1024, 64, 4096, 24, 16, False),
    "flan-base": (768, 64, 2048, 12, 12, True),
}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _compute_dtype(args: Arguments) -> torch.dtype:
    """bf16 (``--compute_dtype``) under ``--bf16 true``, else fp32."""
    return _DTYPES[args.compute_dtype if args.bf16 else "float32"]


def _size_of(name: str, table) -> str:
    for key in table:
        if key in name:
            return key
    return "tiny"


def _t5_config(args: Arguments, size: str) -> T5Config:
    """mmgl_tpu/models/factory.py:72-82: dropout 0.1 (hidden and attention
    probabilities), 0 for the tiny test shape."""
    d_model, d_kv, d_ff, layers, heads, gated = _T5_SIZES[size]
    return T5Config(
        d_model=d_model, d_kv=d_kv, d_ff=d_ff, num_layers=layers,
        num_decoder_layers=layers, num_heads=heads,
        feed_forward_proj="gated-gelu" if gated else "relu",
        dropout_rate=0.0 if size == "tiny" else 0.1,
        dtype=_compute_dtype(args), use_pallas=args.use_pallas)


def build_fusion_config(args: Arguments, vocab_size: Optional[int] = None,
                        tokenizer=None) -> FusionConfig:
    name = args.model_name_or_path or "opt-tiny"
    tiny = "tiny" in name
    # substring selection in the JAX package's order: t5, mpt, opt
    mpt = "t5" not in name and "mpt" in name
    if "t5" not in name and "opt" not in name and not mpt:
        raise ValueError(f"unsupported model {name} (need t5/opt/mpt)")
    if (args.neighbor_mode == "embedding"
            and args.n_text_tokens != args.n_visual_tokens):
        # the interleaved neighbor block holds text and image soft tokens
        # in one fixed-stride grid (mmgl_tpu/models/factory.py:98-106)
        raise ValueError(
            f"n_text_tokens ({args.n_text_tokens}) must equal "
            f"n_visual_tokens ({args.n_visual_tokens}) in "
            f"neighbor_mode={args.neighbor_mode!r}")

    dt = _compute_dtype(args)
    opt_cfg = t5_cfg = None
    if "t5" in name:
        t5_cfg = _t5_config(args, _size_of(name, _T5_SIZES))
        if vocab_size:
            t5_cfg = replace(t5_cfg, vocab_size=vocab_size)
        if tokenizer is not None:
            # the ids track the tokenizer in use (the HF defaults, eos 1,
            # collide with the byte tokenizer's bos 1); the decoder starts
            # from pad, as HF T5 does (mmgl_tpu/models/factory.py:125-132)
            t5_cfg = replace(
                t5_cfg, pad_token_id=tokenizer.pad_token_id,
                eos_token_id=tokenizer.eos_token_id,
                decoder_start_token_id=tokenizer.pad_token_id)
    else:
        size = _size_of(name, _OPT_SIZES)
        hidden, layers, heads, ffn, proj = _OPT_SIZES[size]
        opt_cfg = OPTConfig(
            hidden_size=hidden, num_hidden_layers=layers,
            num_attention_heads=heads, ffn_dim=ffn, word_embed_proj_dim=proj,
            do_layer_norm_before=(size != "350m"),
            dropout=0.0 if size == "tiny" else 0.1, layerdrop=args.layerdrop,
            neighbor_layer_wise=max(1, layers
                                    // max(1, args.num_neighbor_layers)),
            peft_type=args.peft_type, lora_r=args.lora_r,
            lora_alpha=args.lora_alpha, lora_dropout=args.lora_dropout,
            dtype=dt, use_pallas=args.use_pallas, remat=args.remat)
        if vocab_size:
            opt_cfg = replace(opt_cfg, vocab_size=vocab_size)
        if tokenizer is not None:
            opt_cfg = replace(
                opt_cfg, pad_token_id=tokenizer.pad_token_id,
                eos_token_id=tokenizer.eos_token_id,
                bos_token_id=tokenizer.bos_token_id or opt_cfg.bos_token_id)

    # --use_pallas false sends the LM's and the towers' attention to
    # attention_reference (mmgl_tpu/models/factory.py:65-68, 81, 147)
    tower_kw = dict(dtype=dt, use_pallas=args.use_pallas)
    vision_cfg = (CLIPVisionConfig(**tower_kw) if not tiny
                  else CLIPVisionConfig(
                      hidden_size=32, num_hidden_layers=2,
                      num_attention_heads=2, intermediate_size=64,
                      image_size=32, patch_size=8, **tower_kw))
    # the text tower: the CLIP text tower of ViT-B/16 for a "clip" text
    # model, else roberta-base; or the tiny test shape with the
    # tokenizer's vocabulary (mmgl_tpu/models/factory.py:148-159)
    text_cfg = None
    if args.neighbor_mode == "embedding":
        tower = (CLIPTextConfig if "clip" in args.text_model
                 else RobertaConfig)
        text_cfg = (tower(**tower_kw) if not tiny else tower(
            hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=64,
            vocab_size=vocab_size or tower.vocab_size, **tower_kw))

    cfg = FusionConfig(
        context=args.context, neighbor_mode=args.neighbor_mode,
        n_text_tokens=args.n_text_tokens,
        n_visual_tokens=args.n_visual_tokens,
        position_type=args.position_type,
        max_text_neighbors=args.max_text_neighbors,
        max_image_neighbors=args.max_image_neighbors,
        max_input_length=args.max_input_length,
        max_output_length=args.max_output_length,
        mpt=mpt, peft_type=args.peft_type, opt=opt_cfg, vision=vision_cfg,
        t5=t5_cfg, text=text_cfg)
    if cfg.has_memory:
        # the JAX package sets cross_attention for every MPT, and flax
        # creates the cross layers at their first call: only where the
        # fusion model hands the decoder a memory
        cfg = replace(cfg, opt=replace(opt_cfg, cross_attention=True))
    return cfg


def _overlay(model: MMGLModel, module: str, tree: dict) -> int:
    """Copy a flax-layout tree of ``module`` (``lm``, ``text_model``,
    ``visual_model``) into the model's parameters in place, through the
    port's one map from flax paths (utils/convert.py). Every tensor must
    name a parameter of that shape; HF's copy of a tied LM head is the
    embedding and is skipped. Returns the tensors copied."""
    own = dict(model.named_parameters())
    copied = 0
    with torch.no_grad():
        for name, value in state_dict_from_jax({module: tree}).items():
            if name not in own:
                if name == f"{module}.lm_head.weight":
                    continue
                raise KeyError(f"the checkpoint's {name} has no parameter "
                               "in the model")
            if tuple(own[name].shape) != tuple(value.shape):
                raise ValueError(f"the checkpoint's {name} is "
                                 f"{tuple(value.shape)}, the model's "
                                 f"{tuple(own[name].shape)}")
            own[name].copy_(value)
            copied += 1
    return copied


def maybe_import_pretrained(model: MMGLModel, args: Arguments) -> None:
    """Overlay local HF checkpoints (the LM and the towers) onto the
    initialized model (mmgl_tpu/models/factory.py:184-217). An ``mpt``
    name reads the OPT directory of its size (``name.replace("mpt",
    "opt")``, as the reference does) and the cross layers keep their init;
    ``t5`` takes the T5 importer; a ``clip`` text model the CLIP text
    tower's, else Roberta's; the visual model CLIP vision's. A name that is
    not a directory is skipped silently (random init), as in the JAX
    package: there is no network to fetch it from."""
    name = args.model_name_or_path or ""
    lm_path = name.replace("mpt", "opt")
    parts = []
    if os.path.isdir(lm_path):
        parts.append(("lm", lm_path, hf_import.import_t5 if "t5" in name
                      else hf_import.import_opt))
    if hasattr(model, "text_model") and os.path.isdir(args.text_model):
        parts.append(("text_model", args.text_model,
                      hf_import.import_clip_text if model.config.clip_text
                      else hf_import.import_roberta))
    if hasattr(model, "visual_model") and os.path.isdir(args.visual_model):
        parts.append(("visual_model", args.visual_model,
                      hf_import.import_clip_vision))
    for module, path, importer in parts:
        tree = importer(hf_import.load_state_dict(path))
        n = _overlay(model, module, tree)
        print(f"[import] {module}: {n} tensors from {path}")


def build_model(args: Arguments, device: torch.device,
                vocab_size: Optional[int] = None,
                tokenizer=None) -> Tuple[MMGLModel, FusionConfig]:
    """Seeded random init on the CPU, then moved to ``device`` with
    ``--param_dtype`` parameters; returned in train mode with the trainable
    set of ``--peft_type``/``--freeze_lm``. Local HF checkpoints are
    overlaid after the seeded init and before the cast and the move
    (``maybe_import_pretrained``)."""
    cfg = build_fusion_config(args, vocab_size, tokenizer=tokenizer)
    model = MMGLModel(cfg)
    generator = torch.Generator().manual_seed(args.seed or 0)
    init_weights(model, generator)
    if cfg.needs_vision_tower:
        with torch.no_grad():
            model.visual_model.embeddings.class_embedding.normal_(
                0.0, 0.02, generator=generator)
    maybe_import_pretrained(model, args)
    model = model.to(device=device, dtype=_DTYPES[args.param_dtype])
    apply_trainable_mask(model, args.peft_type, args.freeze_lm)
    return model.train(), cfg
