"""Model factory: Arguments -> MMGLModel (counterpart of
mmgl_tpu/models/factory.py:27-181).

Same substring selection on ``model_name_or_path`` and the same tabled OPT
and CLIP-vision shapes as the JAX package. ``build_model`` initializes the
weights from a ``torch.Generator`` seeded with ``--seed`` (on the CPU, so one
seed gives the same weights on every device) and moves the model to
``device`` with its parameters in ``--param_dtype`` (float32); each layer
computes in the compute dtype (models/layers.py). ``requires_grad`` follows
the trainable mask of peft/masks.py. Loading pretrained weights comes in a
later change: there are no local checkpoints.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional, Tuple

import torch

from mmgl_tpu.config import Arguments
from mmgl_tpu_torch.models.clip import CLIPVisionConfig
from mmgl_tpu_torch.models.fusion import FusionConfig, MMGLModel
from mmgl_tpu_torch.models.layers import init_weights
from mmgl_tpu_torch.models.opt import OPTConfig
from mmgl_tpu_torch.peft.masks import apply_trainable_mask

# (hidden, layers, heads, ffn, word_embed_proj)
_OPT_SIZES = {
    "tiny": (64, 2, 2, 128, None),         # test-scale
    "125m": (768, 12, 12, 3072, None),
    "350m": (1024, 24, 16, 4096, 512),
    "1.3b": (2048, 24, 32, 8192, None),
    "2.7b": (2560, 32, 32, 10240, None),
    "6.7b": (4096, 32, 32, 16384, None),
}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _compute_dtype(args: Arguments) -> torch.dtype:
    """bf16 (``--compute_dtype``) under ``--bf16 true``, else fp32."""
    return _DTYPES[args.compute_dtype if args.bf16 else "float32"]


def _size_of(name: str) -> str:
    for key in _OPT_SIZES:
        if key in name:
            return key
    return "tiny"


def build_fusion_config(args: Arguments, vocab_size: Optional[int] = None,
                        tokenizer=None) -> FusionConfig:
    """Raises NotImplementedError for what is not ported yet: T5, MPT,
    embedding/cross-attention neighbor modes and PEFT."""
    name = args.model_name_or_path or "opt-tiny"
    tiny = "tiny" in name
    if "t5" in name or "mpt" in name:
        raise NotImplementedError(f"{name}: only OPT is ported yet")
    if "opt" not in name:
        raise ValueError(f"unsupported model {name} (need t5/opt/mpt)")
    if args.neighbor_mode != "raw":
        raise NotImplementedError(
            f"neighbor_mode={args.neighbor_mode!r} is not ported yet")
    if args.peft_type != "none":
        raise NotImplementedError(
            f"peft_type={args.peft_type!r} is not ported yet")

    size = _size_of(name)
    hidden, layers, heads, ffn, proj = _OPT_SIZES[size]
    dt = _compute_dtype(args)
    opt_cfg = OPTConfig(
        hidden_size=hidden, num_hidden_layers=layers,
        num_attention_heads=heads, ffn_dim=ffn, word_embed_proj_dim=proj,
        do_layer_norm_before=(size != "350m"),
        dropout=0.0 if size == "tiny" else 0.1, layerdrop=args.layerdrop,
        dtype=dt)
    if vocab_size:
        opt_cfg = replace(opt_cfg, vocab_size=vocab_size)
    if tokenizer is not None:
        opt_cfg = replace(
            opt_cfg, pad_token_id=tokenizer.pad_token_id,
            eos_token_id=tokenizer.eos_token_id,
            bos_token_id=tokenizer.bos_token_id or opt_cfg.bos_token_id)

    vision_cfg = (CLIPVisionConfig(dtype=dt) if not tiny
                  else CLIPVisionConfig(
                      hidden_size=32, num_hidden_layers=2,
                      num_attention_heads=2, intermediate_size=64,
                      image_size=32, patch_size=8, dtype=dt))

    return FusionConfig(
        context=args.context, n_visual_tokens=args.n_visual_tokens,
        max_input_length=args.max_input_length, opt=opt_cfg,
        vision=vision_cfg)


def build_model(args: Arguments, device: torch.device,
                vocab_size: Optional[int] = None,
                tokenizer=None) -> Tuple[MMGLModel, FusionConfig]:
    """Seeded random init on the CPU, then moved to ``device`` with
    ``--param_dtype`` parameters; returned in train mode with the trainable
    set of ``--peft_type``/``--freeze_lm``."""
    cfg = build_fusion_config(args, vocab_size, tokenizer=tokenizer)
    model = MMGLModel(cfg)
    generator = torch.Generator().manual_seed(args.seed or 0)
    init_weights(model, generator)
    if cfg.needs_vision_tower:
        with torch.no_grad():
            model.visual_model.embeddings.class_embedding.normal_(
                0.0, 0.02, generator=generator)
    model = model.to(device=device, dtype=_DTYPES[args.param_dtype])
    apply_trainable_mask(model, args.peft_type, args.freeze_lm)
    return model.train(), cfg
