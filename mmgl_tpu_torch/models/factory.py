"""Model factory: Arguments -> MMGLModel (counterpart of
mmgl_tpu/models/factory.py:27-181).

Same substring selection on ``model_name_or_path`` and the same tabled OPT,
T5 and CLIP-vision shapes as the JAX package. ``build_model`` initializes the
weights from a ``torch.Generator`` seeded with ``--seed`` (on the CPU, so one
seed gives the same weights on every device) and moves the model to
``device`` with its parameters in ``--param_dtype`` (float32); each layer
computes in the compute dtype (models/layers.py). ``requires_grad`` follows
the trainable mask of peft/masks.py. Loading pretrained weights is not
ported yet (ROADMAP A4): a checkpoint directory named by
``--model_name_or_path``, ``--visual_model`` or ``--text_model`` raises,
where the JAX package would overlay it (``maybe_import_pretrained``).
"""

from __future__ import annotations

import os
from dataclasses import replace
from typing import Optional, Tuple

import torch

from mmgl_tpu_torch.config import Arguments
from mmgl_tpu_torch.models.clip import CLIPVisionConfig
from mmgl_tpu_torch.models.fusion import FusionConfig, MMGLModel
from mmgl_tpu_torch.models.layers import init_weights
from mmgl_tpu_torch.models.opt import OPTConfig
from mmgl_tpu_torch.models.t5 import T5Config
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
    """Raises NotImplementedError for what is not ported yet: MPT,
    embedding/cross-attention neighbor modes and PEFT."""
    name = args.model_name_or_path or "opt-tiny"
    tiny = "tiny" in name
    if "mpt" in name:
        raise NotImplementedError(f"{name}: MPT is not ported yet")
    if "t5" not in name and "opt" not in name:
        raise ValueError(f"unsupported model {name} (need t5/opt/mpt)")
    if args.neighbor_mode != "raw":
        raise NotImplementedError(
            f"neighbor_mode={args.neighbor_mode!r} is not ported yet")
    if args.peft_type != "none":
        raise NotImplementedError(
            f"peft_type={args.peft_type!r} is not ported yet")

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
            dtype=dt, use_pallas=args.use_pallas)
        if vocab_size:
            opt_cfg = replace(opt_cfg, vocab_size=vocab_size)
        if tokenizer is not None:
            opt_cfg = replace(
                opt_cfg, pad_token_id=tokenizer.pad_token_id,
                eos_token_id=tokenizer.eos_token_id,
                bos_token_id=tokenizer.bos_token_id or opt_cfg.bos_token_id)

    # --use_pallas false sends the LM's and the tower's attention to
    # attention_reference (mmgl_tpu/models/factory.py:65-68, 81, 147)
    tower_kw = dict(dtype=dt, use_pallas=args.use_pallas)
    vision_cfg = (CLIPVisionConfig(**tower_kw) if not tiny
                  else CLIPVisionConfig(
                      hidden_size=32, num_hidden_layers=2,
                      num_attention_heads=2, intermediate_size=64,
                      image_size=32, patch_size=8, **tower_kw))

    return FusionConfig(
        context=args.context, n_visual_tokens=args.n_visual_tokens,
        max_input_length=args.max_input_length, opt=opt_cfg,
        vision=vision_cfg, t5=t5_cfg)


def _refuse_checkpoints(args: Arguments) -> None:
    """Raise where a flag names a local checkpoint directory: the JAX
    package overlays it (mmgl_tpu/models/factory.py:184-217), and random
    weights in its place would train another model without a word."""
    for flag in ("model_name_or_path", "visual_model", "text_model"):
        path = getattr(args, flag) or ""
        if os.path.isdir(path):
            raise NotImplementedError(
                f"--{flag} {path} is a checkpoint directory: loading "
                "pretrained weights is not ported yet (ROADMAP A4)")


def build_model(args: Arguments, device: torch.device,
                vocab_size: Optional[int] = None,
                tokenizer=None) -> Tuple[MMGLModel, FusionConfig]:
    """Seeded random init on the CPU, then moved to ``device`` with
    ``--param_dtype`` parameters; returned in train mode with the trainable
    set of ``--peft_type``/``--freeze_lm``."""
    _refuse_checkpoints(args)
    dt = _compute_dtype(args)
    if device.type == "cuda" and dt not in (torch.float32, torch.bfloat16):
        # refused before anything is built: the first attention would
        # raise only after the model and the data
        raise ValueError(
            f"--compute_dtype {args.compute_dtype} on {device}: the attention "
            "kernels take float32 and bfloat16 only (the float16 form of "
            "their tensor-core bodies is not written yet)")
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
