"""CLIP vision tower (counterpart of mmgl_tpu/models/clip.py:34-241).

The frozen image tower of the fusion model: pooler_output is the post-LN
class token. Parameters stay fp32 and each layer computes in ``dtype``
(models/layers.py). The patch embedding stays a flattened-patch ``Linear`` in the
JAX package's (p, p, 3) patch order, so its weight converts from the flax
kernel by a transpose (utils/convert.py). Module names follow the flax
parameter paths. The CLIP text tower comes in a later change.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from mmgl_tpu_torch.models.layers import (ACT2FN, LayerNorm, Linear,
                                          cast_at_use)
from mmgl_tpu_torch.ops import multi_head_attention

# CLIP preprocessing constants; images travel to the device as uint8 and are
# normalized there
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def normalize_pixels(pixel_values: torch.Tensor,
                     valid: Optional[torch.Tensor] = None,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 (..., 3, H, W) -> CLIP-normalized floats; float input passes
    through. ``valid`` (leading-dims bool) zeroes invalid slots after
    normalization, as the reference's zeros(3, 224, 224) placeholder."""
    if not torch.is_floating_point(pixel_values):
        x = pixel_values.to(torch.float32) / 255.0
        mean = torch.tensor(CLIP_MEAN, dtype=torch.float32,
                            device=x.device).reshape(3, 1, 1)
        std = torch.tensor(CLIP_STD, dtype=torch.float32,
                           device=x.device).reshape(3, 1, 1)
        x = (x - mean) / std
    else:
        x = pixel_values.to(torch.float32)
    if valid is not None:
        shape = tuple(valid.shape) + (1,) * (x.dim() - valid.dim())
        x = x * valid.reshape(shape).to(x.dtype)
    return x.to(dtype)


@dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    image_size: int = 224
    patch_size: int = 16
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"
    dtype: torch.dtype = torch.float32
    use_pallas: bool = True      # False: attention_reference (--use_pallas)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


class CLIPAttention(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, dtype: torch.dtype,
                 use_pallas: bool = True):
        super().__init__()
        self.num_heads, self.use_pallas = num_heads, use_pallas
        self.query = Linear(hidden_size, hidden_size, compute_dtype=dtype)
        self.key = Linear(hidden_size, hidden_size, compute_dtype=dtype)
        self.value = Linear(hidden_size, hidden_size, compute_dtype=dtype)
        self.out = Linear(hidden_size, hidden_size, compute_dtype=dtype)

    def forward(self, hidden_states, attention_mask=None):
        b, s, e = hidden_states.shape
        h = self.num_heads
        q = self.query(hidden_states).view(b, s, h, e // h)
        k = self.key(hidden_states).view(b, s, h, e // h)
        v = self.value(hidden_states).view(b, s, h, e // h)
        out = multi_head_attention(q, k, v, kv_mask=attention_mask,
                                   use_pallas=self.use_pallas)
        return self.out(out.reshape(b, s, e))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        dt = cfg.dtype
        self.attention = CLIPAttention(cfg.hidden_size,
                                       cfg.num_attention_heads, dt,
                                       cfg.use_pallas)
        self.norm1 = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps,
                               compute_dtype=dt)
        self.norm2 = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps,
                               compute_dtype=dt)
        self.fc1 = Linear(cfg.hidden_size, cfg.intermediate_size,
                          compute_dtype=dt)
        self.fc2 = Linear(cfg.intermediate_size, cfg.hidden_size,
                          compute_dtype=dt)
        self.act = ACT2FN[cfg.hidden_act]

    def forward(self, hidden_states, attention_mask=None):
        hidden_states = hidden_states + self.attention(
            self.norm1(hidden_states), attention_mask)
        h = self.act(self.fc1(self.norm2(hidden_states)))
        return hidden_states + self.fc2(h)


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg)
                                    for _ in range(cfg.num_hidden_layers))

    def forward(self, hidden_states, attention_mask=None):
        for layer in self.layers:
            hidden_states = layer(hidden_states, attention_mask)
        return hidden_states


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        p = cfg.patch_size
        self.class_embedding = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.patch_embedding = Linear(p * p * 3, cfg.hidden_size, bias=False,
                                      compute_dtype=cfg.dtype)
        self.position_embedding = nn.Embedding(cfg.num_patches + 1,
                                               cfg.hidden_size)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """pixel_values: (B, 3, H, W), channel-first."""
        cfg = self.cfg
        b = pixel_values.shape[0]
        p = cfg.patch_size
        g = cfg.image_size // p
        # (B,3,H,W) -> (B, gh, gw, p, p, 3) -> flattened (p, p, 3) patches
        x = pixel_values.reshape(b, 3, g, p, g, p).permute(0, 2, 4, 3, 5, 1)
        x = x.reshape(b, g * g, p * p * 3)
        patches = self.patch_embedding(x)
        cls = cast_at_use(self.class_embedding, cfg.dtype).expand(b, 1, -1)
        x = torch.cat([cls, patches], dim=1)
        pos = cast_at_use(self.position_embedding.weight, cfg.dtype)
        return x + pos[None]


class CLIPVisionModel(nn.Module):
    """Returns (last_hidden_state, pooler_output)."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.config = cfg
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.pre_layernorm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps,
                                       compute_dtype=cfg.dtype)
        self.encoder = CLIPEncoder(cfg)
        self.post_layernorm = LayerNorm(cfg.hidden_size,
                                        eps=cfg.layer_norm_eps,
                                        compute_dtype=cfg.dtype)

    def forward(self, pixel_values) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.embeddings(pixel_values)
        x = self.pre_layernorm(x)
        x = self.encoder(x)
        pooled = self.post_layernorm(x[:, 0])
        return x, pooled
