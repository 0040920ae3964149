"""CLIP's ViT vision tower in plain PyTorch: its pooler output
(post-LN class token) of a micro-batch's image slots. Weights under
Hugging Face's names (``vision_model.*``)."""

import torch
import torch.nn.functional as F

from benchmark.reference.model import Precision, attention, layer_norm

_ATTN = ("q_proj", "k_proj", "v_proj", "out_proj")
MEAN = (0.48145466, 0.4578275, 0.40821073)
STD = (0.26862954, 0.26130258, 0.27577711)


def pooled(p, cfg, part, settings, batch, prec: Precision):
    """(N images, width) of uint8 images (B, slots, 3, H, W); a placeholder
    slot (``images_valid`` 0) is zeroed after normalizing."""
    v = cfg[part["part"]]
    x = batch["images"].flatten(0, 1).float() / 255.0
    valid = batch["images_valid"].flatten()
    mean = torch.tensor(MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(STD, device=x.device).view(1, 3, 1, 1)
    x = (x - mean) / std * valid.float().view(-1, 1, 1, 1)
    pre = "vision_model."
    w = p[pre + "embeddings.patch_embedding.weight"]
    if prec.fp8:
        x, w = prec.q(x), prec.q(w)
    patches = F.conv2d(x, w, stride=v["patch_size"])
    n = patches.shape[0]
    patches = patches.flatten(2).transpose(1, 2)
    cls = p[pre + "embeddings.class_embedding"].expand(n, 1, -1)
    h = torch.cat([cls, patches], dim=1) + p[
        pre + "embeddings.position_embedding.weight"][None]
    h = layer_norm(h, p[pre + "pre_layrnorm.weight"],
                   p[pre + "pre_layrnorm.bias"])
    ones = torch.ones(n, h.shape[1], device=h.device)
    for i in range(v["num_hidden_layers"]):
        lp = f"{pre}encoder.layers.{i}."
        a = layer_norm(h, p[lp + "layer_norm1.weight"],
                       p[lp + "layer_norm1.bias"])
        h = h + attention(a, p, [lp + "self_attn." + n for n in _ATTN],
                          v["num_attention_heads"], ones, False, prec)
        m = layer_norm(h, p[lp + "layer_norm2.weight"],
                       p[lp + "layer_norm2.bias"])
        m = prec.linear(m, p[lp + "mlp.fc1.weight"], p[lp + "mlp.fc1.bias"])
        m = m * torch.sigmoid(1.702 * m)
        h = h + prec.linear(m, p[lp + "mlp.fc2.weight"],
                            p[lp + "mlp.fc2.bias"])
    return layer_norm(h[:, 0], p[pre + "post_layernorm.weight"],
                      p[pre + "post_layernorm.bias"])
