"""The frozen CLIP vision tower as the benchmark counts it: its weights in
Hugging Face's layout (``vision_model.*``) and the fusion block's
projection of its pooled output to soft tokens (``visual_embeddings``,
``extra``), its model FLOPs, and its attention launches.

Model FLOPs of a micro-batch, over the valid image slots only
(``images_valid``; a placeholder slot's work is not needed): the patch
embedding, the layers' products and attention over all patch pairs,
forward only, and the trainable projection (x3: forward, data and weight
gradients).
"""

import numpy as np

from benchmark import weights as _w


def spec(part, cfg, settings):
    v = cfg[part["part"]]
    h, p = v["hidden_size"], v["patch_size"]
    pre = "vision_model."
    hf = [(pre + "embeddings.class_embedding", (h,), _w.W_STD, 0.0),
          (pre + "embeddings.patch_embedding.weight", (h, 3, p, p),
           _w.W_STD, 0.0),
          (pre + "embeddings.position_embedding.weight",
           ((v["image_size"] // p) ** 2 + 1, h), _w.W_STD, 0.0)]
    hf += _w.norm(pre + "pre_layrnorm", h) + _w.norm(pre + "post_layernorm", h)
    for i in range(v["num_hidden_layers"]):
        lp = f"{pre}encoder.layers.{i}."
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            hf += _w.linear(lp + "self_attn." + proj, h, h)
        hf += _w.norm(lp + "layer_norm1", h) + _w.norm(lp + "layer_norm2", h)
        hf += _w.linear(lp + "mlp.fc1", v["intermediate_size"], h)
        hf += _w.linear(lp + "mlp.fc2", h, v["intermediate_size"])
    e = _w.lm_width(cfg)
    extra = _w.linear("visual_embeddings", e * settings["n_visual_tokens"], h)
    return {"hf": hf, "extra": extra}


def program_name(name):
    return name


def tokens(v):
    return (v["image_size"] // v["patch_size"]) ** 2 + 1


def flops(part, cfg, settings, mb):
    v = cfg[part["part"]]
    h, ffn, layers = v["hidden_size"], v["intermediate_size"], \
        v["num_hidden_layers"]
    p = v["patch_size"]
    s = tokens(v)
    n = int(np.asarray(mb["images_valid"]).astype(bool).sum())
    e = _w.lm_width(cfg)
    per_image = (2 * (s - 1) * 3 * p * p * h
                 + 2 * s * layers * (4 * h * h + 2 * h * ffn)
                 + layers * 4 * s * s * h)
    projection = 3 * 2 * h * e * settings["n_visual_tokens"]
    return n * (per_image + projection)


def launches(part, cfg, settings, mb):
    """One forward a layer over every image slot of the micro-batch (the
    kernel runs the placeholders too), patches and class token, no mask;
    the tower takes no gradient."""
    v = cfg[part["part"]]
    n = int(np.prod(np.asarray(mb["images_valid"]).shape))
    s = tokens(v)
    heads = v["num_attention_heads"]
    shape = dict(n=n, sq=s, sk=s, heads=heads,
                 head_dim=v["hidden_size"] // heads, pairs=float(n * s * s))
    return [dict(kernel="attn_fwd", **shape)] * v["num_hidden_layers"]
