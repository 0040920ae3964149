"""OPT as the benchmark counts it: its weights in Hugging Face's layout,
its model FLOPs, its attention launches, and the program's names of its
trainable leaves.

Weights: ``model.decoder.*`` as a released checkpoint holds them, and
LoRA's ``lora_a`` (in, r) and ``lora_b`` (r, out) on the q and v
projections under the projection's name (``extra``: no checkpoint holds
them), B drawn non-zero as in a run past its first updates.

Model FLOPs of a micro-batch, over the positions the LM's mask keeps (the
valid tokens, and in the embedding mode the valid soft tokens; pads count
nothing): the layers' products, project_in/out where the embeddings are
narrower, LoRA's, the tied head over the positions whose next token is a
label, and attention over the valid queries' allowed keys. A forward
product is 2 FLOPs a multiply-add; training adds the data gradient (x2)
and, where the weights train, their gradient (x3 in all); the frozen LM's
products count x2, its adapters' x3. Attention counts 4 D a pair forward
and 8 D backward.
"""

import math

import numpy as np

from benchmark import weights as _w
from benchmark import work as _work

IGNORE = -100


def spec(part, cfg, settings):
    m = cfg[part["part"]]
    h, e = m["hidden_size"], m.get("word_embed_proj_dim") or m["hidden_size"]
    pre = "model.decoder."
    hf = [(pre + "embed_tokens.weight", (m["vocab_size"], e), _w.W_STD, 0.0),
          (pre + "embed_positions.weight",
           (m["max_position_embeddings"] + 2, h), _w.W_STD, 0.0)]
    if e != h:
        hf += _w.linear(pre + "project_in", h, e, bias=False)
        hf += _w.linear(pre + "project_out", e, h, bias=False)
    if m["do_layer_norm_before"]:
        hf += _w.norm(pre + "final_layer_norm", h)
    for i in range(m["num_hidden_layers"]):
        lp = f"{pre}layers.{i}."
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            hf += _w.linear(lp + "self_attn." + proj, h, h)
        hf += _w.norm(lp + "self_attn_layer_norm", h)
        hf += _w.linear(lp + "fc1", m["ffn_dim"], h)
        hf += _w.linear(lp + "fc2", h, m["ffn_dim"])
        hf += _w.norm(lp + "final_layer_norm", h)
    extra = []
    r = lora_r(settings)
    for i in range(m["num_hidden_layers"] if r else 0):
        for proj in ("q_proj", "v_proj"):
            lp = f"{pre}layers.{i}.self_attn.{proj}."
            extra += [(lp + "lora_a", (h, r), 1.0 / math.sqrt(h), 0.0),
                      (lp + "lora_b", (r, h), _w.W_STD, 0.0)]
    return {"hf": hf, "extra": extra}


def program_name(name):
    """The training loop's name of a leaf: the LM's under ``lm.``."""
    return "lm." + name[len("model."):]


def lora_r(settings):
    return settings.get("lora_r", 0) if settings.get(
        "peft_type") == "lora" else 0


def lm_mask(mb, settings):
    """The LM's key mask: the batch's, and in the embedding mode the soft
    tokens' appended after it (one slot a neighbour's token, valid where
    the neighbour is)."""
    mask = np.asarray(mb["attention_mask"])
    if settings["neighbor_mode"] == "embedding":
        soft = np.repeat(np.asarray(mb["neighbor_pos_ids"]) > 0,
                         settings["n_text_tokens"], axis=1)
        mask = np.concatenate([mask, soft.astype(mask.dtype)], axis=1)
    return mask


def labelled(mb):
    """Positions whose next token is a label: the batch's labels without
    the image slots the raw context splices in."""
    labels = np.array(mb["labels"], copy=True)
    if "image_positions" in mb:
        pos = np.asarray(mb["image_positions"])
        rows = np.broadcast_to(np.arange(pos.shape[0])[:, None], pos.shape)
        keep = pos < labels.shape[1]
        labels[rows[keep], pos[keep]] = IGNORE
    return int((labels[:, 1:] >= 0).sum())


def flops(part, cfg, settings, mb):
    m = cfg[part["part"]]
    h, ffn, layers = m["hidden_size"], m["ffn_dim"], m["num_hidden_layers"]
    e = m.get("word_embed_proj_dim") or h
    mask = lm_mask(mb, settings)
    tokens = int(mask.sum())
    base = layers * (4 * h * h + 2 * h * ffn) + (2 * e * h if e != h else 0)
    lora = layers * 2 * 2 * h * lora_r(settings)
    weights = 3 if part["trains"] else 2
    out = 2 * tokens * (base * weights + lora * 3)
    out += 2 * labelled(mb) * m["vocab_size"] * e * weights
    pairs = _work.allowed_pairs(mask, True, valid_queries=True)
    return out + layers * pairs * m["num_attention_heads"] * (
        h // m["num_attention_heads"]) * (4 + 8)


def launches(part, cfg, settings, mb):
    """One causal self-attention forward and backward a layer over the
    LM's mask, every query row (the kernels compute pads too)."""
    m = cfg[part["part"]]
    mask = lm_mask(mb, settings)
    heads = m["num_attention_heads"]
    shape = dict(n=mask.shape[0], sq=mask.shape[1], sk=mask.shape[1],
                 heads=heads, head_dim=m["hidden_size"] // heads,
                 pairs=_work.allowed_pairs(mask, True))
    return [dict(kernel=k, **shape) for k in ("attn_fwd", "attn_bwd")
            for _ in range(m["num_hidden_layers"])]


def embed_width(m):
    """The width of the tied token table, which the soft tokens take."""
    return m.get("word_embed_proj_dim") or m["hidden_size"]
