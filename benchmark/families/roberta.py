"""The frozen Roberta text tower as the benchmark counts it: its weights
in Hugging Face's layout (``embeddings.*``, ``encoder.layer.*``) and the
fusion block's first-token pooler and projection to soft tokens
(``text_pooler.dense``, ``text_embeddings``, ``extra``), its model
FLOPs, and its attention launches.

Model FLOPs of a micro-batch, over each neighbour text's valid tokens
only (an empty slot's work is not needed): the layers' products and
attention over the valid tokens' pairs, forward only; the pooler
(forward) and the trainable projection (x3) over the texts that have a
token.
"""

import numpy as np

from benchmark import weights as _w
from benchmark import work as _work


def spec(part, cfg, settings):
    t = cfg[part["part"]]
    h = t["hidden_size"]
    hf = [("embeddings.word_embeddings.weight", (t["vocab_size"], h),
           _w.W_STD, 0.0),
          ("embeddings.position_embeddings.weight",
           (t["max_position_embeddings"], h), _w.W_STD, 0.0),
          ("embeddings.token_type_embeddings.weight",
           (t["type_vocab_size"], h), _w.W_STD, 0.0)]
    hf += _w.norm("embeddings.LayerNorm", h)
    for i in range(t["num_hidden_layers"]):
        lp = f"encoder.layer.{i}."
        for proj in ("query", "key", "value"):
            hf += _w.linear(lp + "attention.self." + proj, h, h)
        hf += _w.linear(lp + "attention.output.dense", h, h)
        hf += _w.norm(lp + "attention.output.LayerNorm", h)
        hf += _w.linear(lp + "intermediate.dense", t["intermediate_size"], h)
        hf += _w.linear(lp + "output.dense", h, t["intermediate_size"])
        hf += _w.norm(lp + "output.LayerNorm", h)
    e = _w.lm_width(cfg)
    extra = (_w.linear("text_pooler.dense", h, h)
             + _w.linear("text_embeddings", e * settings["n_text_tokens"], h))
    return {"hf": hf, "extra": extra}


def program_name(name):
    return name


def text_masks(mb):
    mask = np.asarray(mb["neighbor_attention_mask"])
    return mask.reshape(-1, mask.shape[-1])


def flops(part, cfg, settings, mb):
    t = cfg[part["part"]]
    h, ffn, layers = t["hidden_size"], t["intermediate_size"], \
        t["num_hidden_layers"]
    mask = text_masks(mb)
    tokens = int(mask.astype(bool).sum())
    texts = int(mask.astype(bool).any(axis=1).sum())
    pairs = _work.allowed_pairs(mask, False, valid_queries=True)
    e = _w.lm_width(cfg)
    out = 2 * tokens * layers * (4 * h * h + 2 * h * ffn)
    out += layers * 4 * pairs * h
    return out + texts * (2 * h * h + 3 * 2 * h * e * settings["n_text_tokens"])


def launches(part, cfg, settings, mb):
    """One forward a layer over every neighbour text of the micro-batch
    under its key mask (every query row; an empty text attends to all its
    slots); the tower takes no gradient."""
    t = cfg[part["part"]]
    mask = text_masks(mb)
    heads = t["num_attention_heads"]
    shape = dict(n=mask.shape[0], sq=mask.shape[1], sk=mask.shape[1],
                 heads=heads, head_dim=t["hidden_size"] // heads,
                 pairs=_work.allowed_pairs(mask, False))
    return [dict(kernel="attn_fwd", **shape)] * t["num_hidden_layers"]
