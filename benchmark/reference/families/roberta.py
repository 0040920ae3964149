"""Roberta in plain PyTorch with the fusion block's first-token pooler:
tanh(dense(h[:, 0])) of each neighbour text under its key mask, positions
counted from Roberta's padding index 1. Weights under Hugging Face's
names (``embeddings.*``, ``encoder.layer.*``), the pooler under
``text_pooler.dense``."""

import torch
import torch.nn.functional as F

from benchmark.reference.model import Precision, attention, layer_norm


def pooled(p, cfg, part, settings, batch, prec: Precision):
    t = cfg[part["part"]]
    ids = batch["neighbor_input_ids"].flatten(0, 1)
    mask = batch["neighbor_attention_mask"].flatten(0, 1)
    m = mask.long()
    positions = torch.cumsum(m, dim=1) * m + 1
    h = (p["embeddings.word_embeddings.weight"][ids.long()]
         + p["embeddings.position_embeddings.weight"][positions]
         + p["embeddings.token_type_embeddings.weight"][0])
    h = layer_norm(h, p["embeddings.LayerNorm.weight"],
                   p["embeddings.LayerNorm.bias"])
    for i in range(t["num_hidden_layers"]):
        lp = f"encoder.layer.{i}."
        a = attention(h, p, [lp + "attention.self.query",
                             lp + "attention.self.key",
                             lp + "attention.self.value",
                             lp + "attention.output.dense"],
                      t["num_attention_heads"], mask, False, prec)
        h = layer_norm(h + a, p[lp + "attention.output.LayerNorm.weight"],
                       p[lp + "attention.output.LayerNorm.bias"])
        f = F.gelu(prec.linear(h, p[lp + "intermediate.dense.weight"],
                               p[lp + "intermediate.dense.bias"]))
        f = prec.linear(f, p[lp + "output.dense.weight"],
                        p[lp + "output.dense.bias"])
        h = layer_norm(h + f, p[lp + "output.LayerNorm.weight"],
                       p[lp + "output.LayerNorm.bias"])
    return torch.tanh(prec.linear(h[:, 0], p["text_pooler.dense.weight"],
                                  p["text_pooler.dense.bias"]))
