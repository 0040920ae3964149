"""The embedding mode's fusion: each neighbour text's pooled output,
projected by ``text_embeddings`` to ``n_text_tokens`` soft tokens,
appended after the sequence, valid where the neighbour is, with no
labels."""

import torch

from benchmark.reference.model import IGNORE


def fuse(p, settings, batch, prec, embeds, pooled):
    mask, labels = batch["attention_mask"], batch["labels"].long()
    b = labels.shape[0]
    n = batch["neighbor_input_ids"].shape[1]
    k = settings["n_text_tokens"]
    soft = prec.linear(pooled["text"], p["text_embeddings.weight"],
                       p["text_embeddings.bias"])
    soft = soft.view(b, n * k, -1)
    soft_mask = torch.repeat_interleave(batch["neighbor_pos_ids"] > 0, k,
                                        dim=1)
    embeds = torch.cat([embeds, soft], dim=1)
    mask = torch.cat([mask, soft_mask.to(mask.dtype)], dim=1)
    labels = torch.cat([labels, torch.full_like(soft_mask, IGNORE,
                                                dtype=labels.dtype)], dim=1)
    return embeds, mask, labels
