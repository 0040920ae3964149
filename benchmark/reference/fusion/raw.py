"""The raw context's fusion: each image slot's pooled CLIP output,
projected by ``visual_embeddings`` to ``n_visual_tokens`` soft tokens,
written over the prompt at the slot's positions (a spare slot's aim one
past the sequence drops it), whose labels are then ignored."""

import torch

from benchmark.reference.model import IGNORE


def fuse(p, settings, batch, prec, embeds, pooled):
    mask, labels = batch["attention_mask"], batch["labels"].long()
    b, s = labels.shape
    n_img = batch["images"].shape[1]
    vis = prec.linear(pooled["vision"], p["visual_embeddings.weight"],
                      p["visual_embeddings.bias"])
    vis = vis.view(b, n_img * settings["n_visual_tokens"], -1)
    pos = batch["image_positions"].long()
    keep = pos < s
    rows = torch.arange(b, device=pos.device)[:, None].expand_as(pos)
    embeds = embeds.index_put((rows[keep], pos[keep]), vis[keep])
    labels = labels.index_put((rows[keep], pos[keep]),
                              torch.full_like(pos[keep], IGNORE))
    return embeds, mask, labels
