"""OPT in plain PyTorch: pre-LN, and post-LN with ``project_in`` and
``project_out`` as OPT-350M, LoRA on the q and v projections, the tied
head and the causal CE. Written from Hugging Face's OPT and the MMGL
paper's fusion; it imports nothing of the program. Weights under Hugging
Face's names (``model.decoder.*``), LoRA's beside its projection's."""

import torch
import torch.nn.functional as F

from benchmark.reference.model import Precision, attention, dropout, layer_norm

_ATTN = ("q_proj", "k_proj", "v_proj", "out_proj")


def embed(p, ids):
    return p["model.decoder.embed_tokens.weight"][ids]


def hidden(p, m, inputs_embeds, mask, prec: Precision, generator=None,
           lora_scale: float = 0.0):
    """The decoder's last states, in the tied table's width."""
    pre_ln = m["do_layer_norm_before"]
    rate = m["dropout"]
    x = inputs_embeds
    if "model.decoder.project_in.weight" in p:
        x = prec.linear(x, p["model.decoder.project_in.weight"])
    positions = torch.cumsum(mask.long(), dim=1) * mask.long() - 1
    x = x + p["model.decoder.embed_positions.weight"][positions + 2]
    x = dropout(x, rate, generator)
    for i in range(m["num_hidden_layers"]):
        pre = f"model.decoder.layers.{i}."
        res = x
        if pre_ln:
            x = layer_norm(x, p[pre + "self_attn_layer_norm.weight"],
                           p[pre + "self_attn_layer_norm.bias"])
        x = attention(x, p, [pre + "self_attn." + n for n in _ATTN],
                      m["num_attention_heads"], mask, True, prec,
                      lora_scale=lora_scale)
        x = res + dropout(x, rate, generator)
        if not pre_ln:
            x = layer_norm(x, p[pre + "self_attn_layer_norm.weight"],
                           p[pre + "self_attn_layer_norm.bias"])
        res = x
        if pre_ln:
            x = layer_norm(x, p[pre + "final_layer_norm.weight"],
                           p[pre + "final_layer_norm.bias"])
        x = F.relu(prec.linear(x, p[pre + "fc1.weight"], p[pre + "fc1.bias"]))
        x = prec.linear(x, p[pre + "fc2.weight"], p[pre + "fc2.bias"])
        x = res + dropout(x, rate, generator)
        if not pre_ln:
            x = layer_norm(x, p[pre + "final_layer_norm.weight"],
                           p[pre + "final_layer_norm.bias"])
    if "model.decoder.final_layer_norm.weight" in p:
        x = layer_norm(x, p["model.decoder.final_layer_norm.weight"],
                       p["model.decoder.final_layer_norm.bias"])
    if "model.decoder.project_out.weight" in p:
        x = prec.linear(x, p["model.decoder.project_out.weight"])
    return x


def losses(p, cfg, settings, batch, prec: Precision, generator, fuse):
    """(lm loss, summary loss) of one micro-batch: the mean CE of
    logits[:, :-1] against labels[:, 1:] over the labels >= 0, and over
    the summary span without pads. ``fuse(embeds)`` gives the fused
    (inputs_embeds, attention_mask, labels)."""
    ids = batch["input_ids"].long()
    embeds, mask, labels = fuse(embed(p, ids.clamp(min=0)))
    r = settings.get("lora_r", 0) if settings.get(
        "peft_type") == "lora" else 0
    scale = settings["lora_alpha"] / r if r else 0.0
    h = hidden(p, cfg["model"], embeds, mask, prec, generator,
               lora_scale=scale)
    logits = prec.linear(h[:, :-1], p["model.decoder.embed_tokens.weight"])
    target = labels[:, 1:]
    valid = target >= 0
    ce = F.cross_entropy(logits.flatten(0, 1), target.clamp(min=0).flatten(),
                         reduction="none").view(target.shape)
    ce = torch.where(valid, ce, torch.zeros_like(ce))
    pos = torch.arange(target.shape[1], device=ce.device)[None, :]
    span = valid & (pos >= settings["max_input_length"]) & (target != 0)
    loss = ce.sum() / valid.sum().clamp(min=1)
    s_loss = (ce * span).sum() / span.sum().clamp(min=1)
    return loss, s_loss
