"""Plain PyTorch pieces of the benchmark's reference, in float32, and the
forward of one micro-batch assembled from files found by name.

A configuration's parts (``parts``: the LM under ``model``, towers under
``vision`` or ``text``) each name a family; ``reference/families/
<family>.py`` holds its forward (an LM's ``losses``, a tower's
``pooled``), and ``reference/fusion/<neighbor_mode>.py`` how the towers'
outputs enter the LM. They import nothing of the program.

Weights are a flat dict of tensors under Hugging Face's names plus the
fusion block and the adapters under their own names (``extra``).
``Precision`` decides how each product's operands are rounded: not at all
(float32, TF32 off), or to float8 e4m3 with one scale a tensor (the
control). Dropout draws its masks from the generator it is given, one
``torch.rand`` of the activation's shape a site, in the order the sites
run.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark import work

IGNORE = -100


@dataclass(frozen=True)
class Precision:
    """How a product's operands are rounded: ``fp8`` to float8 e4m3 with a
    per-tensor scale (amax / 448), the gradient passed straight through."""
    fp8: bool = False

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return x
        scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
        rounded = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (rounded - x.detach())

    def linear(self, x, w, b=None):
        y = self.q(x) @ self.q(w).T
        return y if b is None else y + b

    def matmul(self, a, b):
        return self.q(a) @ self.q(b)


def layer_norm(x, w, b, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def dropout(x, rate: float, generator: Optional[torch.Generator]):
    if rate == 0.0 or generator is None:
        return x
    keep = torch.rand(list(x.shape), generator=generator,
                      device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _attention_core(q, k, v, key_mask, causal: bool, prec: Precision):
    """q, k, v (B, H, S, D) -> (B, H, S, D): softmax(q k^T / sqrt(D))
    over the keys that ``key_mask`` (B, S) and the causal order leave; a
    row with no key left attends uniformly."""
    d = q.shape[-1]
    logits = prec.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)
    allowed = key_mask.bool()[:, None, None, :]
    if causal:
        s = q.shape[2]
        allowed = allowed & torch.ones(s, s, dtype=torch.bool,
                                       device=q.device).tril()
    logits = logits.masked_fill(~allowed, -1e30)
    return prec.matmul(torch.softmax(logits, dim=-1), v)


def attention(x, p: Dict, names, heads: int, key_mask, causal: bool,
              prec: Precision, lora_scale: float = 0.0):
    """Multi-head self-attention of the q, k, v and output projections
    named in ``names``; LoRA (``lora_a`` (in, r), ``lora_b`` (r, out)) on
    any projection that has it. The softmax is recomputed in the backward
    to bound memory."""
    b, s, e = x.shape
    d = e // heads

    def proj(name):
        y = prec.linear(x, p[f"{name}.weight"], p[f"{name}.bias"])
        a = p.get(f"{name}.lora_a")
        if a is not None:
            y = y + prec.matmul(prec.matmul(x, a),
                                p[f"{name}.lora_b"]) * lora_scale
        return y.view(b, s, heads, d).transpose(1, 2)

    q, k, v = (proj(n) for n in names[:3])
    if torch.is_grad_enabled():
        out = checkpoint(_attention_core, q, k, v, key_mask, causal, prec,
                         use_reentrant=False)
    else:
        out = _attention_core(q, k, v, key_mask, causal, prec)
    out = out.transpose(1, 2).reshape(b, s, e)
    return prec.linear(out, p[f"{names[3]}.weight"], p[f"{names[3]}.bias"])


def losses(p: Dict, cfg: Dict, settings: Dict, batch: Dict, prec: Precision,
           generator):
    """(lm loss, summary loss, {tower part: pooled output}) of one
    micro-batch of tensors on the device; the towers run without
    gradients."""
    pooled = {}
    lm = None
    for part in cfg["parts"]:
        family = work.load("reference/families", part["family"])
        if part["part"] == "model":
            lm = family
            continue
        with torch.no_grad():
            pooled[part["part"]] = family.pooled(p, cfg, part, settings,
                                                 batch, prec)
    fusion = work.load("reference/fusion", settings["neighbor_mode"])
    loss, s_loss = lm.losses(
        p, cfg, settings, batch, prec, generator,
        lambda embeds: fusion.fuse(p, settings, batch, prec, embeds, pooled))
    return loss, s_loss, pooled
