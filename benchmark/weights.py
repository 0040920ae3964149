"""Seeded weights in Hugging Face's layout, made on the device.

One ``torch.randn`` of every tensor's elements together, in bfloat16 (the
precision a released checkpoint of these models is served in), from a
generator on the run's device seeded from ``--seed``; each tensor is a view
of that buffer, scaled in place to its spread. The same (configuration,
seed, device) give the same values. The program loads them through its own
importer; the reference reads them as they are.

By part of the configuration (``parts``: the LM under ``model``, a tower
under ``vision`` or ``text``), two groups, each laid out by the part's
family file (``benchmark/families/<family>.py``, ``spec``): ``hf``, the
tensors a Hugging Face checkpoint of the family holds, under its names,
and ``extra``, what no checkpoint holds (the fusion block's layers, LoRA's
adapters), under names of their own.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark import work

Spec = List[Tuple[str, Tuple[int, ...], float, float]]  # name, shape, std, mean

W_STD, B_STD, LN_STD = 0.02, 0.01, 0.02


def linear(name: str, out: int, inp: int, bias: bool = True) -> Spec:
    spec = [(f"{name}.weight", (out, inp), W_STD, 0.0)]
    if bias:
        spec.append((f"{name}.bias", (out,), B_STD, 0.0))
    return spec


def norm(name: str, dim: int) -> Spec:
    return [(f"{name}.weight", (dim,), LN_STD, 1.0),
            (f"{name}.bias", (dim,), B_STD, 0.0)]


def family(part: Dict):
    """The family file of a configuration's part."""
    return work.load("families", part["family"])


def lm_part(cfg: Dict) -> Dict:
    return next(p for p in cfg["parts"] if p["part"] == "model")


def lm_width(cfg: Dict) -> int:
    """The width of the LM's token table, which soft tokens take."""
    return family(lm_part(cfg)).embed_width(cfg["model"])


def specs(cfg: Dict, settings: Dict) -> Dict[Tuple[str, str], Spec]:
    """{(part, group): spec} of every part of the configuration."""
    out = {}
    for part in cfg["parts"]:
        for group, spec in family(part).spec(part, cfg, settings).items():
            out[(part["part"], group)] = spec
    return out


def weight_seed(seed: int) -> int:
    """The weights' own stream of the run's seed."""
    return int(np.random.SeedSequence([seed, 1]).generate_state(
        1, np.uint64)[0] >> 1)


@torch.no_grad()
def make_weights(cfg: Dict, settings: Dict, seed: int, device: torch.device
                 ) -> Dict[Tuple[str, str], Dict[str, torch.Tensor]]:
    """{(part, group): {name: bfloat16 tensor on ``device``}}, every tensor
    a view of one buffer drawn in a single call."""
    groups = specs(cfg, settings)
    total = sum(math.prod(shape) for spec in groups.values()
                for _, shape, _, _ in spec)
    gen = torch.Generator(device=device).manual_seed(weight_seed(seed))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.bfloat16)
    out, offset = {}, 0
    for group, spec in groups.items():
        out[group] = {}
        for name, shape, std, mean in spec:
            n = math.prod(shape)
            t = flat[offset:offset + n].view(shape).mul_(std)
            if mean:
                t.add_(mean)
            out[group][name] = t
            offset += n
    return out
