"""The trainable set (counterpart of mmgl_tpu/peft/masks.py:22-74).

Every ``peft_type`` (none, lora, prefix, prompt, flamingo), with and
without ``--freeze_lm``, by the JAX package's ``_path_trainable`` rules in
their order, read on the port's dotted parameter names, which mirror the
flax paths (``lm.decoder.layers.0.fc1.weight`` for
``lm/decoder/layers_0/fc1/kernel``):

1. the frozen towers (``text_model``, ``visual_model``) never train;
2. the adapters and virtual tokens always train, inside the LM too: LoRA's
   ``lora_a``/``lora_b``, ``prefix_tuning``, ``prompt_tuning`` and MPT's
   cross layers (``lm.decoder.neighbor_layers.i``, with their flamingo
   gates);
3. under ``lora`` the rest of the LM trains only where a name holds
   ``lm_head`` (OPT and T5 tie their heads, so none does: the LM is frozen
   but for the adapters);
4. under ``prefix``, ``prompt`` and ``flamingo`` the rest of the LM is
   frozen;
5. under ``none`` the LM trains unless ``--freeze_lm``.

The fusion-side modules (``visual_embeddings``; in the embedding mode
``text_pooler``, ``text_embeddings``, the neighbour position tables,
``lpe_embeddings`` and ``gnn``) train under every type. The rules are
restated here because the JAX package's module imports flax. Where the JAX
package masks the optimizer (``optax.masked``), the port sets
``requires_grad``: frozen parameters get no gradient, no optimizer state
and no weight decay (train/optim.py).
"""

from __future__ import annotations

from typing import Dict

from torch import nn

TOWERS = ("text_model", "visual_model")
LM_ROOTS = ("lm", "decoder", "encoder", "shared", "lm_head")
PEFT_TYPES = ("none", "lora", "prefix", "prompt", "flamingo")
# names that train under every peft_type (rule 2)
ADAPTERS = ("lora_a", "lora_b", "prefix_tuning", "prompt_tuning",
            "neighbor_layers.")


def _path_trainable(name: str, peft_type: str = "none",
                    freeze_lm: bool = False) -> bool:
    """Trainability of one parameter by its dotted name."""
    if peft_type not in PEFT_TYPES:
        raise ValueError(f"unknown peft_type {peft_type!r}")
    root = name.split(".", 1)[0]
    if root in TOWERS:
        return False
    if any(a in name for a in ADAPTERS):
        return True
    is_lm = root in LM_ROOTS
    if peft_type == "lora":
        return "lm_head" in name if is_lm else True
    if peft_type in ("prefix", "prompt", "flamingo"):
        return not is_lm
    return not (freeze_lm and is_lm)


def apply_trainable_mask(model: nn.Module, peft_type: str = "none",
                         freeze_lm: bool = False) -> None:
    for name, p in model.named_parameters():
        p.requires_grad_(_path_trainable(name, peft_type, freeze_lm))


def count_params(model: nn.Module) -> Dict[str, int]:
    """{'trainable', 'non_trainable', 'total'} element counts, trainable by
    ``requires_grad`` (``count_params`` of the JAX package)."""
    total = trainable = 0
    for p in model.parameters():
        total += p.numel()
        trainable += p.numel() if p.requires_grad else 0
    return {"trainable": trainable, "non_trainable": total - trainable,
            "total": total}
