"""The trainable set (counterpart of mmgl_tpu/peft/masks.py:22-74).

Only ``peft_type=none`` is ported, with and without ``--freeze_lm``: the
frozen towers never train, the LM (OPT or T5, all under ``lm``) trains
unless ``--freeze_lm``, and the fusion-side modules (``visual_embeddings``)
always train. The rule reads the
port's dotted parameter names, which mirror the flax paths
(``lm.decoder.layers.0.fc1.weight`` for ``lm/decoder/layers_0/fc1/kernel``).
It is restated here because the JAX package's module imports flax. Where the
JAX package masks the optimizer (``optax.masked``), the port sets
``requires_grad``: frozen parameters get no gradient, no optimizer state and
no weight decay (train/optim.py).
"""

from __future__ import annotations

from typing import Dict

from torch import nn

TOWERS = ("text_model", "visual_model")
LM_ROOTS = ("lm", "decoder", "encoder", "shared", "lm_head")


def _path_trainable(name: str, peft_type: str = "none",
                    freeze_lm: bool = False) -> bool:
    """Trainability of one parameter by its dotted name."""
    if peft_type != "none":
        raise NotImplementedError(f"peft_type={peft_type!r} is not ported yet")
    root = name.split(".", 1)[0]
    if root in TOWERS:
        return False
    return not (freeze_lm and root in LM_ROOTS)


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
