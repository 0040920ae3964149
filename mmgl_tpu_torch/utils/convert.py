"""JAX parameter tree -> the port's state dict.

The input is the flax ``params`` tree of mmgl_tpu's MMGLModel after
``jax.device_get``: a nested dict of numpy arrays. The output is a
``state_dict`` for mmgl_tpu_torch's MMGLModel, whose modules carry the flax
path names, so the map is mechanical:

  * ``layers_3``           -> ``layers.3``   (flax list names)
  * ``q_proj/dense/...``   -> ``q_proj.*``   (LoRADense nests its Dense)
  * Dense ``kernel`` (in, out) -> Linear ``weight`` (out, in), transposed
  * Embed ``embedding``    -> Embedding ``weight``
  * LayerNorm ``scale``    -> LayerNorm ``weight``; ``bias`` stays
  * RMSNorm ``weight``     -> RMSNorm ``weight`` (T5)

CLIP's patch embedding is a Dense over flattened (p, p, 3) patches on both
sides, so it is a transpose too, as are OPT-350M's bias-free
``decoder/project_in/kernel`` (512 -> 1024) and ``project_out/kernel``. The T5 ``lm`` tree (``shared``,
``encoder``/``decoder.layers_i.{self_attn,cross_attn,ffn,*_norm}``,
``relpos_bias``, ``final_layer_norm``) maps by the same rules. Only ``lm``, ``visual_model`` and
``visual_embeddings`` are covered; anything else raises.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

COVERED = ("lm", "visual_model", "visual_embeddings")
_LORA_HOSTS = ("q_proj", "v_proj")


def _leaves(tree, prefix=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def _torch_name(path: Tuple[str, ...]) -> Tuple[str, bool]:
    """(dotted torch name, transpose?) for one flax leaf path."""
    parts = []
    for i, part in enumerate(path[:-1]):
        if part == "dense" and i > 0 and path[i - 1] in _LORA_HOSTS:
            continue
        m = re.fullmatch(r"(\w+)_(\d+)", part)
        if m and m.group(1) == "layers":
            parts.extend([m.group(1), m.group(2)])
        else:
            parts.append(part)
    leaf = path[-1]
    if leaf == "kernel":
        return ".".join(parts + ["weight"]), True
    if leaf in ("embedding", "scale", "weight"):
        return ".".join(parts + ["weight"]), False
    if leaf in ("bias", "class_embedding"):
        return ".".join(parts + [leaf]), False
    raise KeyError(f"no conversion for flax leaf {'/'.join(path)}")


def state_dict_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """flax params (nested numpy dict) -> mmgl_tpu_torch MMGLModel state
    dict (fp32 tensors on the CPU)."""
    extra = set(params) - set(COVERED)
    if extra:
        raise KeyError(f"no conversion for flax modules {sorted(extra)}")
    out = {}
    for path, value in _leaves(params):
        name, transpose = _torch_name(path)
        arr = value.T if transpose else value
        out[name] = torch.from_numpy(np.array(arr, np.float32))  # a copy
    return out
