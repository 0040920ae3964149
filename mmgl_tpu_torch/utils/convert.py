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
``relpos_bias``, ``final_layer_norm``) maps by the same rules, and so do the
embedding mode's modules: the Roberta tower ``text_model``
(``embeddings.{word,position,token_type}_embeddings``, ``layer_norm``,
``encoder.layers_i.{attention.{query,key,value,out},attention_norm,
intermediate,output,output_norm}``), ``text_pooler/dense``,
``text_embeddings``, the position tables ``text_position_embeddings`` and
``visual_position_embeddings``, ``lpe_embeddings`` and the GCN's bias-free
``gnn/w1`` and ``gnn/w2``.

PEFT and MPT, each leaf in the flax orientation, untransposed:

  * ``q_proj/lora_a`` (in, r) and ``lora_b`` (r, out) -> ``q_proj.lora_a``
    and ``q_proj.lora_b`` (also on ``v_proj``; y += x @ A @ B * alpha / r);
  * ``decoder/neighbor_layers_i/...`` (MPT's cross layers) ->
    ``decoder.neighbor_layers.i...``, by the rules above, and their scalar
    flamingo gates ``gating1``/``gating2`` -> ``gating1``/``gating2``;
  * ``prefix_tuning/kv`` (layers, 2, P, heads, head_dim) ->
    ``prefix_tuning.kv``;
  * ``prompt_tuning/embedding`` (P, dim) -> ``prompt_tuning.weight``.

A module not in ``COVERED`` or a leaf without a rule raises.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

COVERED = ("lm", "visual_model", "visual_embeddings", "text_model",
           "text_pooler", "text_embeddings", "text_position_embeddings",
           "visual_position_embeddings", "lpe_embeddings", "gnn",
           "prefix_tuning", "prompt_tuning")
# leaves that keep their name and their orientation
_KEPT = ("bias", "class_embedding", "lora_a", "lora_b", "gating1", "gating2",
         "kv")
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
        if m and m.group(1) in ("layers", "neighbor_layers"):
            parts.extend([m.group(1), m.group(2)])
        else:
            parts.append(part)
    leaf = path[-1]
    if leaf == "kernel":
        return ".".join(parts + ["weight"]), True
    if leaf in ("embedding", "scale", "weight"):
        return ".".join(parts + ["weight"]), False
    if leaf in _KEPT:
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
