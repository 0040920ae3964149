"""HF checkpoint -> flax-layout parameter tree (counterpart of
mmgl_tpu/utils/hf_import.py).

Reads a local Hugging Face checkpoint directory (``model.safetensors`` or
``pytorch_model.bin``) into ``{name: np.ndarray}`` and maps its names onto
the JAX package's flax parameter paths, returning the same nested numpy
tree the JAX importers return. ``utils/convert.state_dict_from_jax`` then
turns that tree into the port's state dict, so the one map from flax
paths to the port's parameters serves pretrained weights as it serves the
JAX package's trees (``models/factory.maybe_import_pretrained``).

``model.safetensors`` is read by a small reader of the format (an 8-byte
little-endian header length, a JSON header of dtype, shape and byte
offsets, then the little-endian buffers), so neither ``safetensors`` nor
``transformers`` is needed; it takes the dtypes ``safetensors.numpy``
takes. ``pytorch_model.bin`` is read with ``torch.load(weights_only=True)``.
numpy has no bfloat16 of its own (the JAX package reads one through
``ml_dtypes``, which jax installs into numpy), so a bfloat16 tensor of
either file comes back as float32, which holds it exactly.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict

import numpy as np
import torch

# safetensors dtype names -> numpy (safetensors.numpy's table)
_SAFETENSORS_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "U64": np.uint64, "I32": np.int32, "U32": np.uint32,
    "I16": np.int16, "U16": np.uint16, "I8": np.int8, "U8": np.uint8,
    "BOOL": np.bool_, "C64": np.complex64,
}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """{name: array} of a ``.safetensors`` file, each array a read-only
    view of the file's bytes in its stored dtype."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 8:
        raise ValueError(f"{path}: not a safetensors file")
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n])
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        kind = info["dtype"]
        if kind not in _SAFETENSORS_DTYPES and kind != "BF16":
            raise ValueError(f"{path}: tensor {name} has dtype {kind}, "
                             "which the reader does not take "
                             f"({sorted(_SAFETENSORS_DTYPES) + ['BF16']})")
        # bfloat16 read as its upper half of a little-endian float32
        dtype = np.dtype("<u2" if kind == "BF16"
                         else _SAFETENSORS_DTYPES[kind]).newbyteorder("<")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        if end - begin != int(np.prod(shape, dtype=np.int64)) * dtype.itemsize:
            raise ValueError(f"{path}: tensor {name} has {end - begin} bytes "
                             f"for shape {shape} of {kind}")
        arr = np.frombuffer(data, dtype=dtype,
                            count=(end - begin) // dtype.itemsize,
                            offset=base + begin).reshape(shape)
        if kind == "BF16":
            arr = (arr.astype("<u4") << 16).view("<f4")
        out[name] = arr
    return out


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Read a local HF checkpoint dir into {name: np.ndarray}."""
    safep = os.path.join(path, "model.safetensors")
    binp = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(safep):
        return read_safetensors(safep)
    if os.path.exists(binp):
        sd = torch.load(binp, map_location="cpu", weights_only=True)
        return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
                for k, v in sd.items()}
    raise FileNotFoundError(
        f"no model.safetensors or pytorch_model.bin in {path}")


def _set(tree: dict, path: str, value: np.ndarray):
    keys = path.split("/")
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def torch_state_dict_to_numpy(sd) -> Dict[str, np.ndarray]:
    """fp32 numpy copies (np.array, not a view: ``.float()`` of an fp32
    tensor is the tensor itself, and a view would follow later in-place
    updates of the live parameters)."""
    return {k: np.array(v.detach().cpu().float().numpy())
            for k, v in sd.items()}


def _linear_and_norm(params: dict, sd: Dict[str, np.ndarray]):
    """(linear, layer_norm) writers into ``params``: a Linear's weight
    transposed to a Dense kernel (under ``/dense`` where LoRA nests it),
    its bias if present; a LayerNorm's weight as ``scale``."""
    def linear(src: str, dst: str, nested_dense: bool = False):
        tail = "/dense" if nested_dense else ""
        _set(params, f"{dst}{tail}/kernel", sd[f"{src}.weight"].T)
        if f"{src}.bias" in sd:
            _set(params, f"{dst}{tail}/bias", sd[f"{src}.bias"])

    def layer_norm(src: str, dst: str):
        _set(params, f"{dst}/scale", sd[f"{src}.weight"])
        _set(params, f"{dst}/bias", sd[f"{src}.bias"])

    return linear, layer_norm


def _opt_layer(linear, layer_norm, src: str, dst: str):
    """One OPT decoder layer (or MPT cross layer) of the HF layout."""
    linear(f"{src}.self_attn.q_proj", f"{dst}/self_attn/q_proj",
           nested_dense=True)
    linear(f"{src}.self_attn.v_proj", f"{dst}/self_attn/v_proj",
           nested_dense=True)
    linear(f"{src}.self_attn.k_proj", f"{dst}/self_attn/k_proj")
    linear(f"{src}.self_attn.out_proj", f"{dst}/self_attn/out_proj")
    layer_norm(f"{src}.self_attn_layer_norm", f"{dst}/self_attn_layer_norm")
    layer_norm(f"{src}.final_layer_norm", f"{dst}/final_layer_norm")
    linear(f"{src}.fc1", f"{dst}/fc1")
    linear(f"{src}.fc2", f"{dst}/fc2")


def _n_layers(sd, marker: str) -> int:
    return 1 + max(int(k.split(marker)[1].split(".")[0])
                   for k in sd if marker in k)


# ---------------------------------------------------------------------------
# OPT and MPT
# ---------------------------------------------------------------------------

def import_opt(sd: Dict[str, np.ndarray],
               tie_word_embeddings: bool = True) -> dict:
    """HF OPTForCausalLM state dict -> OPTForCausalLM flax params
    (mmgl_tpu/utils/hf_import.py:55-102); ``project_in``/``project_out``
    where present (OPT-350M)."""
    params: dict = {}
    pre = "model.decoder."
    if not any(k.startswith(pre) for k in sd):
        pre = "decoder." if any(k.startswith("decoder.") for k in sd) else ""
    linear, layer_norm = _linear_and_norm(params, sd)

    _set(params, "decoder/embed_tokens/embedding",
         sd[pre + "embed_tokens.weight"])
    _set(params, "decoder/embed_positions/embedding",
         sd[pre + "embed_positions.weight"])
    if pre + "project_in.weight" in sd:
        linear(pre + "project_in", "decoder/project_in")
        linear(pre + "project_out", "decoder/project_out")
    if pre + "final_layer_norm.weight" in sd:
        layer_norm(pre + "final_layer_norm", "decoder/final_layer_norm")

    n_layers = 1 + max(
        int(k.split(".")[3 if pre == "model.decoder." else 2])
        for k in sd if ".layers." in k
    )
    for i in range(n_layers):
        _opt_layer(linear, layer_norm, f"{pre}layers.{i}",
                   f"decoder/layers_{i}")

    if not tie_word_embeddings and "lm_head.weight" in sd:
        _set(params, "lm_head/kernel", sd["lm_head.weight"].T)
    return params


def import_mpt(sd: Dict[str, np.ndarray],
               tie_word_embeddings: bool = True) -> dict:
    """The reference's MPTForCausalLM state dict -> the cross-attention OPT
    params (mmgl_tpu/utils/hf_import.py:105-149): the base decoder plus the
    interleaved ``neighbor_layers`` and their flamingo gates."""
    base = {k: v for k, v in sd.items() if ".neighbor_layers." not in k}
    params = import_opt(base, tie_word_embeddings=tie_word_embeddings)

    pre = "model.decoder.neighbor_layers."
    if not any(k.startswith(pre) for k in sd):
        pre = "decoder.neighbor_layers."
    idxs = sorted({int(k[len(pre):].split(".")[0])
                   for k in sd if k.startswith(pre)})
    linear, layer_norm = _linear_and_norm(params, sd)
    for i in idxs:
        src = f"{pre}{i}"
        dst = f"decoder/neighbor_layers_{i}"
        _opt_layer(linear, layer_norm, src, dst)
        if f"{src}.gating1" in sd:
            _set(params, f"{dst}/gating1", sd[f"{src}.gating1"])
            _set(params, f"{dst}/gating2", sd[f"{src}.gating2"])
    return params


def import_opt_into_mpt(sd: Dict[str, np.ndarray], mpt_params: dict,
                        tie_word_embeddings: bool = True) -> dict:
    """MPT (OPT + cross layers) initialized from pretrained OPT weights
    (mmgl_tpu/utils/hf_import.py:152-178): a copy of ``mpt_params`` with
    the embeddings, projections, final LN, every self-attention layer (and
    the head) overwritten; the cross layers keep their values."""

    def merge(dst: dict, src: dict) -> dict:
        out = {k: merge(v, {}) if isinstance(v, dict) else v
               for k, v in dst.items()}
        for key, val in src.items():
            out[key] = (merge(out.get(key, {}), val) if isinstance(val, dict)
                        else val)
        return out

    return merge(mpt_params, import_opt(sd,
                                        tie_word_embeddings=tie_word_embeddings))


# ---------------------------------------------------------------------------
# Roberta
# ---------------------------------------------------------------------------

def import_roberta(sd: Dict[str, np.ndarray]) -> dict:
    """HF RobertaModel state dict -> models/roberta.py flax params
    (mmgl_tpu/utils/hf_import.py:181-220)."""
    params: dict = {}
    pre = "roberta." if any(k.startswith("roberta.") for k in sd) else ""
    linear, layer_norm = _linear_and_norm(params, sd)

    emb = pre + "embeddings"
    _set(params, "embeddings/word_embeddings/embedding",
         sd[f"{emb}.word_embeddings.weight"])
    _set(params, "embeddings/position_embeddings/embedding",
         sd[f"{emb}.position_embeddings.weight"])
    _set(params, "embeddings/token_type_embeddings/embedding",
         sd[f"{emb}.token_type_embeddings.weight"])
    layer_norm(f"{emb}.LayerNorm", "embeddings/layer_norm")

    for i in range(_n_layers(sd, "encoder.layer.")):
        src = f"{pre}encoder.layer.{i}"
        dst = f"encoder/layers_{i}"
        linear(f"{src}.attention.self.query", f"{dst}/attention/query")
        linear(f"{src}.attention.self.key", f"{dst}/attention/key")
        linear(f"{src}.attention.self.value", f"{dst}/attention/value")
        linear(f"{src}.attention.output.dense", f"{dst}/attention/out")
        layer_norm(f"{src}.attention.output.LayerNorm",
                   f"{dst}/attention_norm")
        linear(f"{src}.intermediate.dense", f"{dst}/intermediate")
        linear(f"{src}.output.dense", f"{dst}/output")
        layer_norm(f"{src}.output.LayerNorm", f"{dst}/output_norm")
    return params


# ---------------------------------------------------------------------------
# CLIP
# ---------------------------------------------------------------------------

def _clip_encoder(params: dict, sd: Dict[str, np.ndarray], pre: str):
    """The CLIP encoder layers under ``pre`` (vision or text), counted
    among the names under ``pre``: a CLIPModel holds both towers."""
    linear, layer_norm = _linear_and_norm(params, sd)
    tower = [k for k in sd if k.startswith(pre)]
    for i in range(_n_layers(tower, "encoder.layers.")):
        src = f"{pre}encoder.layers.{i}"
        dst = f"encoder/layers_{i}"
        linear(f"{src}.self_attn.q_proj", f"{dst}/attention/query")
        linear(f"{src}.self_attn.k_proj", f"{dst}/attention/key")
        linear(f"{src}.self_attn.v_proj", f"{dst}/attention/value")
        linear(f"{src}.self_attn.out_proj", f"{dst}/attention/out")
        layer_norm(f"{src}.layer_norm1", f"{dst}/norm1")
        layer_norm(f"{src}.layer_norm2", f"{dst}/norm2")
        linear(f"{src}.mlp.fc1", f"{dst}/fc1")
        linear(f"{src}.mlp.fc2", f"{dst}/fc2")


def import_clip_vision(sd: Dict[str, np.ndarray]) -> dict:
    """HF CLIPVisionModel (or CLIPModel) state dict -> models/clip.py vision
    params (mmgl_tpu/utils/hf_import.py:223-264). The patch conv's weight
    (out, in, kh, kw) becomes the flattened-patch Dense kernel
    (kh * kw * in, out), the (p, p, 3) patch order."""
    params: dict = {}
    pre = "vision_model."
    if not any(k.startswith(pre) for k in sd):
        pre = "clip.vision_model." if any(
            k.startswith("clip.vision_model.") for k in sd) else pre
    _, layer_norm = _linear_and_norm(params, sd)

    emb = pre + "embeddings"
    _set(params, "embeddings/class_embedding", sd[f"{emb}.class_embedding"])
    w = sd[f"{emb}.patch_embedding.weight"]
    _set(params, "embeddings/patch_embedding/kernel",
         w.transpose(2, 3, 1, 0).reshape(-1, w.shape[0]))
    _set(params, "embeddings/position_embedding/embedding",
         sd[f"{emb}.position_embedding.weight"])
    layer_norm(pre + "pre_layrnorm", "pre_layernorm")  # HF's typo'd name
    layer_norm(pre + "post_layernorm", "post_layernorm")
    _clip_encoder(params, sd, pre)
    return params


def import_clip_text(sd: Dict[str, np.ndarray]) -> dict:
    """HF CLIPTextModel (or CLIPModel) state dict -> models/clip.py text
    params (mmgl_tpu/utils/hf_import.py:267-304)."""
    params: dict = {}
    pre = "text_model."
    _, layer_norm = _linear_and_norm(params, sd)

    emb = pre + "embeddings"
    _set(params, "embeddings_token/embedding",
         sd[f"{emb}.token_embedding.weight"])
    _set(params, "embeddings_position/embedding",
         sd[f"{emb}.position_embedding.weight"])
    layer_norm(pre + "final_layer_norm", "final_layer_norm")
    _clip_encoder(params, sd, pre)
    return params


# ---------------------------------------------------------------------------
# T5
# ---------------------------------------------------------------------------

def import_t5(sd: Dict[str, np.ndarray]) -> dict:
    """HF T5ForConditionalGeneration state dict -> models/t5.py flax params
    (mmgl_tpu/utils/hf_import.py:307-352)."""
    params: dict = {}

    def linear(src, dst):
        _set(params, f"{dst}/kernel", sd[f"{src}.weight"].T)

    def rms(src, dst):
        _set(params, f"{dst}/weight", sd[f"{src}.weight"])

    _set(params, "shared/embedding", sd["shared.weight"])
    if "lm_head.weight" in sd:
        _set(params, "lm_head/kernel", sd["lm_head.weight"].T)

    for stack in ("encoder", "decoder"):
        rms(f"{stack}.final_layer_norm", f"{stack}/final_layer_norm")
        _set(params, f"{stack}/relpos_bias/embedding",
             sd[f"{stack}.block.0.layer.0.SelfAttention"
                ".relative_attention_bias.weight"])
        n_layers = 1 + max(
            int(k.split(f"{stack}.block.")[1].split(".")[0])
            for k in sd if k.startswith(f"{stack}.block.")
        )
        for i in range(n_layers):
            src = f"{stack}.block.{i}"
            dst = f"{stack}/layers_{i}"
            for proj in ("q", "k", "v", "o"):
                linear(f"{src}.layer.0.SelfAttention.{proj}",
                       f"{dst}/self_attn/{proj}")
            rms(f"{src}.layer.0.layer_norm", f"{dst}/self_attn_norm")
            ff = 1 if stack == "encoder" else 2
            if stack == "decoder":
                for proj in ("q", "k", "v", "o"):
                    linear(f"{src}.layer.1.EncDecAttention.{proj}",
                           f"{dst}/cross_attn/{proj}")
                rms(f"{src}.layer.1.layer_norm", f"{dst}/cross_attn_norm")
            if f"{src}.layer.{ff}.DenseReluDense.wi.weight" in sd:
                linear(f"{src}.layer.{ff}.DenseReluDense.wi", f"{dst}/ffn/wi")
            else:  # gated variant
                for wi in ("wi_0", "wi_1"):
                    linear(f"{src}.layer.{ff}.DenseReluDense.{wi}",
                           f"{dst}/ffn/{wi}")
            linear(f"{src}.layer.{ff}.DenseReluDense.wo", f"{dst}/ffn/wo")
            rms(f"{src}.layer.{ff}.layer_norm", f"{dst}/ffn_norm")
    return params
