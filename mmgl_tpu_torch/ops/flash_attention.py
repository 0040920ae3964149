"""Wrappers of the port's two attention kernels (csrc/attention_fwd.cu).

  K1 ``flash_attention_allheads``: OPT's aligned causal self-attention,
     replacing the Pallas ``_allheads_kernel_fwd``
     (mmgl_tpu/ops/flash_attention.py:1283, entry :1422).
  K2 ``fused_heads_attention``: CLIP's 197-patch self-attention, replacing
     the Pallas ``_fused_heads_kernel`` (mmgl_tpu/ops/flash_attention.py:1152,
     entry :1244).

Both keep the JAX signatures, BSHD in and out, forward only. On a CUDA tensor
a wrapper checks its inputs, launches its kernel on the current stream and
adds one to its ``launches`` count; on a CPU tensor it returns its plain
version, ``allheads_attention_reference`` or
``fused_heads_attention_reference``. There is no fallback on the card: a
build or launch failure raises.

The masking follows ``xla_attention``, the JAX package's reference, not the
Pallas K2, which pads S to 128 with masked zero keys: a fully masked row here
averages V over the S real keys, there over the padded width.
"""

from __future__ import annotations

from typing import Optional

import torch

from mmgl_tpu_torch.ops import _build
from mmgl_tpu_torch.ops.attention import attention_reference

HEAD_DIM = 64
_DTYPES = (torch.float32, torch.bfloat16)


def allheads_attention_reference(q, k, v, *, kv_mask=None, causal=False,
                                 scale=None):
    """Plain version of K1: ``xla_attention``'s math in torch."""
    return attention_reference(q, k, v, kv_mask=kv_mask, causal=causal,
                               scale=scale)


def fused_heads_attention_reference(q, k, v, *, kv_mask=None, causal=False,
                                    scale=None):
    """Plain version of K2: ``xla_attention``'s math in torch."""
    return attention_reference(q, k, v, kv_mask=kv_mask, causal=causal,
                               scale=scale)


def _check(name: str, q, k, v, kv_mask) -> None:
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"{name}: q/k/v must be BSHD with k.shape == v.shape,"
                         f" got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"{name}: k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if k.shape[1] < sq:
        raise ValueError(f"{name}: sq={sq} > sk={k.shape[1]}")
    if kv_mask is not None and tuple(kv_mask.shape) != (b, k.shape[1]):
        raise ValueError(f"{name}: kv_mask {tuple(kv_mask.shape)} is not "
                         f"(B, Sk) = {(b, k.shape[1])}")
    if q.device.type == "cpu":
        return
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if d != HEAD_DIM:
        raise ValueError(f"{name}: the kernel takes head_dim {HEAD_DIM}, "
                         f"got {d}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q/k/v must all be float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    for t in (q, k, v) + ((kv_mask,) if kv_mask is not None else ()):
        if t.device != q.device:
            raise ValueError(f"{name}: inputs on {t.device} and {q.device}")
    for t in (q, k, v):
        if not t.is_contiguous():
            raise ValueError(f"{name}: q/k/v must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: q/k/v must be 16-byte aligned")


def _launch(fn, name, q, k, v, kv_mask, causal, scale, *shape):
    """Run one launcher of the library on the current stream; returns out."""
    lib = _build.load().lib
    if kv_mask is None:
        kv_mask = torch.ones(q.shape[0], k.shape[1], dtype=torch.int32,
                             device=q.device)
    kv_mask = kv_mask.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = getattr(lib, fn)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.data_ptr(),
            out.data_ptr(), *shape, q.shape[3], float(scale), int(causal),
            int(q.dtype == torch.bfloat16), stream)
    _build.check(lib, err, name)
    return out


def flash_attention_allheads(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    kv_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """K1: attention over BSHD tensors read in place, (B, Sq, H, D) out."""
    _check("flash_attention_allheads", q, k, v, kv_mask)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return allheads_attention_reference(q, k, v, kv_mask=kv_mask,
                                            causal=causal, scale=scale)
    b, sq, h, _ = q.shape
    out = _launch("mmgl_allheads_fwd", "flash_attention_allheads", q, k, v,
                  kv_mask, causal, scale, b, sq, k.shape[1], h)
    flash_attention_allheads.launches += 1
    return out


flash_attention_allheads.launches = 0


def fused_heads_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    kv_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """K2: self-attention (sq == sk) of any length, (B, S, H, D) out."""
    _check("fused_heads_attention", q, k, v, kv_mask)
    if k.shape[1] != q.shape[1]:
        raise ValueError("fused_heads_attention is self-attention: sq == sk")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return fused_heads_attention_reference(q, k, v, kv_mask=kv_mask,
                                               causal=causal, scale=scale)
    b, s, h, _ = q.shape
    out = _launch("mmgl_fused_heads_fwd", "fused_heads_attention", q, k, v,
                  kv_mask, causal, scale, b, s, h)
    fused_heads_attention.launches += 1
    return out


fused_heads_attention.launches = 0
