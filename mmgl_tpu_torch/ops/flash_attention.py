"""Wrappers of the port's attention kernels (csrc/attention_fwd.cu,
csrc/attention_bwd.cu).

  K1 ``flash_attention_allheads``: OPT's aligned causal self-attention,
     replacing the Pallas ``_allheads_kernel_fwd``
     (mmgl_tpu/ops/flash_attention.py:1283, entry :1422).
  K2 ``fused_heads_attention``: CLIP's 197-patch self-attention, replacing
     the Pallas ``_fused_heads_kernel`` (mmgl_tpu/ops/flash_attention.py:1152,
     entry :1244).
  K3 ``flash_attention_allheads_bwd``: the backward of K1, replacing the
     Pallas ``_allheads_kernel_bwd`` (mmgl_tpu/ops/flash_attention.py:1307,
     via ``_allheads_vjp_bwd`` :1392).

K1 and K2 keep the JAX signatures, BSHD in and out, and carry autograd on
every device: K1 through ``_AllheadsAttention`` (K1 forward, K3 backward, the
counterpart of the ``_allheads`` custom VJP), K2 through
``_FusedHeadsAttention``, whose backward recomputes through the plain version
as ``_fused_heads_vjp_bwd`` does with XLA (the towers are frozen, so the
main path never runs it). On a CUDA tensor a wrapper checks its inputs,
launches its kernel on the current stream and adds one to its ``launches``
count; on a CPU tensor it computes its plain version. There is no fallback on
the card: a build or launch failure raises.

The masking follows ``xla_attention``, the JAX package's reference, not the
Pallas kernels: a fully masked row averages V over the S real keys (the
Pallas K2 pads S to 128 with masked zero keys first), and its gradient is
jax.grad's through ``xla_attention``: no dS at a masked logit (the Pallas K3
keeps one there).
"""

from __future__ import annotations

from typing import Optional

import torch

from mmgl_tpu_torch.ops import _build
from mmgl_tpu_torch.ops.attention import NEG_INF, attention_reference

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


def allheads_attention_bwd_reference(q, k, v, kv_mask, out, dout,
                                     causal=False, scale=None):
    """Plain version of K3: (dq, dk, dv) of ``allheads_attention_reference``
    for the cotangent ``dout``, with ``out`` its forward output.

    The Pallas K3's math (:1318-1344): P recomputed in fp32, delta =
    rowsum(dO * o) from the stored o, P and dS rounded to the input dtype
    before their products; plus xla_attention's zero dS at masked logits.
    In fp32 it equals torch autograd through ``attention_reference``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, sq, _, _ = q.shape
    sk = k.shape[1]
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, out, dout))
    allowed = torch.ones(b, 1, sq, sk, dtype=torch.bool, device=q.device)
    if kv_mask is not None:
        allowed = allowed & kv_mask.bool()[:, None, None, :]
    if causal:
        q_idx = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        allowed = allowed & (q_idx >= torch.arange(sk, device=q.device))
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.softmax(logits.masked_fill(~allowed, NEG_INF), dim=-1)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).float(), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = (dof * of).sum(-1).transpose(1, 2)[..., None]     # (B, H, Sq, 1)
    ds = (p * (dp - delta) * scale).masked_fill(~allowed, 0.0)
    ds = ds.to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
    for t in (k, v) + ((kv_mask,) if kv_mask is not None else ()):
        if t.device != q.device:
            raise ValueError(f"{name}: inputs on {t.device} and {q.device}")
    _check_layout(name, q, k, v)


def _check_layout(name: str, *tensors) -> None:
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")


def _int_mask(q, k, kv_mask) -> torch.Tensor:
    if kv_mask is None:
        return torch.ones(q.shape[0], k.shape[1], dtype=torch.int32,
                          device=q.device)
    return kv_mask.to(torch.int32).contiguous()


def _plain(q) -> bool:
    """Whether a wrapper computes its plain version: a tensor on the CPU.
    Anywhere else the kernel launches or the call raises."""
    return q.device.type == "cpu"


def _launch(fn, name, q, k, v, kv_mask, causal, scale, *shape):
    """Run one forward launcher of the library on the current stream;
    returns out."""
    lib = _build.load().lib
    kv_mask = _int_mask(q, k, kv_mask)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = getattr(lib, fn)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.data_ptr(),
            out.data_ptr(), *shape, q.shape[3], float(scale), int(causal),
            int(q.dtype == torch.bfloat16), stream)
    _build.check(lib, err, name)
    return out


def _launch_bwd(q, k, v, kv_mask, out, dout, causal, scale):
    """Run K3's launcher on the current stream; returns (dq, dk, dv)."""
    b, sq, h, d = q.shape
    lib = _build.load().lib
    mask = _int_mask(q, k, kv_mask)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stats = torch.empty(3 * b * h * sq, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.mmgl_allheads_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            out.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), stats.data_ptr(), b, sq, k.shape[1], h, d,
            float(scale), int(causal), int(q.dtype == torch.bfloat16), stream)
    _build.check(lib, err, "flash_attention_allheads_bwd")
    return dq, dk, dv


def _allheads_forward(q, k, v, kv_mask, causal, scale):
    if _plain(q):
        return allheads_attention_reference(q, k, v, kv_mask=kv_mask,
                                            causal=causal, scale=scale)
    b, sq, h, _ = q.shape
    out = _launch("mmgl_allheads_fwd", "flash_attention_allheads", q, k, v,
                  kv_mask, causal, scale, b, sq, k.shape[1], h)
    flash_attention_allheads.launches += 1
    return out


def flash_attention_allheads_bwd(q, k, v, kv_mask, out, dout, *,
                                 causal=False, scale=None):
    """K3: (dq, dk, dv) of K1 for the cotangent ``dout``; ``out`` is K1's
    output for the same inputs. Each in q's dtype and shape."""
    name = "flash_attention_allheads_bwd"
    _check(name, q, k, v, kv_mask)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"{name}: out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must have q's shape "
                         f"{tuple(q.shape)}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _plain(q):
        return allheads_attention_bwd_reference(q, k, v, kv_mask, out, dout,
                                                causal=causal, scale=scale)
    # autograd may hand a strided dout, and a plain forward a strided out
    out, dout = out.contiguous(), dout.to(q.dtype).contiguous()
    if out.dtype != q.dtype or out.device != q.device \
            or dout.device != q.device:
        raise ValueError(f"{name}: out/dout must match q's dtype and device")
    _check_layout(name, out, dout)
    grads = _launch_bwd(q, k, v, kv_mask, out, dout, causal, scale)
    flash_attention_allheads_bwd.launches += 1
    return grads


flash_attention_allheads_bwd.launches = 0


class _AllheadsAttention(torch.autograd.Function):
    """K1 forward, K3 backward (the ``_allheads`` custom VJP,
    mmgl_tpu/ops/flash_attention.py:1382-1419)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, scale):
        out = _allheads_forward(q, k, v, kv_mask, causal, scale)
        ctx.save_for_backward(q, k, v, kv_mask, out)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_mask, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_allheads_bwd(
            q, k, v, kv_mask, out, dout, causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention_allheads(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    kv_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """K1: attention over BSHD tensors read in place, (B, Sq, H, D) out; its
    gradient runs K3."""
    _check("flash_attention_allheads", q, k, v, kv_mask)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _AllheadsAttention.apply(q, k, v, kv_mask, causal, scale)


flash_attention_allheads.launches = 0


class _FusedHeadsAttention(torch.autograd.Function):
    """K2 forward; the backward recomputes through the plain version
    (``_fused_heads_vjp_bwd``, mmgl_tpu/ops/flash_attention.py:1230-1238)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, scale):
        ctx.save_for_backward(q, k, v, kv_mask)
        ctx.causal, ctx.scale = causal, scale
        if _plain(q):
            return fused_heads_attention_reference(
                q, k, v, kv_mask=kv_mask, causal=causal, scale=scale)
        b, s, h, _ = q.shape
        out = _launch("mmgl_fused_heads_fwd", "fused_heads_attention", q, k,
                      v, kv_mask, causal, scale, b, s, h)
        fused_heads_attention.launches += 1
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_mask = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in (q, k, v)]
            out = fused_heads_attention_reference(
                *inputs, kv_mask=kv_mask, causal=ctx.causal, scale=ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, inputs, dout)
        return dq, dk, dv, None, None, None


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
    return _FusedHeadsAttention.apply(q, k, v, kv_mask, causal, scale)


fused_heads_attention.launches = 0
