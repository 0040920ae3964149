"""Attention dispatch: hand-written Hopper kernels on the card, plain torch
versions on the CPU.

Counterpart of mmgl_tpu/ops/attention.py. Every model of the port routes its
attention through ``multi_head_attention``, which keeps the JAX package's
mapping from call sites to kernels:

  * q length < 32 (single-token decode) or a ``pairwise_mask``:
    ``attention_reference``. The JAX package sends these to XLA
    (``xla_attention``), never to a kernel, so this is the same route, not a
    fallback.
  * aligned self-attention (S % 128 == 0: OPT eval 640, prefill 512):
    K1, ``flash_attention_allheads``.
  * the same with S % 128 != 0 (CLIP's 197 patches): K2,
    ``fused_heads_attention``.
  * bias, dropout, sq != sk or a broadcast K/V head: the kernels of the JAX
    package that serve them (K7 ``flash_attention_bias``, K4
    ``flash_attention``) are not ported yet, and the call raises.

The TPU's measured gates (PALLAS_MIN_KV, the VMEM envelopes, BIAS_MIN_SQ) do
not carry over. The mapping is the same for CPU and CUDA tensors and with or
without autograd; on a CPU tensor each kernel's wrapper computes its plain
version instead. Only K1's route has a backward kernel (K3); K2's backward
recomputes through its plain version, and the reference route is plain
autograd.

Layout: q, k, v are (batch, seq, heads, head_dim), BSHD.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30  # large-negative instead of -inf: keeps fully-masked rows finite

# below this query length the JAX package sends attention to XLA
# (mmgl_tpu/ops/attention.py:83): the decode steps
MIN_KERNEL_SQ = 32


def attention_route(q_shape, k_shape, *, pairwise_mask: bool = False,
                    bias: bool = False, dropout: bool = False) -> str:
    """Which implementation ``multi_head_attention`` uses for these shapes:
    "reference", "allheads" (K1) or "fused_heads" (K2). Raises
    NotImplementedError for calls whose kernel is not ported yet."""
    sq, sk = q_shape[1], k_shape[1]
    if sq < MIN_KERNEL_SQ or pairwise_mask:
        return "reference"
    if bias or dropout:
        raise NotImplementedError(
            "attention with bias or dropout runs on K7 (flash_attention_bias, "
            "mmgl_tpu/ops/flash_attention.py:768), not ported yet")
    if sq != sk or k_shape[2] != q_shape[2]:
        raise NotImplementedError(
            f"attention with sq={sq} != sk={sk} or a broadcast K/V head runs "
            "on K4 (flash_attention, mmgl_tpu/ops/flash_attention.py:179), "
            "not ported yet")
    return "allheads" if sq % 128 == 0 else "fused_heads"


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    kv_mask: Optional[torch.Tensor] = None,
    pairwise_mask: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
) -> torch.Tensor:
    """Multi-head attention; returns (B, Sq, H, D) in q.dtype.

    kv_mask: (B, Sk) 1/0 key validity; pairwise_mask: (B, Sq, Sk);
    bias: additive (B|1, H|1, Sq, Sk); causal aligns the ends (sk >= sq)."""
    # imported here: flash_attention imports attention_reference from this
    # module (the JAX package imports its kernels lazily too)
    from mmgl_tpu_torch.ops import flash_attention as fa

    route = attention_route(q.shape, k.shape,
                            pairwise_mask=pairwise_mask is not None,
                            bias=bias is not None, dropout=dropout_rate > 0.0)
    if route == "reference":
        return attention_reference(q, k, v, kv_mask=kv_mask,
                                   pairwise_mask=pairwise_mask, bias=bias,
                                   causal=causal, scale=scale)
    kernel = (fa.flash_attention_allheads if route == "allheads"
              else fa.fused_heads_attention)
    return kernel(q, k, v, kv_mask=kv_mask, causal=causal, scale=scale)


def attention_reference(q, k, v, *, kv_mask=None, pairwise_mask=None,
                        bias=None, causal=False, scale=None):
    """Plain attention, the counterpart of ``xla_attention``
    (mmgl_tpu/ops/attention.py:190-224): fp32 logits and softmax, masked
    logits set to NEG_INF, probabilities cast to v's dtype for the PV
    product, which accumulates in fp32."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if k.shape[2] == 1 and h > 1:  # broadcast single-head KV
        k = k.expand(b, sk, h, d)
        v = v.expand(b, sk, h, v.shape[-1])

    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    if kv_mask is not None:
        logits = logits.masked_fill(~kv_mask.bool()[:, None, None, :], NEG_INF)
    if pairwise_mask is not None:
        logits = logits.masked_fill(~pairwise_mask.bool()[:, None], NEG_INF)
    if causal:
        q_idx = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        k_idx = torch.arange(sk, device=q.device)[None, :]
        logits = logits.masked_fill(q_idx < k_idx, NEG_INF)

    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)
