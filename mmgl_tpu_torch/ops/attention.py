"""Attention dispatch: hand-written Hopper kernels on the card, plain torch
versions on the CPU.

Counterpart of mmgl_tpu/ops/attention.py. Every model of the port routes its
attention through ``multi_head_attention``, which keeps the JAX package's
mapping from call sites to kernels:

  * ``use_pallas=False`` (``--use_pallas false``), q length < 32
    (single-token decode) or a ``pairwise_mask``: ``attention_reference``,
    with its bias and dropout. The JAX package sends these to XLA
    (``xla_attention``), never to a kernel, so this is the same route, not a
    fallback.
  * a bias or attention-prob dropout (T5): K7, ``flash_attention_bias``, at
    every such shape. The JAX package gated the no-dropout bias kernel at
    sq >= 384 (BIAS_MIN_SQ, a v5e measurement); the port measures its own
    gates and has no library route, so the 128-query decoder shapes take
    the kernel too.
  * sq != sk or a broadcast K/V head (T5's eval cross-attention): K4,
    ``flash_attention``.
  * aligned self-attention (S % 128 == 0) inside the JAX package's
    all-heads envelope, S <= 768 and H divisible by the head pair
    (mmgl_tpu/ops/attention.py:145-150; OPT eval 640, prefill 512): K1,
    ``flash_attention_allheads``.
  * aligned self-attention outside it (OPT-350M at 2048 tokens, its
    1920-token prefill): K4, as the JAX package sends it to ``_flash``.
  * self-attention with S % 128 != 0 (CLIP's 197 patches): K2,
    ``fused_heads_attention``.

The TPU's measured gates (PALLAS_MIN_KV, BIAS_MIN_SQ, K2's VMEM envelope)
do not carry over; K1's envelope does, so that long sequences reach the
per-head K4 and its backwards (K5, or the blocked K6) as in the JAX
package. The mapping is the same for
CPU and CUDA tensors and with or without autograd; on a CPU tensor each
kernel's wrapper computes its plain version instead. K1's gradient runs K3,
K4's K5 (K6 for causal attention under MMGL_BLOCKED_BWD=1) and K7's K8/K9;
K2's backward recomputes through its plain version, and the reference route
is plain autograd.

Dropout draws two 32-bit key words per call from the caller's
``torch.Generator`` into a tensor on its device (no host sync); the keep
mask is a pure function of that key and the element's (b, h, i, j), the
Philox-4x32-10 bits of csrc/philox.cuh, which ``dropout_bits`` computes with
torch integer arithmetic. So the kernel, its backward and the plain version
drop the same elements. The TPU's hardware bits are not reproduced: the
keep fraction is what compares with the JAX package.

Layout: q, k, v are (batch, seq, heads, head_dim), BSHD.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30  # large-negative instead of -inf: keeps fully-masked rows finite

# below this query length the JAX package sends attention to XLA
# (mmgl_tpu/ops/attention.py:83): the decode steps
MIN_KERNEL_SQ = 32
# the all-heads kernel's envelope (mmgl_tpu/ops/attention.py:145-150)
ALLHEADS_MAX_SQ = 768


def allheads_head_pair(head_dim: int) -> int:
    """Heads an all-heads program takes together, ``_allheads_hp``
    (mmgl_tpu/ops/flash_attention.py:1347)."""
    return 2 if 2 * head_dim <= 128 else 1


# Philox-4x32-10 (csrc/philox.cuh): multipliers, key increments
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF


def _mulhilo(m: int, c: torch.Tensor):
    """(hi, lo) 32-bit words of m * c for c in [0, 2^32), in int64 without
    overflow: c split into 16-bit halves."""
    a = m * (c & 0xFFFF)
    b = m * (c >> 16)
    t = a + ((b & 0xFFFF) << 16)
    return (b >> 16) + (t >> 32), t & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """The four 32-bit output words of Philox-4x32-10 for counter
    (c0, c1, c2, c3) and key (k0, k1): int64 tensors (or ints) in
    [0, 2^32), broadcast together."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _MASK32
        k1 = (k1 + _PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def dropout_bits(seed: torch.Tensor, shape) -> torch.Tensor:
    """(B, H, Sq, Sk) int64 random words in [0, 2^32) on seed's device: the
    element (b, h, i, j) is word (j >> 2) & 3 of Philox-4x32-10 at counter
    (((j >> 4) << 2) | (j & 3), i, h, b) under the key (seed[0], seed[1])
    (their low 32 bits): the bits the kernels draw."""
    b, h, sq, sk = shape
    dev = seed.device
    ar = lambda n: torch.arange(n, device=dev, dtype=torch.int64)
    groups = ar(((sk + 15) >> 4) << 2)
    words = philox4x32_10(groups.view(1, 1, 1, -1), ar(sq).view(1, 1, -1, 1),
                          ar(h).view(1, -1, 1, 1), ar(b).view(-1, 1, 1, 1),
                          seed[0] & _MASK32, seed[1] & _MASK32)
    words = torch.stack(torch.broadcast_tensors(*words), dim=-1)
    j = ar(sk)
    return words[..., ((j >> 4) << 2) | (j & 3), (j >> 2) & 3]


def dropout_threshold(rate: float) -> Optional[Tuple[int, float]]:
    """(threshold, 1 / keep) of a dropout rate: an element is kept where its
    32-bit word is below threshold = round(keep * 2^32)
    (mmgl_tpu/ops/flash_attention.py:1107-1112); None where keep rounds to
    1 and dropout is a no-op."""
    if rate <= 0.0:
        return None
    keep = 1.0 - rate
    t = int(round(keep * 2.0 ** 32))
    return (t, 1.0 / keep) if t < 2 ** 32 else None


def dropout_keep_factor(seed: torch.Tensor, shape, rate: float
                        ) -> torch.Tensor:
    """(B, H, Sq, Sk) fp32: 1 / keep where the element is kept, else 0."""
    threshold, keep_inv = dropout_threshold(rate)
    keep = dropout_bits(seed, shape) < threshold
    return keep.to(torch.float32) * keep_inv


def draw_dropout_seed(generator: torch.Generator) -> torch.Tensor:
    """The key of one dropout call: two words from ``generator``, as a (2,)
    int64 tensor on its device (drawn there: no host sync)."""
    return torch.randint(0, 2 ** 32, (2,), generator=generator,
                         device=generator.device, dtype=torch.int64)


def attention_route(q_shape, k_shape, *, pairwise_mask: bool = False,
                    bias: bool = False, dropout: bool = False,
                    use_pallas: bool = True) -> str:
    """Which implementation ``multi_head_attention`` uses for these shapes:
    "reference", "bias" (K7), "flash" (K4), "allheads" (K1) or
    "fused_heads" (K2)."""
    sq, sk, heads = q_shape[1], k_shape[1], q_shape[2]
    if not use_pallas or sq < MIN_KERNEL_SQ or pairwise_mask:
        return "reference"
    if bias or dropout:
        return "bias"
    if sq != sk or k_shape[2] != heads:
        return "flash"
    if sq % 128:
        return "fused_heads"
    if sq <= ALLHEADS_MAX_SQ and heads % allheads_head_pair(q_shape[3]) == 0:
        return "allheads"
    return "flash"


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
    generator: Optional[torch.Generator] = None,
    use_pallas: bool = True,
) -> torch.Tensor:
    """Multi-head attention; returns (B, Sq, H, D) in q.dtype.

    kv_mask: (B, Sk) 1/0 key validity; pairwise_mask: (B, Sq, Sk);
    bias: additive (B|1, H|1, Sq, Sk), batch-shared (1, ...) on the kernel
    route; causal aligns the ends (sk >= sq). dropout_rate > 0 drops
    attention probabilities with a key drawn from ``generator`` (the
    dropout stream, on the tensors' device)."""
    # imported here: flash_attention imports attention_reference from this
    # module (the JAX package imports its kernels lazily too)
    from mmgl_tpu_torch.ops import flash_attention as fa

    seed = None
    if dropout_threshold(dropout_rate) is None:
        dropout_rate = 0.0
    else:
        if generator is None:
            raise ValueError("attention dropout needs a generator")
        seed = draw_dropout_seed(generator)
    route = attention_route(q.shape, k.shape,
                            pairwise_mask=pairwise_mask is not None,
                            bias=bias is not None, dropout=seed is not None,
                            use_pallas=use_pallas)
    if route == "reference":
        return attention_reference(q, k, v, kv_mask=kv_mask,
                                   pairwise_mask=pairwise_mask, bias=bias,
                                   causal=causal, scale=scale,
                                   dropout_rate=dropout_rate,
                                   dropout_seed=seed)
    if route == "bias":
        return fa.flash_attention_bias(
            q, k, v, bias=bias, kv_mask=kv_mask, causal=causal, scale=scale,
            dropout_rate=dropout_rate, dropout_seed=seed)
    kernel = {"flash": fa.flash_attention,
              "allheads": fa.flash_attention_allheads,
              "fused_heads": fa.fused_heads_attention}[route]
    return kernel(q, k, v, kv_mask=kv_mask, causal=causal, scale=scale)


def attention_reference(q, k, v, *, kv_mask=None, pairwise_mask=None,
                        bias=None, causal=False, scale=None,
                        dropout_rate=0.0, dropout_seed=None,
                        dropout_mask=None):
    """Plain attention, the counterpart of ``xla_attention``
    (mmgl_tpu/ops/attention.py:190-224): fp32 logits and softmax, masked
    logits set to NEG_INF, probabilities dropped (dropout_rate > 0) and cast
    to v's dtype for the PV product, which accumulates in fp32.

    Dropout keeps the (B, H, Sq, Sk) ``dropout_mask`` if one is given, else
    the kernels' bits under ``dropout_seed``; kept probabilities are scaled
    by 1 / (1 - dropout_rate)."""
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
    if dropout_rate > 0.0:
        if dropout_mask is not None:
            probs = probs * dropout_mask.float() / (1.0 - dropout_rate)
        elif dropout_seed is not None:
            probs = probs * dropout_keep_factor(dropout_seed, probs.shape,
                                                dropout_rate)
        else:
            raise ValueError("dropout needs dropout_mask or dropout_seed")
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)
