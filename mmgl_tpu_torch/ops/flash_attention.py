"""Wrappers of the port's attention kernels (csrc/attention_fwd.cu,
csrc/attention_bwd.cu, csrc/attention_blocked_bwd.cu,
csrc/attention_bias_fwd.cu, csrc/attention_bias_bwd.cu).

  K1 ``flash_attention_allheads``: OPT's aligned causal self-attention,
     replacing the Pallas ``_allheads_kernel_fwd``
     (mmgl_tpu/ops/flash_attention.py:1283, entry :1422).
  K2 ``fused_heads_attention``: CLIP's 197-patch self-attention, replacing
     the Pallas ``_fused_heads_kernel`` (mmgl_tpu/ops/flash_attention.py:1152,
     entry :1244).
  K3 ``flash_attention_allheads_bwd``: the backward of K1, replacing the
     Pallas ``_allheads_kernel_bwd`` (mmgl_tpu/ops/flash_attention.py:1307,
     via ``_allheads_vjp_bwd`` :1392).
  K4 ``flash_attention``: attention without bias or dropout at sq != sk,
     with a broadcast K/V head (T5's eval cross-attention) or past K1's
     envelope (OPT-350M at 2048 tokens), replacing the Pallas
     ``_fwd_kernel`` and ``_fwd_kernel_causal_stream``
     (mmgl_tpu/ops/flash_attention.py:92/:129, pallas_call in ``_fwd``
     :179/:209, entry :1447). ``flash_attention_stats`` is K4 keeping the
     rows' softmax max and sum, ``_fwd``'s ``with_lse``.
  K5 ``flash_attention_bwd``: the backward of K4, replacing the Pallas
     ``_bwd_kernel`` (mmgl_tpu/ops/flash_attention.py:414, ``_bwd`` :457).
  K6 ``flash_attention_blocked_bwd``: K4's causal backward from its saved
     row statistics, replacing the Pallas ``_bwd_dq_kernel`` and
     ``_bwd_dkv_kernel`` (:246/:289 via ``_bwd_causal_blocked`` :336). As in
     the JAX package, ``MMGL_BLOCKED_BWD=1`` at import selects it for causal
     attention (``BLOCKED_BWD``); K5 serves otherwise.
  K7 ``flash_attention_bias``: attention with a batch-shared additive bias
     and in-kernel prob-dropout (T5), replacing the Pallas
     ``_fwd_bias_kernel(_batched)`` (mmgl_tpu/ops/flash_attention.py:594/624,
     ``_fwd_bias`` :768, entry :1069).
  K8/K9 ``flash_attention_bias_bwd``: the backward of K7 with dbias, one
     kernel for the Pallas ``_bwd_bias_kernel_batched`` (:843, K8) and
     ``_bwd_bias_kernel`` (:689, K9).

Every kernel has two bodies, chosen by the input dtype (``_tensor_cores``):
bf16 and fp16 inputs launch the tensor-core body (the ``*_tc`` entries of
the library: K1, K3, K4 and K7 on Hopper's wgmma and TMA,
csrc/allheads_wgmma.cuh, with the stats passes of K5 and K8/K9; the others
on mma.sync in the input's type), fp32 inputs the scalar one
(on the tensor cores fp32 would run as TF32, about three decimal digits,
against the fp32 checks' 2e-5). The wrappers count ``launches`` and, of
those, ``launches_tc``. There is no fallback from one body to the other.
The masks stay -1e30 in fp32 inside the kernels (fp16 tops out at 65504),
and the plain versions compute their logits and softmax in fp32 for every
input dtype. K1's and K7's tensor-core bodies also write the rows' softmax
max and sum where a gradient follows (``flash_attention_allheads_stats``,
``flash_attention_bias_stats``), and K3's and K8/K9's start from them
instead of a stats pass.

K1, K2, K4 and K7 keep the JAX signatures, BSHD in and out, and carry autograd on
every device: K1 through ``_AllheadsAttention`` (K1 forward, K3 backward, the
counterpart of the ``_allheads`` custom VJP), K4 through ``_FlashAttention``
(K5 or K6 backward), K7 through ``_BiasAttention`` (K8/K9 backward), K2 through
``_FusedHeadsAttention``, whose backward recomputes through the plain version
as ``_fused_heads_vjp_bwd`` does with XLA (the towers are frozen, so the
main path never runs it). Where no gradient can flow (the eval and test
passes, the frozen towers) each skips its autograd node. On a CUDA tensor a
wrapper checks its inputs, launches its kernel on the current stream and
adds one to its ``launches`` count; on a CPU tensor it computes its plain
version. There is no fallback on the card: a build or launch failure
raises.

Head dims: K1 and K3-K6 take 64, 80 (OPT and MPT at 2.7B) and 128 (6.7B),
K2 and K7-K9 64 (``HEAD_DIMS``); the plain versions take any.

The masking follows ``xla_attention``, the JAX package's reference, not the
Pallas kernels: a fully masked row averages V over the S real keys (the
Pallas K2 pads S to 128 with masked zero keys first), and its gradient is
jax.grad's through ``xla_attention``: no dS at a masked logit (the Pallas K3
keeps one there).
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import torch

from mmgl_tpu_torch.ops import _build
from mmgl_tpu_torch.ops.attention import (NEG_INF, attention_reference,
                                          dropout_keep_factor,
                                          dropout_threshold)

# the head dims each kernel takes, by wrapper: its bodies are instantiated
# at these (mmgl::with_head_dim, csrc/common.cuh). K1 and K3-K6 take
# OPT's and MPT's 64, 80 (2.7B) and 128 (6.7B); K2 takes 64 (its envelope,
# H * D <= 1024, holds only for CLIP, OPT-125M and OPT-350M, all at 64) and
# K7-K9 take 64 (T5's d_kv at every size): another is ROADMAP B
HEAD_DIMS = {
    "flash_attention_allheads": (64, 80, 128),
    "flash_attention_allheads_bwd": (64, 80, 128),
    "flash_attention": (64, 80, 128),
    "flash_attention_bwd": (64, 80, 128),
    "flash_attention_blocked_bwd": (64, 80, 128),
    "fused_heads_attention": (64,),
    "flash_attention_bias": (64,),
    "flash_attention_bias_bwd": (64,),
}
# the dtypes the kernels take, and their codes in the library's entries
# (mmgl::DType, csrc/common.cuh)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_DTYPES = tuple(_DTYPE_CODE)

# K6 in place of K5 for K4's causal backward, as MMGL_BLOCKED_BWD=1 selects
# _bwd_causal_blocked (mmgl_tpu/ops/flash_attention.py:75); read at import
BLOCKED_BWD = os.environ.get("MMGL_BLOCKED_BWD", "0") == "1"


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
    In fp32 it equals torch autograd through ``attention_reference``. It is
    K8/K9's plain version without bias or dropout."""
    return bias_attention_bwd_reference(q, k, v, kv_mask, None, out, dout,
                                        causal=causal, scale=scale)[:3]


def flash_attention_reference(q, k, v, *, kv_mask=None, causal=False,
                              scale=None, with_stats=False):
    """Plain version of K4: ``xla_attention``'s math in torch. With
    ``with_stats``, (out, row_max, row_sum): the softmax max and sum of
    each row's masked logits, (B, H, Sq) fp32 (a fully masked row has max
    -1e30 and sum Sk)."""
    out = attention_reference(q, k, v, kv_mask=kv_mask, causal=causal,
                              scale=scale)
    if not with_stats:
        return out
    return (out,) + _row_stats(q, k, kv_mask, causal, scale)


def _row_stats(q, k, kv_mask, causal, scale, bias=None):
    """(row_max, row_sum), (B, H, Sq) fp32: the softmax max and sum of each
    row's masked logits (with the bias)."""
    logits = _masked_logits(q, k, kv_mask, causal, scale, bias)
    row_max = logits.amax(-1)
    return row_max, torch.exp(logits - row_max[..., None]).sum(-1)


def flash_attention_bwd_reference(q, k, v, kv_mask, out, dout, causal=False,
                                  scale=None):
    """Plain version of K5: K3's math (``allheads_attention_bwd_reference``),
    which holds for sq != sk."""
    return allheads_attention_bwd_reference(q, k, v, kv_mask, out, dout,
                                            causal=causal, scale=scale)


def bias_attention_reference(q, k, v, *, bias=None, kv_mask=None,
                             causal=False, scale=None, dropout_rate=0.0,
                             dropout_seed=None, with_stats=False):
    """Plain version of K7: ``xla_attention``'s math in torch with the
    kernel's dropout bits. With ``with_stats``, (out, row_max, row_sum) as
    ``flash_attention_reference`` gives them, of the logits with the bias
    (the dropout comes after the softmax and changes neither)."""
    out = attention_reference(q, k, v, kv_mask=kv_mask, bias=bias,
                              causal=causal, scale=scale,
                              dropout_rate=dropout_rate,
                              dropout_seed=dropout_seed)
    if not with_stats:
        return out
    return (out,) + _row_stats(q, k, kv_mask, causal, scale, bias)


def _allowed(q, k, kv_mask, causal):
    """(B, 1, Sq, Sk) bool: the logits that are not masked."""
    b, sq, sk = q.shape[0], q.shape[1], k.shape[1]
    allowed = torch.ones(b, 1, sq, sk, dtype=torch.bool, device=q.device)
    if kv_mask is not None:
        allowed = allowed & kv_mask.bool()[:, None, None, :]
    if causal:
        q_idx = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        allowed = allowed & (q_idx >= torch.arange(sk, device=q.device))
    return allowed


def _masked_logits(q, k, kv_mask, causal, scale, bias=None):
    """(B, H, Sq, Sk) fp32 logits (plus the bias), NEG_INF where masked."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    return logits.masked_fill(~_allowed(q, k, kv_mask, causal), NEG_INF)


def flash_attention_blocked_bwd_reference(q, k, v, kv_mask, out, dout,
                                          row_max, row_sum, *, causal=True,
                                          scale=None):
    """Plain version of K6: (dq, dk, dv) of K4 from its saved row max and
    sum, ``_bwd_causal_blocked``'s math (:246-333): P = exp(logits - m) / l
    without a softmax pass, delta = rowsum(dO * o), P and dS rounded to the
    input dtype before their products; plus xla_attention's zero dS at
    masked logits, where a fully masked row keeps P = 1/Sk (the Pallas
    kernels drop it). In fp32 it equals torch autograd through
    ``attention_reference``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    dof = dout.float()
    allowed = _allowed(q, k, kv_mask, causal)
    logits = _masked_logits(q, k, kv_mask, causal, scale)
    p = torch.exp(logits - row_max[..., None]) / row_sum[..., None]
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).float(), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    delta = (dof * out.float()).sum(-1).transpose(1, 2)[..., None]
    ds = (p * (dp - delta) * scale).masked_fill(~allowed, 0.0)
    ds = ds.to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def bias_attention_bwd_reference(q, k, v, kv_mask, bias, out, dout, *,
                                 causal=False, scale=None, dropout_rate=0.0,
                                 dropout_seed=None):
    """Plain version of K8/K9: (dq, dk, dv, dbias) of
    ``bias_attention_reference`` for the cotangent ``dout``, with ``out`` its
    forward output; dbias is None without a bias, else summed over the batch
    in the bias's shape and dtype.

    The Pallas math (:701-754) with m the keep factor: P recomputed in fp32,
    dV = (P m)^T dO, delta = rowsum(dO * o), dlogits = P (m dP - delta),
    dbias = sum_b dlogits, dS = dlogits * scale; plus xla_attention's zero
    at masked logits. In fp32 it equals torch autograd through
    ``attention_reference`` with the same mask."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, out, dout))
    allowed = _allowed(q, k, kv_mask, causal)
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if bias is not None:
        logits = logits + bias.float()
    p = torch.softmax(logits.masked_fill(~allowed, NEG_INF), dim=-1)
    mf = 1.0
    if dropout_threshold(dropout_rate) is not None:
        mf = dropout_keep_factor(dropout_seed, p.shape, dropout_rate)
    dv = torch.einsum("bhqk,bqhd->bkhd", (p * mf).to(q.dtype).float(), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = (dof * of).sum(-1).transpose(1, 2)[..., None]     # (B, H, Sq, 1)
    dlogits = (p * (mf * dp - delta)).masked_fill(~allowed, 0.0)
    ds = (dlogits * scale).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dbias = None
    if bias is not None:
        dbias = dlogits.sum(0, keepdim=True).to(bias.dtype)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


def _check(name: str, q, k, v, kv_mask, allow_sq_gt_sk: bool = False
           ) -> None:
    qs, ks = q.shape, k.shape
    if len(qs) != 4 or len(ks) != 4 or ks != v.shape:
        raise ValueError(f"{name}: q/k/v must be BSHD with k.shape == v.shape,"
                         f" got {tuple(qs)}, {tuple(ks)}, {tuple(v.shape)}")
    b, sq, h, d = qs
    if ks[0] != b or ks[2] != h or ks[3] != d:
        raise ValueError(f"{name}: k/v {tuple(ks)} do not match q "
                         f"{tuple(qs)}")
    if ks[1] < sq and not allow_sq_gt_sk:
        raise ValueError(f"{name}: sq={sq} > sk={ks[1]}")
    if kv_mask is not None and kv_mask.shape != (b, ks[1]):
        raise ValueError(f"{name}: kv_mask {tuple(kv_mask.shape)} is not "
                         f"(B, Sk) = {(b, ks[1])}")
    dev = q.device
    if dev.type == "cpu":
        return
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if d not in HEAD_DIMS.get(name, (64,)):
        dims = HEAD_DIMS.get(name, (64,))
        raise ValueError(f"{name}: the kernel takes head_dim "
                         f"{' or '.join(map(str, dims))}, got {d} (ROADMAP "
                         "B)")
    dtype = q.dtype
    if dtype not in _DTYPE_CODE or k.dtype != dtype or v.dtype != dtype:
        raise ValueError(f"{name}: q/k/v must all be float32, bfloat16 or "
                         f"float16, got {dtype}, {k.dtype}, {v.dtype}")
    for t in (k, v) + ((kv_mask,) if kv_mask is not None else ()):
        if t.device != dev:
            raise ValueError(f"{name}: inputs on {t.device} and {dev}")
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


def _needs_grad(q, k, v) -> bool:
    """Whether autograd would record a call on q, k and v."""
    return torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)


def _plain(q) -> bool:
    """Whether a wrapper computes its plain version: a tensor on the CPU.
    Anywhere else the kernel launches or the call raises."""
    return q.device.type == "cpu"


def _tensor_cores(q) -> bool:
    """Whether a kernel takes its tensor-core body (bf16 or fp16), not the
    scalar one (fp32; ``_check`` refuses any other dtype)."""
    return q.dtype in (torch.bfloat16, torch.float16)


def _entry(fn: str, q) -> str:
    """The library entry of a K1-K6 launcher for q's dtype."""
    return fn + "_tc" if _tensor_cores(q) else fn


def _count(wrapper, q) -> None:
    """One launch of a kernel wrapper, and of its tensor-core body if q is
    bf16 or fp16."""
    wrapper.launches += 1
    wrapper.launches_tc += int(_tensor_cores(q))


def _launch(fn, name, q, k, v, kv_mask, causal, scale, *shape):
    """Run one forward launcher of the library (``fn``, or its tensor-core
    entry for bf16 and fp16: K2's) on the current stream; returns out."""
    lib = _build.load().lib
    kv_mask = _int_mask(q, k, kv_mask)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = getattr(lib, _entry(fn, q))(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.data_ptr(),
            out.data_ptr(), *shape, q.shape[3], float(scale), int(causal),
            _DTYPE_CODE[q.dtype], stream)
    _build.check(lib, err, name)
    return out


def _launch_bwd(fn, name, q, k, v, kv_mask, out, dout, causal, scale):
    """Run a dense backward launcher (K5; its tensor-core entry for bf16
    and fp16) on the current stream through ``_call`` (it may run on
    autograd's backward thread); returns (dq, dk, dv)."""
    b, sq, h, d = q.shape
    mask = _int_mask(q, k, kv_mask)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stats = torch.empty(3 * b * h * sq, dtype=torch.float32, device=q.device)
    _call(q, _lib_fn(_entry(fn, q)), name, q.data_ptr(), k.data_ptr(),
          v.data_ptr(), mask.data_ptr(), out.data_ptr(), dout.data_ptr(),
          dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(), b,
          sq, k.shape[1], h, d, scale, causal, _DTYPE_CODE[q.dtype])
    return dq, dk, dv


def _check_out_dout(name, q, out, dout):
    """out and dout as the backward kernels take them: q's shape, and on
    the card q's dtype and device, contiguous (autograd may hand a strided
    dout, and a plain forward a strided out)."""
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"{name}: out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must have q's shape "
                         f"{tuple(q.shape)}")
    if _plain(q):
        return out, dout
    out, dout = out.contiguous(), dout.to(q.dtype).contiguous()
    if out.dtype != q.dtype or out.device != q.device \
            or dout.device != q.device:
        raise ValueError(f"{name}: out/dout must match q's dtype and device")
    _check_layout(name, out, dout)
    return out, dout


# ---- K1, K3, K4 and K7's launch path ----------------------------------
#
# K1 and K3 run once a layer and micro-step (K4 and K7 in T5's layers),
# and their bodies take tens of microseconds, so the host's work around
# each launch sets their pace. Their launchers do only what a call needs:
# the ctypes entry's argument types are set once at load (``_build.load``),
# the raw stream comes from torch's C API, the device is switched only when
# q is not on the current one, an int32 contiguous key mask is passed as it
# stands (the models build theirs once a forward) and no mask as a null
# pointer (every key valid), and the tensor maps are encoded by the C
# entry.


def _lib_fn(entry):
    """The library's entry ``entry`` (its argument types set at load)."""
    return getattr(_build.load().lib, entry)


def _mask_arg(kv_mask):
    """(keep-alive tensor or None, pointer or None) of a key mask as the
    wgmma entries take it: int32 contiguous, or null for none."""
    if kv_mask is None:
        return None, None
    if kv_mask.dtype != torch.int32 or not kv_mask.is_contiguous():
        kv_mask = kv_mask.to(torch.int32).contiguous()
    return kv_mask, kv_mask.data_ptr()


# the device whose context each host thread has made current for the
# library (its own CUDA runtime needs a current context on the calling
# thread: a launch from autograd's backward thread before any torch kernel
# there fails with "invalid argument")
_THREAD = threading.local()


def _call(q, fn, name, *args):
    """Call a library entry with q's device current and its current stream
    as the last argument; raise on a CUDA error."""
    index = q.device.index
    if index == torch.cuda.current_device():
        if getattr(_THREAD, "device", None) != index:
            torch.cuda.set_device(index)  # current already: makes its
            _THREAD.device = index        # context current on this thread
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(q.device):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err:
        _build.check(_build.load().lib, err, name)


def _launch_allheads(q, k, v, kv_mask, causal, scale, with_stats):
    """Run K1 on the current stream: (out, row_max, row_sum), the stats
    (B, H, Sq) fp32 where ``with_stats`` (the wgmma body only), else
    None."""
    b, sq, h, d = q.shape
    out = torch.empty_like(q)
    mask, mask_ptr = _mask_arg(kv_mask)
    if _tensor_cores(q):
        stats = _empty_stats(q) if with_stats else (None, None)
        _call(q, _lib_fn("mmgl_allheads_fwd_tc"), "flash_attention_allheads",
              q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr,
              out.data_ptr(), *(_ptr(t) for t in stats), b, sq, k.shape[1],
              h, d, scale, causal, _DTYPE_CODE[q.dtype])
        return (out,) + stats
    if mask is None:  # the scalar body reads a mask
        mask, mask_ptr = _mask_arg(_int_mask(q, k, None))
    _call(q, _lib_fn("mmgl_allheads_fwd"), "flash_attention_allheads",
          q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
          b, sq, k.shape[1], h, d, scale, causal, 0)
    return out, None, None


def _launch_allheads_bwd(q, k, v, kv_mask, out, dout, causal, scale,
                         row_max, row_sum):
    """Run K3 on the current stream: (dq, dk, dv). The wgmma bodies start
    from ``row_max``/``row_sum`` where given (K1's), else compute them
    first; the scalar body (fp32) always does."""
    b, sq, h, d = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    mask, mask_ptr = _mask_arg(kv_mask)
    if _tensor_cores(q):
        n = b * h * sq * (1 if row_max is not None else 3)
        scratch = torch.empty(n, dtype=torch.float32, device=q.device)
        _call(q, _lib_fn("mmgl_allheads_bwd_tc"),
              "flash_attention_allheads_bwd", q.data_ptr(), k.data_ptr(),
              v.data_ptr(), mask_ptr, out.data_ptr(), dout.data_ptr(),
              dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(),
              _ptr(row_max), _ptr(row_sum), b, sq, k.shape[1], h, d, scale,
              causal, _DTYPE_CODE[q.dtype])
        return dq, dk, dv
    if mask is None:
        mask, mask_ptr = _mask_arg(_int_mask(q, k, None))
    stats = torch.empty(3 * b * h * sq, dtype=torch.float32, device=q.device)
    _call(q, _lib_fn("mmgl_allheads_bwd"), "flash_attention_allheads_bwd",
          q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
          dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
          stats.data_ptr(), b, sq, k.shape[1], h, d, scale, causal, 0)
    return dq, dk, dv


def _allheads_forward(q, k, v, kv_mask, causal, scale, with_stats):
    """K1 (or its plain version on the CPU): (out, row_max, row_sum), the
    stats None unless ``with_stats`` (on the card, bf16 and fp16 only)."""
    if _plain(q):
        out = allheads_attention_reference(q, k, v, kv_mask=kv_mask,
                                           causal=causal, scale=scale)
        if not with_stats:
            return out, None, None
        return (out,) + _row_stats(q, k, kv_mask, causal, scale)
    got = _launch_allheads(q, k, v, kv_mask, causal, scale, with_stats)
    _count(flash_attention_allheads, q)
    return got


def flash_attention_allheads_bwd(q, k, v, kv_mask, out, dout, *,
                                 causal=False, scale=None, row_max=None,
                                 row_sum=None):
    """K3: (dq, dk, dv) of K1 for the cotangent ``dout``; ``out`` is K1's
    output for the same inputs. Each in q's dtype and shape.
    ``row_max``/``row_sum``: K1's row stats for the same inputs
    (``flash_attention_allheads_stats``), (B, H, Sq) fp32, or None. The
    wgmma bodies (bf16, fp16) and the plain version start from them instead
    of computing them (the wgmma bodies with the same bits: they compute
    them with K1's body); the fp32 body recomputes the softmax."""
    name = "flash_attention_allheads_bwd"
    _check(name, q, k, v, kv_mask)
    if (row_max is None) != (row_sum is None):
        raise ValueError(f"{name}: give both row_max and row_sum, or neither")
    if row_max is not None:
        _check_stats(name, q, row_max, row_sum)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    out, dout = _check_out_dout(name, q, out, dout)
    if _plain(q):
        if row_max is not None:
            return flash_attention_blocked_bwd_reference(
                q, k, v, kv_mask, out, dout, row_max, row_sum, causal=causal,
                scale=scale)
        return allheads_attention_bwd_reference(q, k, v, kv_mask, out, dout,
                                                causal=causal, scale=scale)
    grads = _launch_allheads_bwd(q, k, v, kv_mask, out, dout, causal, scale,
                                 row_max, row_sum)
    _count(flash_attention_allheads_bwd, q)
    return grads


flash_attention_allheads_bwd.launches = 0
flash_attention_allheads_bwd.launches_tc = 0


class _AllheadsAttention(torch.autograd.Function):
    """K1 forward, K3 backward (the ``_allheads`` custom VJP,
    mmgl_tpu/ops/flash_attention.py:1382-1419). Where a gradient follows,
    the wgmma body of K1 also writes the rows' max and sum, and K3 starts
    from them (no stats pass)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, scale):
        with_stats = (not _plain(q) and _tensor_cores(q)
                      and any(ctx.needs_input_grad[:3]))
        out, row_max, row_sum = _allheads_forward(q, k, v, kv_mask, causal,
                                                  scale, with_stats)
        ctx.save_for_backward(q, k, v, kv_mask, out, row_max, row_sum)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_mask, out, row_max, row_sum = ctx.saved_tensors
        dq, dk, dv = flash_attention_allheads_bwd(
            q, k, v, kv_mask, out, dout, causal=ctx.causal, scale=ctx.scale,
            row_max=row_max, row_sum=row_sum)
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
    gradient runs K3. Where no gradient can flow (no grad mode, or no input
    requiring one: the eval pass, the frozen towers) it skips the autograd
    node, whose host cost is of the order of the kernel's."""
    _check("flash_attention_allheads", q, k, v, kv_mask)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _needs_grad(q, k, v):
        return _AllheadsAttention.apply(q, k, v, kv_mask, causal, scale)
    return _allheads_forward(q, k, v, kv_mask, causal, scale, False)[0]


flash_attention_allheads.launches = 0
flash_attention_allheads.launches_tc = 0


def flash_attention_allheads_stats(q, k, v, *, kv_mask=None, causal=False,
                                   scale=None):
    """K1 keeping the rows' softmax statistics, as K3 can start from them:
    (out, row_max, row_sum), the stats (B, H, Sq) fp32 (kept apart: a fully
    masked row has max -1e30 and sum Sk). On the card bf16 and fp16 only
    (the wgmma body). No autograd; a launch counts under
    ``flash_attention_allheads.launches``."""
    name = "flash_attention_allheads"
    _check(name, q, k, v, kv_mask)
    if not _plain(q) and not _tensor_cores(q):
        raise ValueError(f"{name}: the row stats come from the wgmma body; "
                         f"q is {q.dtype}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _allheads_forward(q, k, v, kv_mask, causal, scale, True)


class _FusedHeadsAttention(torch.autograd.Function):
    """K2 forward; the backward recomputes through the plain version
    (``_fused_heads_vjp_bwd``, mmgl_tpu/ops/flash_attention.py:1230-1238).
    ``forward`` with ctx None is K2 without autograd."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, scale):
        if ctx is not None:
            ctx.save_for_backward(q, k, v, kv_mask)
            ctx.causal, ctx.scale = causal, scale
        if _plain(q):
            return fused_heads_attention_reference(
                q, k, v, kv_mask=kv_mask, causal=causal, scale=scale)
        b, s, h, _ = q.shape
        out = _launch("mmgl_fused_heads_fwd", "fused_heads_attention", q, k,
                      v, kv_mask, causal, scale, b, s, h)
        _count(fused_heads_attention, q)
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
    """K2: self-attention (sq == sk) of any length, (B, S, H, D) out. Where
    no gradient can flow (CLIP's frozen tower) it skips the autograd node,
    as K1 does."""
    _check("fused_heads_attention", q, k, v, kv_mask)
    if k.shape[1] != q.shape[1]:
        raise ValueError("fused_heads_attention is self-attention: sq == sk")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _needs_grad(q, k, v):
        return _FusedHeadsAttention.apply(q, k, v, kv_mask, causal, scale)
    return _FusedHeadsAttention.forward(None, q, k, v, kv_mask, causal, scale)


fused_heads_attention.launches = 0
fused_heads_attention.launches_tc = 0


def _broadcast_kv(q, k, v):
    """K/V with a single head broadcast to q's heads, contiguous, as
    ``flash_attention`` broadcasts them outside its kernel (:1462); the
    gradient of ``expand`` sums dK/dV over the heads, the VJP of
    ``broadcast_to``."""
    b, sk, h, d = q.shape[0], k.shape[1], q.shape[2], q.shape[3]
    if k.shape[2] == 1 and h > 1:
        k = k.expand(b, sk, h, d).contiguous()
        v = v.expand(b, sk, h, v.shape[-1]).contiguous()
    return k, v


def flash_attention_bwd(q, k, v, kv_mask, out, dout, *, causal=False,
                        scale=None):
    """K5: (dq, dk, dv) of K4 for the cotangent ``dout``; ``out`` is K4's
    output for the same inputs (k/v with q's heads)."""
    name = "flash_attention_bwd"
    _check(name, q, k, v, kv_mask, allow_sq_gt_sk=not causal)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    out, dout = _check_out_dout(name, q, out, dout)
    if _plain(q):
        return flash_attention_bwd_reference(q, k, v, kv_mask, out, dout,
                                             causal=causal, scale=scale)
    grads = _launch_bwd("mmgl_flash_bwd", name, q, k, v, kv_mask, out, dout,
                        causal, scale)
    _count(flash_attention_bwd, q)
    return grads


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_tc = 0


def _check_stats(name, q, row_max, row_sum):
    """K4's row statistics as K6 takes them: (B, H, Sq), and on the card
    fp32 on q's device, contiguous."""
    want = (q.shape[0], q.shape[2], q.shape[1])
    for t in (row_max, row_sum):
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: row stats {tuple(t.shape)} are not "
                             f"(B, H, Sq) = {want}")
        if not _plain(q) and (t.dtype != torch.float32
                              or t.device != q.device):
            raise ValueError(f"{name}: row stats must be float32 on "
                             f"{q.device}, got {t.dtype} on {t.device}")
    if not _plain(q):
        _check_layout(name, row_max, row_sum)


def _launch_blocked_bwd(q, k, v, kv_mask, out, dout, row_max, row_sum,
                        causal, scale):
    """Run K6's launcher (its tensor-core entry for bf16 and fp16) on the
    current stream; returns (dq, dk, dv)."""
    b, sq, h, d = q.shape
    mask = _int_mask(q, k, kv_mask)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(b * h * sq, dtype=torch.float32, device=q.device)
    _call(q, _lib_fn(_entry("mmgl_blocked_bwd", q)),
          "flash_attention_blocked_bwd", q.data_ptr(), k.data_ptr(),
          v.data_ptr(), mask.data_ptr(), out.data_ptr(), dout.data_ptr(),
          row_max.data_ptr(), row_sum.data_ptr(), dq.data_ptr(),
          dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), b, sq, k.shape[1],
          h, d, scale, causal, _DTYPE_CODE[q.dtype])
    return dq, dk, dv


def flash_attention_blocked_bwd(q, k, v, kv_mask, out, dout, row_max,
                                row_sum, *, causal=True, scale=None):
    """K6: (dq, dk, dv) of K4 for the cotangent ``dout``, from ``out`` and
    the row max and sum K4 kept for the same inputs
    (``flash_attention_stats``); no pass recomputes them. Each gradient in
    q's dtype and shape."""
    name = "flash_attention_blocked_bwd"
    _check(name, q, k, v, kv_mask, allow_sq_gt_sk=not causal)
    _check_stats(name, q, row_max, row_sum)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    out, dout = _check_out_dout(name, q, out, dout)
    if _plain(q):
        return flash_attention_blocked_bwd_reference(
            q, k, v, kv_mask, out, dout, row_max, row_sum, causal=causal,
            scale=scale)
    grads = _launch_blocked_bwd(q, k, v, kv_mask, out, dout, row_max,
                                row_sum, causal, scale)
    _count(flash_attention_blocked_bwd, q)
    return grads


flash_attention_blocked_bwd.launches = 0
flash_attention_blocked_bwd.launches_tc = 0


def _launch_flash(q, k, v, kv_mask, causal, scale, with_stats):
    """Run K4 on the current stream, K1's launch path: (out, row_max,
    row_sum), the stats (B, H, Sq) fp32 where ``with_stats``, else None.
    The wgmma body (bf16, fp16) takes no mask as a null pointer; the
    scalar body (fp32) reads one."""
    b, sq, h, d = q.shape
    out = torch.empty_like(q)
    stats = _empty_stats(q) if with_stats else (None, None)
    mask, mask_ptr = _mask_arg(kv_mask)
    entry = "mmgl_flash_fwd_tc"
    if not _tensor_cores(q):
        entry = "mmgl_flash_fwd"
        if mask is None:
            mask, mask_ptr = _mask_arg(_int_mask(q, k, None))
    _call(q, _lib_fn(entry), "flash_attention", q.data_ptr(), k.data_ptr(),
          v.data_ptr(), mask_ptr, out.data_ptr(), *(_ptr(t) for t in stats),
          b, sq, k.shape[1], h, d, scale, causal, _DTYPE_CODE[q.dtype])
    return (out,) + stats


def _flash_forward(q, k, v, kv_mask, causal, scale, with_stats):
    """K4 (or its plain version on the CPU): (out, row_max, row_sum), the
    stats None unless ``with_stats``."""
    if _plain(q):
        got = flash_attention_reference(q, k, v, kv_mask=kv_mask,
                                        causal=causal, scale=scale,
                                        with_stats=with_stats)
        return got if with_stats else (got, None, None)
    got = _launch_flash(q, k, v, kv_mask, causal, scale, with_stats)
    _count(flash_attention, q)
    return got


class _FlashAttention(torch.autograd.Function):
    """K4 forward; K6 backward where ``blocked`` (causal, BLOCKED_BWD), from
    the row stats the forward kept, else K5 (the ``_flash`` custom VJP,
    mmgl_tpu/ops/flash_attention.py:503-525)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, scale, blocked):
        out, row_max, row_sum = _flash_forward(q, k, v, kv_mask, causal,
                                               scale, blocked)
        ctx.save_for_backward(q, k, v, kv_mask, out, row_max, row_sum)
        ctx.causal, ctx.scale, ctx.blocked = causal, scale, blocked
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_mask, out, row_max, row_sum = ctx.saved_tensors
        if ctx.blocked:
            dq, dk, dv = flash_attention_blocked_bwd(
                q, k, v, kv_mask, out, dout, row_max, row_sum,
                causal=ctx.causal, scale=ctx.scale)
        else:
            dq, dk, dv = flash_attention_bwd(q, k, v, kv_mask, out, dout,
                                             causal=ctx.causal,
                                             scale=ctx.scale)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    kv_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """K4: attention over BSHD tensors without bias or dropout, any sq and
    sk (sq <= sk when causal, ends aligned), K/V with q's heads or one
    broadcast head; (B, Sq, H, D) out. Its gradient runs K5, or K6 for
    causal attention under ``BLOCKED_BWD``; K4 then keeps the rows' stats,
    only where a gradient will be taken (JAX writes the LSE only in the
    VJP's forward). Where no gradient can flow (T5's test pass) it skips
    the autograd node, as K1 does."""
    k, v = _broadcast_kv(q, k, v)
    _check("flash_attention", q, k, v, kv_mask, allow_sq_gt_sk=not causal)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not _needs_grad(q, k, v):
        return _flash_forward(q, k, v, kv_mask, causal, scale, False)[0]
    return _FlashAttention.apply(q, k, v, kv_mask, causal, scale,
                                 causal and BLOCKED_BWD)


flash_attention.launches = 0
flash_attention.launches_tc = 0


def flash_attention_stats(q, k, v, *, kv_mask=None, causal=False,
                          scale=None):
    """K4 keeping the rows' softmax statistics, as the blocked backward
    needs them: (out, row_max, row_sum), the stats (B, H, Sq) fp32. No
    autograd; a launch counts under ``flash_attention.launches``."""
    k, v = _broadcast_kv(q, k, v)
    _check("flash_attention", q, k, v, kv_mask, allow_sq_gt_sk=not causal)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _flash_forward(q, k, v, kv_mask, causal, scale, True)


def _dropout_args(rate, seed, q):
    """(seed or None, threshold, keep_inv) of a dropout rate; raises
    without a seed where the rate drops anything."""
    thr = dropout_threshold(rate)
    if thr is None:
        return None, 0, 1.0
    if seed is None:
        raise ValueError("dropout_rate > 0 needs dropout_seed")
    if seed.shape != (2,) or seed.dtype != torch.int64:
        raise ValueError(f"dropout_seed must be a (2,) int64 tensor, got "
                         f"{tuple(seed.shape)} {seed.dtype}")
    if not _plain(q):
        if seed.device != q.device:
            raise ValueError(f"dropout_seed on {seed.device}, q on "
                             f"{q.device}")
        _check_layout("flash_attention_bias", seed)
    return seed, thr[0], thr[1]


def _check_bias(name, q, k, bias):
    """The kernels' bias: (H, Sq, Sk), its rows contiguous and evenly
    spaced (``_bias_ld``: contiguous, or a view of rows padded at their
    end), in fp32 or in q's dtype (the fp32 body also takes a bf16
    bias)."""
    if bias is None:
        return
    b, sq, h, _ = q.shape
    if tuple(bias.shape) != (h, sq, k.shape[1]):
        raise ValueError(f"{name}: bias {tuple(bias.shape)} is not (H, Sq, "
                         f"Sk) = {(h, sq, k.shape[1])}")
    if _plain(q):
        return
    allowed = ((torch.float32, torch.bfloat16) if q.dtype == torch.float32
               else (torch.float32, q.dtype))
    if bias.dtype not in allowed or bias.device != q.device:
        raise ValueError(
            f"{name}: bias must be {' or '.join(map(str, allowed))} on "
            f"{q.device} for {q.dtype} inputs, got {bias.dtype} on "
            f"{bias.device}")
    if _bias_ld(bias) is None:
        raise ValueError(f"{name}: the bias's rows must be contiguous and "
                         f"evenly spaced, got strides {bias.stride()}")
    if bias.data_ptr() % 16:
        raise ValueError(f"{name}: inputs must be 16-byte aligned")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _bias_ld(bias):
    """The row stride of an (H, Sq, Sk) bias whose rows the kernels can read
    in place: each row contiguous, the rows of a head ``ld >= Sk`` elements
    apart, the heads Sq rows apart (a contiguous bias, ld = Sk, or a view
    of one padded at the end of its rows, ``padded_bias``); None for any
    other layout."""
    h, sq, sk = bias.shape
    st = bias.stride()
    if (sk > 1 and st[2] != 1) or st[1] < sk or (h > 1
                                                 and st[0] != sq * st[1]):
        return None
    return st[1]


def padded_bias(bias):
    """``bias`` (..., Sq, Sk) as a view of rows padded with zeros to a
    multiple of 8 elements, the layout the tensor-core bodies read (K7's
    TMA and K8/K9's 16-byte copies take rows that start on 16 bytes): a
    model builds it once a stack, where the bias is made, so that no layer
    pads it. ``bias`` itself where Sk is a multiple of 8. Its gradient is
    the view's, cut back to Sk columns."""
    sk = bias.shape[-1]
    ld = -(-sk // 8) * 8
    if ld == sk:
        return bias
    return torch.nn.functional.pad(bias, (0, ld - sk))[..., :sk]


def _tile_rows(bias):
    """(bias, row stride) as the tensor-core bodies take an (H, Sq, Sk)
    bias: its rows padded to a multiple of 8 elements, in place where they
    are (``padded_bias``, once a stack), else padded here; (None, 0)
    without a bias."""
    if bias is None:
        return None, 0
    ld = _bias_ld(bias)
    if ld % 8:
        bias = padded_bias(bias.contiguous())
        ld = _bias_ld(bias)
    return bias, ld


def _empty_stats(q):
    """Two (B, H, Sq) fp32 tensors for a kernel's row max and sum."""
    b, sq, h, _ = q.shape
    return tuple(torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
                 for _ in range(2))


def _launch_bias(q, k, v, kv_mask, bias, seed, causal, scale, thr, keep_inv,
                 with_stats):
    """Run K7 on the current stream, K1's launch path: (out, row_max,
    row_sum), the stats (B, H, Sq) fp32 where ``with_stats`` (the wgmma
    body, bf16 and fp16), else None. The wgmma body reads the bias in place
    where its rows are padded to a multiple of 8 (``_tile_rows``) and takes
    no mask as a null pointer; the scalar body (fp32) reads a contiguous
    bias and a mask."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    out = torch.empty_like(q)
    mask, mask_ptr = _mask_arg(kv_mask)
    codes = (_DTYPE_CODE[q.dtype],
             _DTYPE_CODE[bias.dtype] if bias is not None else 0)
    if _tensor_cores(q):
        stats = _empty_stats(q) if with_stats else (None, None)
        bias, ld = _tile_rows(bias)
        _call(q, _lib_fn("mmgl_bias_fwd_tc"), "flash_attention_bias",
              q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, _ptr(bias),
              _ptr(seed), out.data_ptr(), *(_ptr(t) for t in stats), b, sq,
              sk, h, d, scale, causal, thr, keep_inv, *codes, ld)
        return (out,) + stats
    if mask is None:
        mask, mask_ptr = _mask_arg(_int_mask(q, k, None))
    if bias is not None:
        bias = bias.contiguous()
    _call(q, _lib_fn("mmgl_bias_fwd"), "flash_attention_bias", q.data_ptr(),
          k.data_ptr(), v.data_ptr(), mask_ptr, _ptr(bias), _ptr(seed),
          out.data_ptr(), b, sq, sk, h, d, scale, causal, thr, keep_inv,
          *codes)
    return out, None, None


def _launch_bias_bwd(q, k, v, kv_mask, bias, seed, out, dout, causal, scale,
                     thr, keep_inv, *stats):
    """Run K8/K9's launcher (its tensor-core entry for bf16 and fp16) on the
    current stream; returns (dq, dk, dv, dbias). ``stats``: K7's row max
    and sum, from which the tensor-core body starts instead of its stats
    pass, or none. dbias is summed over the batch from a per-(b, h) fp32 partial of
    dlogits in a fixed order (no atomics): B * H * Sq * Sk * 4 bytes of
    scratch, 50,331,648 at T5-base's encoder shape (4, 12, 512, 512), which
    the tensor-core body writes whole (the scalar body needs it zeroed: it
    skips the causally hidden tiles)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    tc = _tensor_cores(q)
    mask = _int_mask(q, k, kv_mask)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    scratch = torch.empty(3 * b * h * sq, dtype=torch.float32,
                          device=q.device)
    dbias = partial = None
    if bias is not None:
        dbias = torch.empty(bias.shape, dtype=bias.dtype, device=q.device)
        partial = (torch.empty if tc else torch.zeros)(
            b * h * sq * sk, dtype=torch.float32, device=q.device)
    codes = (_DTYPE_CODE[q.dtype],
             _DTYPE_CODE[bias.dtype] if bias is not None else 0)
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr())
    grads = (out.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), _ptr(dbias), scratch.data_ptr(), _ptr(partial))
    name = "flash_attention_bias_bwd"
    if tc:
        bias, ld = _tile_rows(bias)
        _call(q, _lib_fn("mmgl_bias_bwd_tc"), name, *common, _ptr(bias),
              _ptr(seed), *grads, *(_ptr(t) for t in (stats or (None, None))),
              b, sq, sk, h, d, scale, causal, thr, keep_inv, *codes, ld)
    else:
        if bias is not None:
            bias = bias.contiguous()
        _call(q, _lib_fn("mmgl_bias_bwd"), name, *common, _ptr(bias),
              _ptr(seed), *grads, b, sq, sk, h, d, scale, causal, thr,
              keep_inv, *codes)
    return dq, dk, dv, dbias


def flash_attention_bias_bwd(q, k, v, kv_mask, bias, out, dout, *,
                             causal=False, scale=None, dropout_rate=0.0,
                             dropout_seed=None, row_max=None, row_sum=None):
    """K8/K9: (dq, dk, dv, dbias) of K7 for the cotangent ``dout``, with
    ``out`` K7's output for the same inputs and dropout key. bias is
    (H, Sq, Sk) or None; dbias is (H, Sq, Sk) in the bias dtype, summed over
    the batch, or None without a bias. ``row_max``/``row_sum``: K7's row
    stats for the same inputs (``flash_attention_bias_stats``), (B, H, Sq)
    fp32, or None; the tensor-core body starts from them instead of
    its stats pass, with the same bits, and the fp32 body and the plain
    version recompute the softmax."""
    name = "flash_attention_bias_bwd"
    _check(name, q, k, v, kv_mask, allow_sq_gt_sk=not causal)
    _check_bias(name, q, k, bias)
    if (row_max is None) != (row_sum is None):
        raise ValueError(f"{name}: give both row_max and row_sum, or neither")
    stats = () if row_max is None else (row_max, row_sum)
    if stats:
        _check_stats(name, q, *stats)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    seed, thr, keep_inv = _dropout_args(dropout_rate, dropout_seed, q)
    out, dout = _check_out_dout(name, q, out, dout)
    if _plain(q):
        dq, dk, dv, dbias = bias_attention_bwd_reference(
            q, k, v, kv_mask, None if bias is None else bias[None], out, dout,
            causal=causal, scale=scale, dropout_rate=dropout_rate,
            dropout_seed=seed)
        return dq, dk, dv, None if dbias is None else dbias[0]
    grads = _launch_bias_bwd(q, k, v, kv_mask, bias, seed, out, dout, causal,
                             scale, thr, keep_inv,
                             *(stats if _tensor_cores(q) else ()))
    _count(flash_attention_bias_bwd, q)
    return grads


flash_attention_bias_bwd.launches = 0
flash_attention_bias_bwd.launches_tc = 0


def _bias_forward(q, k, v, kv_mask, bias, seed, causal, scale, rate,
                  with_stats):
    """K7 (or its plain version on the CPU): (out, row_max, row_sum), the
    stats None unless ``with_stats`` (on the card, bf16 and fp16 only: the
    fp32 scalar body keeps none)."""
    if _plain(q):
        got = bias_attention_reference(
            q, k, v, bias=None if bias is None else bias[None],
            kv_mask=kv_mask, causal=causal, scale=scale, dropout_rate=rate,
            dropout_seed=seed, with_stats=with_stats)
        return got if with_stats else (got, None, None)
    if with_stats and not _tensor_cores(q):
        raise ValueError("flash_attention_bias: the row stats come from the "
                         "tensor-core body; q is " + str(q.dtype))
    # the key was checked by _bias_args; rate is 0 without one
    thr, keep_inv = dropout_threshold(rate) or (0, 1.0)
    got = _launch_bias(q, k, v, kv_mask, bias, seed, causal, scale, thr,
                       keep_inv, with_stats)
    _count(flash_attention_bias, q)
    return got


class _BiasAttention(torch.autograd.Function):
    """K7 forward, K8/K9 backward (the ``_flash_bias`` custom VJP,
    mmgl_tpu/ops/flash_attention.py:1043-1066), from K7's row stats where
    ``with_stats``. bias is (H, Sq, Sk) or None; seed the dropout key or
    None."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, bias, seed, causal, scale, rate,
                with_stats):
        out, row_max, row_sum = _bias_forward(q, k, v, kv_mask, bias, seed,
                                              causal, scale, rate, with_stats)
        ctx.save_for_backward(q, k, v, kv_mask, bias, seed, out, row_max,
                              row_sum)
        ctx.causal, ctx.scale, ctx.rate = causal, scale, rate
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_mask, bias, seed, out, row_max, row_sum = \
            ctx.saved_tensors
        dq, dk, dv, dbias = flash_attention_bias_bwd(
            q, k, v, kv_mask, bias, out, dout, causal=ctx.causal,
            scale=ctx.scale, dropout_rate=ctx.rate, dropout_seed=seed,
            row_max=row_max, row_sum=row_sum)
        return dq, dk, dv, None, dbias, None, None, None, None, None


def _bias_args(name, q, k, v, bias, kv_mask, causal, scale, dropout_rate,
               dropout_seed):
    """K7's inputs as its body takes them: (k, v, bias, scale, seed, rate)
    with a broadcast K/V head and bias head expanded, the bias (H, Sq, Sk)
    read in place where its rows are (T5's, built once a stack, with every
    head and rows padded by ``padded_bias``: no copy a call), and rate 0
    where nothing is dropped."""
    k, v = _broadcast_kv(q, k, v)
    _check(name, q, k, v, kv_mask, allow_sq_gt_sk=not causal)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if bias is not None:
        if bias.dim() != 4 or bias.shape[0] != 1:
            raise ValueError(f"{name}: the kernel takes a batch-shared "
                             f"(1, H, Sq, Sk) bias, got {tuple(bias.shape)}")
        h = q.shape[2]
        bias = bias[0]
        if bias.shape[0] != h:
            # a broadcast head is expanded; the gradient sums it back
            bias = bias.expand(h, *bias.shape[1:]).contiguous()
        elif _bias_ld(bias) is None:
            bias = bias.contiguous()
        _check_bias(name, q, k, bias)
    seed, _, _ = _dropout_args(dropout_rate, dropout_seed, q)
    return k, v, bias, scale, seed, dropout_rate if seed is not None else 0.0


def flash_attention_bias(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K7: attention over BSHD tensors with a batch-shared additive bias
    (1, H or 1, Sq, Sk) in fp32 or q's dtype, or none, and attention-prob
    dropout at ``dropout_rate`` under the (2,) int64 key ``dropout_seed``
    (``attention.draw_dropout_seed``); (B, Sq, H, D) out. Its gradient runs
    K8/K9 and reaches the bias; in bf16 or fp16 on the card K7 then keeps the
    rows' stats for it, only where a gradient will be taken (JAX's custom
    VJP saves only the output); where none can flow it skips the autograd
    node. A bias with rows padded at their end (``padded_bias``) is read in
    place."""
    k, v, bias, scale, seed, rate = _bias_args(
        "flash_attention_bias", q, k, v, bias, kv_mask, causal, scale,
        dropout_rate, dropout_seed)
    if not (_needs_grad(q, k, v) or (torch.is_grad_enabled()
                                     and bias is not None
                                     and bias.requires_grad)):
        # no gradient can flow (the test pass): no autograd node, no stats
        return _bias_forward(q, k, v, kv_mask, bias, seed, causal, scale,
                             rate, False)[0]
    with_stats = not _plain(q) and _tensor_cores(q)
    return _BiasAttention.apply(q, k, v, kv_mask, bias, seed, causal, scale,
                                rate, with_stats)


flash_attention_bias.launches = 0
flash_attention_bias.launches_tc = 0


def flash_attention_bias_stats(q, k, v, *, bias=None, kv_mask=None,
                               causal=False, scale=None, dropout_rate=0.0,
                               dropout_seed=None):
    """K7 keeping the rows' softmax statistics, as K8/K9 can start from
    them: (out, row_max, row_sum), the stats (B, H, Sq) fp32 (kept apart,
    as K4's). On the card bf16 and fp16 only. No autograd; a launch counts
    under
    ``flash_attention_bias.launches``."""
    k, v, bias, scale, seed, rate = _bias_args(
        "flash_attention_bias", q, k, v, bias, kv_mask, causal, scale,
        dropout_rate, dropout_seed)
    return _bias_forward(q, k, v, kv_mask, bias, seed, causal, scale, rate,
                         True)
