"""mmgl_tpu_torch attention against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both frameworks; JAX
runs on the CPU at "highest" matmul precision (conftest.py), the Pallas
kernels in interpret mode as tests/test_attention.py runs them, and the
port's kernel wrappers take their plain versions because the tensors lie on
the CPU. Everything is fp32; the tolerance is atol 1e-5 (sums in another
order), rtol 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmgl_tpu.ops.attention import xla_attention
from mmgl_tpu.ops.flash_attention import (
    flash_attention_allheads as jax_allheads,
    fused_heads_attention as jax_fused_heads)
from mmgl_tpu_torch.ops import attention as att
from mmgl_tpu_torch.ops import flash_attention as fa

ATOL = 1e-5


def _inputs(b, sq, sk, h, d, seed, kv_heads=None, mask_p=0.25):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, sq, h, d).astype(np.float32)
    k = rng.randn(b, sk, kv_heads or h, d).astype(np.float32)
    v = rng.randn(b, sk, kv_heads or h, d).astype(np.float32)
    mask = (rng.uniform(size=(b, sk)) > mask_p).astype(np.int32)
    return q, k, v, mask


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("case", [
    "noncausal", "causal", "fully_masked_row", "sk_gt_sq_causal",
    "kv_broadcast", "no_mask"])
def test_attention_reference_matches_xla_attention(case):
    b, sq, sk, h, d = 2, 24, 24, 3, 16
    causal, kv_heads = False, None
    if case == "causal":
        causal = True
    if case == "sk_gt_sq_causal":
        sk, causal = 40, True
    if case == "kv_broadcast":
        kv_heads = 1
    q, k, v, mask = _inputs(b, sq, sk, h, d, seed=3, kv_heads=kv_heads)
    if case == "fully_masked_row":
        mask[1] = 0
    if case == "no_mask":
        mask = None
    want = xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         kv_mask=None if mask is None else jnp.asarray(mask),
                         causal=causal)
    tq, tk, tv = _t(q, k, v)
    got = att.attention_reference(
        tq, tk, tv, kv_mask=None if mask is None else torch.from_numpy(mask),
        causal=causal)
    _close(got, want)


def test_attention_reference_pairwise_mask_and_bias():
    q, k, v, mask = _inputs(2, 16, 16, 2, 8, seed=4)
    rng = np.random.RandomState(5)
    pairwise = (rng.uniform(size=(2, 16, 16)) > 0.3).astype(np.int32)
    bias = rng.randn(1, 2, 16, 16).astype(np.float32)
    want = xla_attention(*map(jnp.asarray, (q, k, v)),
                         kv_mask=jnp.asarray(mask),
                         pairwise_mask=jnp.asarray(pairwise),
                         bias=jnp.asarray(bias))
    got = att.attention_reference(*_t(q, k, v), kv_mask=torch.from_numpy(mask),
                                  pairwise_mask=torch.from_numpy(pairwise),
                                  bias=torch.from_numpy(bias))
    _close(got, want)


@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("causal", [False, True])
def test_allheads_matches_jax_pallas_kernel(s, causal):
    """K1 on CPU tensors (its plain version) vs the Pallas K1 in interpret
    mode, including a fully masked sample."""
    q, k, v, mask = _inputs(2, s, s, 2, 64, seed=s + causal)
    mask[1] = 0
    want = jax_allheads(*map(jnp.asarray, (q, k, v)),
                        kv_mask=jnp.asarray(mask), causal=causal,
                        interpret=True)
    before = fa.flash_attention_allheads.launches
    got = fa.flash_attention_allheads(*_t(q, k, v),
                                      kv_mask=torch.from_numpy(mask),
                                      causal=causal)
    assert fa.flash_attention_allheads.launches == before  # nothing launched
    _close(got, want)


@pytest.mark.parametrize("s", [77, 100])
@pytest.mark.parametrize("causal", [False, True])
def test_fused_heads_matches_jax_pallas_kernel(s, causal):
    """K2 on CPU tensors vs the Pallas K2 in interpret mode. Key 0 stays
    valid, so no row is fully masked: there the two differ on purpose (see
    the next test)."""
    q, k, v, mask = _inputs(3, s, s, 2, 64, seed=s + causal)
    mask[:, 0] = 1
    want = jax_fused_heads(*map(jnp.asarray, (q, k, v)),
                           kv_mask=jnp.asarray(mask), causal=causal,
                           interpret=True)
    got = fa.fused_heads_attention(*_t(q, k, v),
                                   kv_mask=torch.from_numpy(mask),
                                   causal=causal)
    _close(got, want)


def test_fused_heads_fully_masked_row_follows_xla_attention():
    """A fully masked row averages V over the S real keys, as xla_attention
    (the package's reference) gives. The Pallas K2 pads S to 128 with masked
    zero keys first (mmgl_tpu/ops/flash_attention.py:1178-1181), so there it
    averages over 128 slots; the port follows xla_attention, not that."""
    q, k, v, mask = _inputs(2, 77, 77, 2, 64, seed=9)
    mask[0] = 0
    want = xla_attention(*map(jnp.asarray, (q, k, v)),
                         kv_mask=jnp.asarray(mask))
    got = fa.fused_heads_attention(*_t(q, k, v),
                                   kv_mask=torch.from_numpy(mask))
    _close(got, want)
    np.testing.assert_allclose(got[0].numpy(),
                               np.broadcast_to(v[0].mean(0), (77, 2, 64)),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("q_shape,k_shape,kw,route", [
    ((4, 640, 12, 64), (4, 640, 12, 64), {}, "allheads"),      # OPT eval
    ((4, 512, 12, 64), (4, 512, 12, 64), {}, "allheads"),      # prefill
    ((24, 197, 12, 64), (24, 197, 12, 64), {}, "fused_heads"),  # CLIP
    ((4, 1, 12, 64), (4, 544, 12, 64), {}, "reference"),       # decode
    ((4, 17, 2, 16), (4, 17, 2, 16), {}, "reference"),         # tiny tower
    ((2, 128, 2, 64), (2, 128, 2, 64), {"pairwise_mask": True}, "reference"),
    ((2, 128, 2, 64), (2, 128, 2, 64), {"bias": True}, "K7"),
    ((2, 128, 2, 64), (2, 128, 2, 64), {"dropout": True}, "K7"),
    ((2, 128, 2, 64), (2, 256, 2, 64), {}, "K4"),              # sq != sk
    ((2, 128, 2, 64), (2, 128, 1, 64), {}, "K4"),              # MQA
])
def test_dispatch_route(q_shape, k_shape, kw, route):
    if route in ("K4", "K7"):
        with pytest.raises(NotImplementedError, match=route):
            att.attention_route(q_shape, k_shape, **kw)
    else:
        assert att.attention_route(q_shape, k_shape, **kw) == route


@pytest.mark.parametrize("s,kernel", [(128, "flash_attention_allheads"),
                                      (100, "fused_heads_attention")])
def test_multi_head_attention_calls_the_kernel_wrapper(monkeypatch, s,
                                                       kernel):
    calls = []
    orig = getattr(fa, kernel)

    def spy(*a, **kw):
        calls.append(kernel)
        return orig(*a, **kw)

    monkeypatch.setattr(fa, kernel, spy)
    q, k, v, mask = _inputs(2, s, s, 2, 64, seed=11)
    got = att.multi_head_attention(*_t(q, k, v),
                                   kv_mask=torch.from_numpy(mask),
                                   causal=True)
    assert calls == [kernel]
    want = xla_attention(*map(jnp.asarray, (q, k, v)),
                         kv_mask=jnp.asarray(mask), causal=True)
    _close(got, want)


def test_multi_head_attention_raises_for_unported_kernels():
    q, k, v, _ = _inputs(1, 64, 64, 2, 64, seed=12)
    tq, tk, tv = _t(q, k, v)
    with pytest.raises(NotImplementedError, match="K7"):
        att.multi_head_attention(tq, tk, tv, bias=torch.zeros(1, 2, 64, 64))
    with pytest.raises(NotImplementedError, match="K4"):
        att.multi_head_attention(tq, tk[:, :, :1], tv[:, :, :1])


def test_wrappers_check_their_inputs():
    q, k, v, mask = _t(*_inputs(2, 128, 128, 2, 64, seed=13))
    with pytest.raises(ValueError, match="kv_mask"):
        fa.flash_attention_allheads(q, k, v, kv_mask=mask[:, :64])
    with pytest.raises(ValueError, match="sq == sk"):
        fa.fused_heads_attention(q[:, :100], k, v)
    with pytest.raises(ValueError, match="BSHD"):
        fa.flash_attention_allheads(q[0], k, v)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No fallback: a host without nvcc cannot build the kernels and says
    so, instead of running something else."""
    from mmgl_tpu_torch.ops import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


# ---- gradients: K3 and the autograd wiring ---------------------------------

def _hole_mask(b, s, seed):
    """A prompt then a summary, each right-padded: key 0 stays valid, so no
    causal row is fully masked."""
    rng = np.random.RandomState(seed)
    mask = np.ones((b, s), np.int32)
    cut = s * 3 // 4
    for i in range(b):
        mask[i, rng.randint(cut // 4, cut):cut] = 0
        mask[i, cut + rng.randint(1, s - cut):] = 0
    return mask


def _weighted_sum(out, cos=torch.cos):
    """A scalar whose gradient reaches every output element unevenly."""
    return (out * cos(out)).sum()


@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("causal", [False, True])
def test_allheads_grads_match_jax_pallas_backward(s, causal):
    """autograd through K1 on CPU tensors (K3's plain version) vs jax.grad
    through the Pallas K1/K3 in interpret mode, with hole masks, D = 64;
    atol 1e-5."""
    q, k, v, _ = _inputs(2, s, s, 2, 64, seed=20 + s + causal)
    mask = _hole_mask(2, s, seed=s)

    def jloss(q, k, v):
        return _weighted_sum(jax_allheads(
            q, k, v, kv_mask=jnp.asarray(mask), causal=causal,
            interpret=True), jnp.cos)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = fa.flash_attention_allheads(tq, tk, tv,
                                      kv_mask=torch.from_numpy(mask),
                                      causal=causal)
    assert out.grad_fn is not None
    got = torch.autograd.grad(_weighted_sum(out), (tq, tk, tv))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mask_kind", ["hole", "fully_masked"])
def test_allheads_bwd_reference_matches_autograd(causal, mask_kind):
    """K3's plain version equals torch autograd through
    attention_reference (atol 1e-5), fully masked rows included: there dS
    is 0 at every masked logit and dV still takes the uniform 1/Sk."""
    q, k, v, _ = _inputs(2, 96, 96, 2, 64, seed=30 + causal)
    mask = _hole_mask(2, 96, seed=3)
    if mask_kind == "fully_masked":
        mask[1] = 0
    tmask = torch.from_numpy(mask)
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = att.attention_reference(tq, tk, tv, kv_mask=tmask, causal=causal)
    dout = torch.from_numpy(
        np.random.RandomState(4).randn(*out.shape).astype(np.float32))
    want = torch.autograd.grad(out, (tq, tk, tv), dout)
    got = fa.allheads_attention_bwd_reference(
        tq.detach(), tk.detach(), tv.detach(), tmask, out.detach(), dout,
        causal=causal)
    for g, w in zip(got, want):
        _close(g, w)


def test_allheads_fully_masked_row_grads_follow_xla_attention():
    """With a fully masked sample the port's gradients are jax.grad's
    through xla_attention (no dQ, no dK from that sample; dV of 1/Sk per
    row), not the Pallas K3's, which keeps dS at masked logits; atol 1e-5."""
    q, k, v, _ = _inputs(2, 128, 128, 2, 64, seed=40)
    mask = _hole_mask(2, 128, seed=5)
    mask[0] = 0

    def jloss(q, k, v):
        return _weighted_sum(xla_attention(q, k, v, kv_mask=jnp.asarray(mask),
                                           causal=True), jnp.cos)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = fa.flash_attention_allheads(tq, tk, tv,
                                      kv_mask=torch.from_numpy(mask),
                                      causal=True)
    got = torch.autograd.grad(_weighted_sum(out), (tq, tk, tv))
    for g, w in zip(got, want):
        _close(g, w)
    assert float(got[0][0].abs().max()) == 0.0
    assert float(got[1][0].abs().max()) == 0.0


def test_kernel_path_keeps_the_autograd_graph(monkeypatch):
    """On the card each wrapper writes its kernel's result into a fresh
    tensor. With that path taken on the CPU (the launchers replaced by
    their plain versions computed without autograd, as a kernel computes),
    K1 and K2 still return tensors with a grad_fn; K1's backward launches
    K3 once and K2's recomputes through its plain version, and their
    gradients equal jax.grad through the Pallas kernels in interpret mode
    (atol 1e-5)."""
    def fake_launch(fn, name, q, k, v, kv_mask, causal, scale, *shape):
        with torch.no_grad():
            return att.attention_reference(q, k, v, kv_mask=kv_mask,
                                           causal=causal, scale=scale).clone()

    def fake_launch_bwd(q, k, v, kv_mask, out, dout, causal, scale):
        return fa.allheads_attention_bwd_reference(q, k, v, kv_mask, out,
                                                   dout, causal, scale)

    monkeypatch.setattr(fa, "_plain", lambda q: False)
    monkeypatch.setattr(fa, "_launch", fake_launch)
    monkeypatch.setattr(fa, "_launch_bwd", fake_launch_bwd)

    for name, s, jax_kernel in (
            ("flash_attention_allheads", 128, jax_allheads),
            ("fused_heads_attention", 77, jax_fused_heads)):
        q, k, v, _ = _inputs(2, s, s, 2, 64, seed=s)
        mask = _hole_mask(2, s, seed=s)

        def jloss(q, k, v):
            return _weighted_sum(jax_kernel(q, k, v,
                                            kv_mask=jnp.asarray(mask),
                                            causal=True, interpret=True),
                                 jnp.cos)

        want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray,
                                                      (q, k, v)))
        tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
        kernel = getattr(fa, name)
        launches = (kernel.launches, fa.flash_attention_allheads_bwd.launches)
        out = kernel(tq, tk, tv, kv_mask=torch.from_numpy(mask), causal=True)
        assert out.grad_fn is not None, name
        got = torch.autograd.grad(_weighted_sum(out), (tq, tk, tv))
        assert kernel.launches == launches[0] + 1
        assert fa.flash_attention_allheads_bwd.launches == launches[1] + (
            name == "flash_attention_allheads")
        for g, w in zip(got, want):
            _close(g, w)
