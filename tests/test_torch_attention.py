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
    flash_attention as jax_flash,
    flash_attention_allheads as jax_allheads,
    flash_attention_bias as jax_flash_bias,
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


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


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
    """K7 (bias, dropout) and K4 (sq != sk, MQA) are routes of their own;
    the 128-query shapes take them too (no BIAS_MIN_SQ gate)."""
    want = {"K7": "bias", "K4": "flash"}.get(route, route)
    assert att.attention_route(q_shape, k_shape, **kw) == want


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


def test_multi_head_attention_raises_for_unported_kernels(monkeypatch):
    """The calls that raised while K7 and K4 were not ported (a bias, a
    broadcast K/V head) now reach their wrappers and agree with
    xla_attention; what still raises is attention dropout without a
    generator (atol 1e-5)."""
    q, k, v, _ = _inputs(1, 64, 64, 2, 64, seed=12)
    bias = np.random.RandomState(13).randn(1, 2, 64, 64).astype(np.float32)
    tq, tk, tv = _t(q, k, v)
    calls = []
    for name in ("flash_attention_bias", "flash_attention"):
        orig = getattr(fa, name)
        monkeypatch.setattr(fa, name, lambda *a, _o=orig, _n=name, **kw: (
            calls.append(_n), _o(*a, **kw))[1])
    got = att.multi_head_attention(tq, tk, tv, bias=torch.from_numpy(bias))
    _close(got, xla_attention(*map(jnp.asarray, (q, k, v)),
                              bias=jnp.asarray(bias)))
    got = att.multi_head_attention(tq, tk[:, :, :1], tv[:, :, :1])
    _close(got, xla_attention(*map(jnp.asarray, (q, k[:, :, :1],
                                                 v[:, :, :1]))))
    assert calls == ["flash_attention_bias", "flash_attention"]
    with pytest.raises(ValueError, match="generator"):
        att.multi_head_attention(tq, tk, tv, dropout_rate=0.1)


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
    K1, K2 and K4 still return tensors with a grad_fn; K1's backward
    launches K3 once, K4's (at sq < sk with a broadcast K/V head) K5 once,
    K2's recomputes through its plain version, and their gradients equal
    jax.grad through the Pallas kernels in interpret mode (atol 1e-5)."""
    def fake_launch(fn, name, q, k, v, kv_mask, causal, scale, *shape,
                    stats=()):
        with torch.no_grad():
            return att.attention_reference(q, k, v, kv_mask=kv_mask,
                                           causal=causal, scale=scale).clone()

    def fake_launch_bwd(q, k, v, kv_mask, out, dout, causal, scale):
        return fa.allheads_attention_bwd_reference(q, k, v, kv_mask, out,
                                                   dout, causal, scale)

    def fake_launch_fused(q, k, v, kv_mask, causal, scale):
        return fake_launch(None, None, q, k, v, kv_mask, causal, scale)

    def fake_launch_allheads(q, k, v, kv_mask, causal, scale, with_stats):
        return fake_launch(None, None, q, k, v, kv_mask, causal, scale), \
            None, None

    def fake_launch_flash(q, k, v, kv_mask, causal, scale, with_stats):
        out = fake_launch(None, None, q, k, v, kv_mask, causal, scale)
        if not with_stats:
            return out, None, None
        return (out,) + fa._row_stats(q, k, kv_mask, causal, scale)

    def fake_launch_allheads_bwd(q, k, v, kv_mask, out, dout, causal, scale,
                                 row_max, row_sum):
        return fake_launch_bwd(q, k, v, kv_mask, out, dout, causal, scale)

    monkeypatch.setattr(fa, "_plain", lambda q: False)
    monkeypatch.setattr(fa, "_launch_fused", fake_launch_fused)
    monkeypatch.setattr(fa, "_launch_bwd", fake_launch_bwd)
    monkeypatch.setattr(fa, "_launch_allheads", fake_launch_allheads)
    monkeypatch.setattr(fa, "_launch_allheads_bwd", fake_launch_allheads_bwd)
    monkeypatch.setattr(fa, "_launch_flash", fake_launch_flash)
    monkeypatch.setattr(fa, "_check_layout", lambda *a: None)

    # (kernel, its backward's wrapper, sq, sk, K/V heads, causal, Pallas)
    for name, bwd, sq, sk, kvh, causal, jax_kernel in (
            ("flash_attention_allheads", "flash_attention_allheads_bwd", 128,
             128, 2, True, jax_allheads),
            ("fused_heads_attention", None, 77, 77, 2, True,
             jax_fused_heads),
            ("flash_attention", "flash_attention_bwd", 48, 112, 1, False,
             jax_flash)):
        q, k, v, _ = _inputs(2, sq, sk, 2, 64, seed=sq, kv_heads=kvh)
        mask = _hole_mask(2, sk, seed=sq)

        def jloss(q, k, v):
            return _weighted_sum(jax_kernel(q, k, v,
                                            kv_mask=jnp.asarray(mask),
                                            causal=causal, interpret=True),
                                 jnp.cos)

        want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray,
                                                      (q, k, v)))
        tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
        kernel = getattr(fa, name)
        counts = [fa.flash_attention_allheads_bwd, fa.flash_attention_bwd]
        launches = (kernel.launches, [c.launches for c in counts])
        out = kernel(tq, tk, tv, kv_mask=torch.from_numpy(mask),
                     causal=causal)
        assert out.grad_fn is not None, name
        got = torch.autograd.grad(_weighted_sum(out), (tq, tk, tv))
        assert kernel.launches == launches[0] + 1
        assert [c.launches for c in counts] == [
            n + (c is getattr(fa, bwd or "fused_heads_attention"))
            for c, n in zip(counts, launches[1])], name
        for g, w in zip(got, want):
            _close(g, w)


# ---- K4/K5: per-head attention at sq != sk and MQA --------------------------

FLASH_CASES = [  # (B, Sq, Sk, H, kv_heads, causal)
    (2, 48, 112, 2, 2, False),      # T5's cross-attention shape, cut
    (2, 48, 112, 2, 2, True),       # causal with aligned ends
    (2, 64, 64, 3, 1, False),       # MQA: one K/V head broadcast
]


@pytest.mark.parametrize("b,sq,sk,h,kvh,causal", FLASH_CASES)
def test_flash_attention_matches_jax_pallas_kernel(b, sq, sk, h, kvh, causal):
    """K4 on CPU tensors (its plain version) vs the Pallas K4 in interpret
    mode, D = 64, a hole mask with key 0 valid; atol 1e-5."""
    q, k, v, _ = _inputs(b, sq, sk, h, 64, seed=sq + sk + kvh, kv_heads=kvh)
    mask = _hole_mask(b, sk, seed=sk)
    want = jax_flash(*map(jnp.asarray, (q, k, v)), kv_mask=jnp.asarray(mask),
                     causal=causal, interpret=True)
    before = fa.flash_attention.launches
    got = fa.flash_attention(*_t(q, k, v), kv_mask=torch.from_numpy(mask),
                             causal=causal)
    assert fa.flash_attention.launches == before
    _close(got, want)


@pytest.mark.parametrize("b,sq,sk,h,kvh,causal", FLASH_CASES)
def test_flash_attention_grads_match_jax_pallas_backward(b, sq, sk, h, kvh,
                                                         causal):
    """autograd through K4 (K5's plain version; under MQA dK/dV summed over
    the broadcast heads) vs jax.grad through the Pallas K4/K5 in interpret
    mode; atol 1e-5."""
    q, k, v, _ = _inputs(b, sq, sk, h, 64, seed=50 + sk + kvh, kv_heads=kvh)
    mask = _hole_mask(b, sk, seed=sq)

    def jloss(q, k, v):
        return _weighted_sum(jax_flash(q, k, v, kv_mask=jnp.asarray(mask),
                                       causal=causal, interpret=True), jnp.cos)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = fa.flash_attention(tq, tk, tv, kv_mask=torch.from_numpy(mask),
                             causal=causal)
    got = torch.autograd.grad(_weighted_sum(out), (tq, tk, tv))
    assert got[1].shape == tk.shape
    for g, w in zip(got, want):
        _close(g, w)


# ---- K7/K8/K9: bias attention ----------------------------------------------

BIAS_CASES = [  # (B, Sq, Sk, H, bias heads or 0 for none, causal)
    (2, 64, 64, 2, 2, False),       # T5's encoder self-attention, cut
    (2, 64, 64, 2, 2, True),        # the decoder's causal self-attention
    (2, 48, 112, 2, 0, False),      # training cross-attention: no bias
    (2, 40, 72, 3, 1, False),       # a bias broadcast over the heads
]


def _bias(h, sq, sk, seed):
    return np.random.RandomState(seed).randn(1, h, sq, sk).astype(np.float32)


@pytest.mark.parametrize("b,sq,sk,h,bh,causal", BIAS_CASES)
def test_bias_attention_matches_jax_pallas_kernel(b, sq, sk, h, bh, causal):
    """K7 without dropout on CPU tensors vs the Pallas K7 in interpret mode,
    D = 64, T5's scale 1.0 and the default scale; atol 1e-5."""
    q, k, v, _ = _inputs(b, sq, sk, h, 64, seed=60 + sq + bh)
    mask = _hole_mask(b, sk, seed=sk + 1)
    bias = _bias(bh, sq, sk, seed=sq) if bh else None
    for scale in (1.0, None):
        want = jax_flash_bias(
            *map(jnp.asarray, (q, k, v)),
            bias=None if bias is None else jnp.asarray(bias),
            kv_mask=jnp.asarray(mask), causal=causal, scale=scale,
            interpret=True)
        got = fa.flash_attention_bias(
            *_t(q, k, v), bias=None if bias is None else torch.from_numpy(bias),
            kv_mask=torch.from_numpy(mask), causal=causal, scale=scale)
        _close(got, want)


@pytest.mark.parametrize("b,sq,sk,h,bh,causal", BIAS_CASES)
def test_bias_attention_grads_match_jax_pallas_backward(b, sq, sk, h, bh,
                                                        causal):
    """autograd through K7 on CPU tensors (K8/K9's plain version) vs
    jax.grad through the Pallas K7 and its backward in interpret mode: dq,
    dk, dv and dbias (summed over the batch, and over the heads of a
    broadcast bias); scale 1.0 with q scaled by D**-0.5 (T5 folds the
    scale into its init), no dropout; atol 1e-5 (dbias 2e-5: a sum over the
    batch of sums over D)."""
    q, k, v, _ = _inputs(b, sq, sk, h, 64, seed=70 + sq + bh)
    q = q * np.float32(0.125)
    mask = _hole_mask(b, sk, seed=sk + 2)
    bias = _bias(bh, sq, sk, seed=sq + 1) if bh else np.zeros((1,), np.float32)

    def jloss(q, k, v, bias):
        return _weighted_sum(jax_flash_bias(
            q, k, v, bias=bias if bh else None, kv_mask=jnp.asarray(mask),
            causal=causal, scale=1.0, interpret=True), jnp.cos)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (q, k, v, bias)))
    tq, tk, tv, tb = (t.requires_grad_() for t in _t(q, k, v, bias))
    out = fa.flash_attention_bias(tq, tk, tv, bias=tb if bh else None,
                                  kv_mask=torch.from_numpy(mask),
                                  causal=causal, scale=1.0)
    got = torch.autograd.grad(_weighted_sum(out), (tq, tk, tv) + (
        (tb,) if bh else ()))
    for g, w in zip(got[:3], want[:3]):
        _close(g, w)
    if bh:
        np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                                   rtol=0, atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bias_bwd_reference_matches_autograd(causal, rate):
    """K8/K9's plain version equals torch autograd through
    attention_reference with the same keep mask, a fully masked sample
    included (no dq, dk or dbias from it; dV from the uniform 1/Sk); atol
    1e-5."""
    b, sq, sk, h = 2, 40, 72 if not causal else 40, 2
    q, k, v, _ = _inputs(b, sq, sk, h, 64, seed=80 + causal)
    q = q * np.float32(0.125)   # T5's scale 1.0 with D**-0.5 folded in
    mask = _hole_mask(b, sk, seed=6)
    mask[1] = 0
    tmask = torch.from_numpy(mask)
    seed = torch.tensor([12345, 678], dtype=torch.int64)
    keep = (att.dropout_bits(seed, (b, h, sq, sk))
            < att.dropout_threshold(rate)[0]) if rate else None
    tq, tk, tv, tb = (t.requires_grad_()
                      for t in _t(q, k, v, _bias(h, sq, sk, seed=3)))
    out = att.attention_reference(tq, tk, tv, kv_mask=tmask, bias=tb,
                                  causal=causal, scale=1.0,
                                  dropout_rate=rate, dropout_mask=keep)
    dout = torch.from_numpy(
        np.random.RandomState(5).randn(*out.shape).astype(np.float32))
    want = torch.autograd.grad(out, (tq, tk, tv, tb), dout)
    got = fa.bias_attention_bwd_reference(
        tq.detach(), tk.detach(), tv.detach(), tmask, tb.detach(),
        out.detach(), dout, causal=causal, scale=1.0, dropout_rate=rate,
        dropout_seed=seed)
    for g, w in zip(got, want):
        _close(g, w)
    assert float(got[0][1].abs().max()) == 0.0


# ---- dropout: the kernels' counter-based bits --------------------------------

def test_dropout_bits_are_philox_4x32_10():
    """philox4x32_10 gives the Random123 known answers, and the keep mask is
    a pure function of (seed, b, h, i, j): the same for a sub-shape, the
    same when drawn twice, other under another seed."""
    kat = [((0, 0, 0, 0), (0, 0),
            (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
           ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
            (0xa4093822, 0x299f31d0),
            (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]
    for ctr, key, want in kat:
        got = att.philox4x32_10(*(torch.tensor(c) for c in ctr),
                                *(torch.tensor(k_) for k_ in key))
        assert tuple(int(w) for w in got) == want
    seed = torch.tensor([2 ** 32 - 5, 77], dtype=torch.int64)
    bits = att.dropout_bits(seed, (2, 3, 20, 70))
    assert bits.dtype == torch.int64 and int(bits.min()) >= 0
    assert int(bits.max()) < 2 ** 32
    assert torch.equal(bits, att.dropout_bits(seed, (2, 3, 20, 70)))
    assert torch.equal(bits[:1, 1:, :7, :33],
                       att.dropout_bits(seed, (1, 3, 7, 33))[:, 1:])
    b, h, i, j = 1, 2, 13, 45
    words = att.philox4x32_10(*(torch.tensor(c) for c in (
        ((j >> 4) << 2) | (j & 3), i, h, b)), seed[0], seed[1])
    assert int(bits[b, h, i, j]) == int(words[(j >> 2) & 3])
    other = att.dropout_bits(torch.tensor([2 ** 32 - 5, 78]), (2, 3, 20, 70))
    assert float((other == bits).float().mean()) < 0.01


def test_dropout_keep_fraction_matches_the_jax_package():
    """At rate 0.1 the kept share of a T5-sized mask is within 4 sigma of
    0.9, as the JAX package's (jax.random.bernoulli in xla_attention) is;
    the masks themselves are not comparable (other generators)."""
    shape = (2, 4, 64, 512)
    n = float(np.prod(shape))
    sigma = (0.9 * 0.1 / n) ** 0.5
    keep = att.dropout_keep_factor(torch.tensor([3, 4]), shape, 0.1)
    assert set(torch.unique(keep).tolist()) == {
        0.0, torch.tensor(1.0 / 0.9, dtype=torch.float32).item()}
    frac = float((keep > 0).float().mean())
    jfrac = float(jnp.mean(jax.random.bernoulli(jax.random.PRNGKey(0), 0.9,
                                                shape)))
    for f in (frac, jfrac):
        assert abs(f - 0.9) < 4 * sigma, f
    assert att.dropout_threshold(0.1) == (round(0.9 * 2 ** 32), 1 / 0.9)
    assert att.dropout_threshold(0.0) is None


def test_attention_reference_dropout_seed_and_mask_agree():
    """attention_reference's dropout from a seed equals the same call with
    the explicit keep mask of that seed, and K7's plain version equals both
    (atol 1e-5)."""
    q, k, v, mask = _inputs(2, 40, 56, 2, 64, seed=90)
    seed = torch.tensor([9, 10], dtype=torch.int64)
    keep = att.dropout_bits(seed, (2, 2, 40, 56)) < att.dropout_threshold(
        0.1)[0]
    tq, tk, tv = _t(q, k, v)
    tmask = torch.from_numpy(mask)
    a = att.attention_reference(tq, tk, tv, kv_mask=tmask, dropout_rate=0.1,
                                dropout_seed=seed)
    b_ = att.attention_reference(tq, tk, tv, kv_mask=tmask, dropout_rate=0.1,
                                 dropout_mask=keep)
    c = fa.flash_attention_bias(tq, tk, tv, kv_mask=tmask, dropout_rate=0.1,
                                dropout_seed=seed)
    _close(a, b_)
    _close(c, b_)
    plain = att.attention_reference(tq, tk, tv, kv_mask=tmask)
    assert float((a - plain).abs().max()) > 1e-2


def test_bias_kernel_path_keeps_the_autograd_graph(monkeypatch):
    """K7's card path taken on the CPU with its launchers replaced by the
    plain versions computed without autograd: with a bias and dropout the
    output still has a grad_fn, the backward launches K8/K9 once and not
    the plain version, and the gradients, dbias included, equal autograd
    through the plain path with the same keep mask (atol 1e-5 x the
    largest gradient)."""
    def fake_launch_bias(q, k, v, kv_mask, bias, seed, causal, scale, thr,
                         keep_inv, with_stats):
        with torch.no_grad():
            got = fa.bias_attention_reference(
                q, k, v, bias=None if bias is None else bias[None],
                kv_mask=kv_mask, causal=causal, scale=scale,
                dropout_rate=0.0 if seed is None else 0.1,
                dropout_seed=seed, with_stats=with_stats)
        return tuple(t.clone() for t in got) if with_stats else (
            got.clone(), None, None)

    def fake_launch_bias_bwd(q, k, v, kv_mask, bias, seed, out, dout, causal,
                             scale, thr, keep_inv):
        dq, dk, dv, dbias = fa.bias_attention_bwd_reference(
            q, k, v, kv_mask, None if bias is None else bias[None], out,
            dout, causal=causal, scale=scale,
            dropout_rate=0.0 if seed is None else 0.1, dropout_seed=seed)
        return dq, dk, dv, None if dbias is None else dbias[0]

    monkeypatch.setattr(fa, "_plain", lambda q: False)
    monkeypatch.setattr(fa, "_launch_bias", fake_launch_bias)
    monkeypatch.setattr(fa, "_launch_bias_bwd", fake_launch_bias_bwd)
    monkeypatch.setattr(fa, "_check_layout", lambda *a: None)
    monkeypatch.setattr(fa, "HEAD_DIMS", {**fa.HEAD_DIMS,
                                          "flash_attention_bias": (64,)})

    b, sq, sk, h = 2, 32, 32, 2
    q, k, v, _ = _inputs(b, sq, sk, h, 64, seed=91)
    q = q * np.float32(0.125)   # T5's scale 1.0 with D**-0.5 folded in
    mask = _hole_mask(b, sk, seed=7)
    bias = _bias(h, sq, sk, seed=8)
    seed = torch.tensor([5, 6], dtype=torch.int64)
    keep = att.dropout_bits(seed, (b, h, sq, sk)) < att.dropout_threshold(
        0.1)[0]
    tq, tk, tv, tb = (t.requires_grad_() for t in _t(q, k, v, bias))
    want_out = att.attention_reference(tq, tk, tv, kv_mask=torch.from_numpy(
        mask), bias=tb, causal=True, scale=1.0, dropout_rate=0.1,
        dropout_mask=keep)
    want = torch.autograd.grad(_weighted_sum(want_out), (tq, tk, tv, tb))
    launches = (fa.flash_attention_bias.launches,
                fa.flash_attention_bias_bwd.launches)
    out = fa.flash_attention_bias(tq, tk, tv, bias=tb,
                                  kv_mask=torch.from_numpy(mask), causal=True,
                                  scale=1.0, dropout_rate=0.1,
                                  dropout_seed=seed)
    assert out.grad_fn is not None
    got = torch.autograd.grad(_weighted_sum(out), (tq, tk, tv, tb))
    assert fa.flash_attention_bias.launches == launches[0] + 1
    assert fa.flash_attention_bias_bwd.launches == launches[1] + 1
    _close(out.detach(), want_out.detach())
    for g, w in zip(got, want):
        # the backward's delta is rowsum(dO * o), autograd's sum(P * g):
        # equal up to fp32 rounding on the gradient's own scale
        _close(g, w, atol=ATOL * max(1.0, float(w.abs().max())))
