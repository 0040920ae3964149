"""K4's row statistics and the blocked causal backward (K6) against the JAX
package, on the CPU, and the route that reaches them.

Inputs are made with numpy from a seed. JAX runs on the CPU at "highest"
matmul precision (conftest.py), its Pallas kernels in interpret mode as
tests/test_attention.py runs them; the port's wrappers take their plain
versions because the tensors lie on the CPU. Everything is fp32. Each test
states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mmgl_tpu.ops.flash_attention as jfa
from mmgl_tpu.ops.attention import xla_attention
from mmgl_tpu_torch.ops import attention as att
from mmgl_tpu_torch.ops import flash_attention as fa


def _inputs(b, sq, sk, h, d, seed):
    """q, k, v, a cotangent and a key mask whose key 0 stays valid, so no
    causal row is fully masked."""
    rng = np.random.RandomState(seed)
    q, dout = (rng.randn(b, sq, h, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, sk, h, d).astype(np.float32) for _ in range(2))
    mask = (rng.uniform(size=(b, sk)) > 0.2).astype(np.int32)
    mask[:, 0] = 1
    return q, k, v, dout, mask


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _heads_first(x):
    """BSHD -> the Pallas kernels' (B*H, S, D)."""
    b, s, h, d = x.shape
    return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, s, d)


def _seq_first(x, b, h):
    """(B*H, S, D) -> BSHD, as numpy."""
    x = np.asarray(x)
    return x.reshape(b, h, x.shape[1], x.shape[2]).transpose(0, 2, 1, 3)


def _close(got, want, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _weighted_sum(out, cos=torch.cos):
    return (out * cos(out)).sum()


@pytest.mark.parametrize("sq,sk", [(300, 300), (200, 328)])
def test_k4_stats_give_the_pallas_logsumexp(sq, sk):
    """m + log l of K4's plain version equals the LSE the Pallas K4 writes
    under with_lse (mmgl_tpu/ops/flash_attention.py:118-121), and its output
    the Pallas output; atol 1e-5."""
    b, h, d = 1, 2, 16
    q, k, v, _, mask = _inputs(b, sq, sk, h, d, seed=sq)
    want_out, want_lse = jfa._fwd(
        _heads_first(q), _heads_first(k), _heads_first(v),
        jnp.repeat(jnp.asarray(mask), h, axis=0), d ** -0.5, True, True,
        with_lse=True)
    out, m, l = fa.flash_attention_stats(*_t(q, k, v),
                                         kv_mask=torch.from_numpy(mask),
                                         causal=True)
    assert m.shape == l.shape == (b, h, sq) and m.dtype == torch.float32
    _close(out, _seq_first(want_out, b, h), 0, 1e-5)
    _close((m + torch.log(l)).reshape(b * h, sq), want_lse, 0, 1e-5)


@pytest.mark.parametrize("sq,sk,seed", [(300, 300, 7), (200, 328, 8)])
def test_blocked_bwd_reference_matches_jax_blocked_backward(sq, sk, seed):
    """K6's plain version, from K4's stats, against the Pallas
    _bwd_causal_blocked in interpret mode (MMGL_BLOCKED_BWD's path) on
    shapes that span several of its 128-row blocks, end-aligned sq < sk
    included; keys never fully masked. rtol 1e-2, atol 5e-3, the tolerance
    of the JAX package's own test of that kernel (test_attention.py:89-116),
    and 2e-5 against the same kernel's math in fp32 here."""
    b, h, d = 1, 2, 16
    q, k, v, dout, mask = _inputs(b, sq, sk, h, d, seed=seed)
    qf, kf, vf, dof = map(_heads_first, (q, k, v, dout))
    maskf = jnp.repeat(jnp.asarray(mask), h, axis=0)
    out, lse = jfa._fwd(qf, kf, vf, maskf, d ** -0.5, True, True,
                        with_lse=True)
    want = jfa._bwd_causal_blocked(qf, kf, vf, maskf, d ** -0.5, True, out,
                                   dof, lse)

    tq, tk, tv, tdo = _t(q, k, v, dout)
    tmask = torch.from_numpy(mask)
    tout, m, l = fa.flash_attention_stats(tq, tk, tv, kv_mask=tmask,
                                          causal=True)
    got = fa.flash_attention_blocked_bwd(tq, tk, tv, tmask, tout, tdo, m, l,
                                         causal=True)
    assert fa.flash_attention_blocked_bwd.launches == 0   # plain on the CPU
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = _seq_first(w, b, h)
        _close(g, w, 1e-2, 5e-3, name)
        _close(g, w, 0, 2e-5, name)


@pytest.mark.parametrize("causal", [True, False])
def test_blocked_bwd_reference_matches_autograd(causal):
    """In fp32 K6's plain version equals torch autograd through
    attention_reference, a fully masked sample and a pad hole included;
    atol 1e-5."""
    q, k, v, dout, mask = _inputs(2, 96, 96, 2, 64, seed=3)
    mask[1] = 0
    mask[0, 40:60] = 0
    tmask = torch.from_numpy(mask)
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = att.attention_reference(tq, tk, tv, kv_mask=tmask, causal=causal)
    tdo = torch.from_numpy(dout)
    want = torch.autograd.grad(out, (tq, tk, tv), tdo)
    _, m, l = fa.flash_attention_reference(
        tq.detach(), tk.detach(), tv.detach(), kv_mask=tmask, causal=causal,
        with_stats=True)
    assert float(m[1].max()) == np.float32(att.NEG_INF)
    assert float(l[1].min()) == 96.0
    got = fa.flash_attention_blocked_bwd_reference(
        tq.detach(), tk.detach(), tv.detach(), tmask, out.detach(), tdo, m,
        l, causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g, w, 0, 1e-5, name)


def test_fully_masked_row_follows_xla_attention(monkeypatch):
    """With a fully masked sample, autograd through K4 under the flag (its
    backward K6's plain version) gives jax.grad through xla_attention: that
    sample's rows keep P = 1/Sk over every key, causally hidden ones too, so
    they feed dV at every key and give no dQ or dK. The Pallas K6 drops such
    a row instead (mmgl_tpu/ops/flash_attention.py:276, :316), which would
    leave dV without it; atol 1e-5."""
    monkeypatch.setattr(fa, "BLOCKED_BWD", True)
    q, k, v, _, mask = _inputs(2, 160, 160, 2, 64, seed=11)
    mask[0] = 0

    def jloss(q, k, v):
        return _weighted_sum(xla_attention(q, k, v, kv_mask=jnp.asarray(mask),
                                           causal=True), jnp.cos)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    calls = []
    blocked = fa.flash_attention_blocked_bwd
    monkeypatch.setattr(fa, "flash_attention_blocked_bwd", lambda *a, **kw: (
        calls.append(1), blocked(*a, **kw))[1])
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = fa.flash_attention(tq, tk, tv, kv_mask=torch.from_numpy(mask),
                             causal=True)
    got = torch.autograd.grad(_weighted_sum(out), (tq, tk, tv))
    assert calls == [1]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g, w, 0, 1e-5, name)
    assert float(got[0][0].abs().max()) == 0.0
    assert float(got[1][0].abs().max()) == 0.0
    # the last key is hidden from every row but the last: only the fully
    # masked sample's uniform P reaches it
    assert float(got[2][0, -1].abs().max()) > 0.0


@pytest.mark.parametrize("q_shape,route", [
    ((4, 2048, 16, 64), "flash"),      # OPT-350M at its 2048-token window
    ((4, 1920, 16, 64), "flash"),      # its prefill
    ((2, 1024, 4, 16), "flash"),       # the tiny post-LN test model
    ((4, 768, 12, 64), "allheads"),    # the envelope's edge
    ((4, 256, 3, 64), "flash"),        # 3 heads: not a multiple of the pair
    ((4, 256, 3, 128), "allheads"),    # head dim 128 takes heads one by one
    ((4, 640, 12, 64), "allheads"),    # OPT-125M eval
    ((4, 512, 12, 64), "allheads"),    # OPT-125M prefill
    ((24, 197, 12, 64), "fused_heads"),  # CLIP
])
def test_route_follows_the_jax_allheads_envelope(q_shape, route):
    """Aligned self-attention takes K1 only inside the JAX package's
    all-heads envelope (S <= 768, H a multiple of _allheads_hp(D),
    mmgl_tpu/ops/attention.py:145-150), else K4; the shapes of the earlier
    slices keep their kernels."""
    assert att.allheads_head_pair(q_shape[3]) == jfa._allheads_hp(q_shape[3])
    assert att.attention_route(q_shape, q_shape) == route
    assert att.attention_route(q_shape, q_shape, bias=True) == "bias"


def test_multi_head_attention_at_a_long_window_runs_k4_then_k6(monkeypatch):
    """Causal self-attention at 1024 tokens (past the envelope) through
    multi_head_attention calls K4's wrapper, and under the flag its gradient
    K6's, matching jax.grad through xla_attention (atol 1e-5)."""
    monkeypatch.setattr(fa, "BLOCKED_BWD", True)
    calls = []
    for name in ("flash_attention", "flash_attention_blocked_bwd",
                 "flash_attention_bwd", "flash_attention_allheads"):
        orig = getattr(fa, name)
        monkeypatch.setattr(fa, name, lambda *a, _o=orig, _n=name, **kw: (
            calls.append(_n), _o(*a, **kw))[1])
    q, k, v, _, mask = _inputs(1, 1024, 1024, 2, 16, seed=5)

    def jloss(q, k, v):
        return _weighted_sum(xla_attention(q, k, v, kv_mask=jnp.asarray(mask),
                                           causal=True), jnp.cos)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = att.multi_head_attention(tq, tk, tv, kv_mask=torch.from_numpy(mask),
                                   causal=True)
    got = torch.autograd.grad(_weighted_sum(out), (tq, tk, tv))
    assert calls == ["flash_attention", "flash_attention_blocked_bwd"]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g, w, 0, 1e-5, name)


def test_flash_card_path_keeps_the_graph_and_launches_k6(monkeypatch):
    """K4's card path taken on the CPU, its launchers replaced by the plain
    versions computed without autograd (as a kernel computes): under the
    flag the forward asks the launcher for the row stats, the output keeps a
    grad_fn, the backward launches K6 once (not K5), and the gradients equal
    jax.grad through the Pallas K4 and blocked backward in interpret mode
    (atol 1e-5). Without a gradient to take, no stats are asked for; with
    the flag off the backward launches K5."""
    asked = []

    def fake_launch_flash(q, k, v, kv_mask, causal, scale, with_stats):
        asked.append(with_stats)
        with torch.no_grad():
            out, m, l = fa.flash_attention_reference(
                q, k, v, kv_mask=kv_mask, causal=causal, scale=scale,
                with_stats=True)
        return (out.clone(),) + ((m, l) if with_stats else (None, None))

    def fake_launch_blocked_bwd(q, k, v, kv_mask, out, dout, m, l, causal,
                                scale):
        return fa.flash_attention_blocked_bwd_reference(
            q, k, v, kv_mask, out, dout, m, l, causal=causal, scale=scale)

    def fake_launch_bwd(fn, name, q, k, v, kv_mask, out, dout, causal, scale):
        return fa.flash_attention_bwd_reference(q, k, v, kv_mask, out, dout,
                                                causal, scale)

    monkeypatch.setattr(fa, "_plain", lambda q: False)
    monkeypatch.setattr(fa, "_launch_flash", fake_launch_flash)
    monkeypatch.setattr(fa, "_launch_blocked_bwd", fake_launch_blocked_bwd)
    monkeypatch.setattr(fa, "_launch_bwd", fake_launch_bwd)
    monkeypatch.setattr(fa, "_check_layout", lambda *a: None)
    monkeypatch.setattr(jfa, "_BLOCKED_BWD", True)

    b, sq, sk, h = 2, 200, 328, 2
    q, k, v, _, mask = _inputs(b, sq, sk, h, 64, seed=21)

    def jloss(q, k, v):
        return _weighted_sum(jfa.flash_attention(
            q, k, v, kv_mask=jnp.asarray(mask), causal=True, interpret=True),
            jnp.cos)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    counts = (fa.flash_attention, fa.flash_attention_blocked_bwd,
              fa.flash_attention_bwd)
    for flag, launched in ((True, (1, 1, 0)), (False, (1, 0, 1))):
        monkeypatch.setattr(fa, "BLOCKED_BWD", flag)
        asked.clear()
        tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
        before = [c.launches for c in counts]
        out = fa.flash_attention(tq, tk, tv, kv_mask=torch.from_numpy(mask),
                                 causal=True)
        assert out.grad_fn is not None
        got = torch.autograd.grad(_weighted_sum(out), (tq, tk, tv))
        assert asked == [flag]
        assert tuple(c.launches - n for c, n in zip(counts, before)) == \
            launched
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            _close(g, w, 0, 1e-5, f"{name} flag={flag}")
        with torch.no_grad():
            fa.flash_attention(tq, tk, tv, kv_mask=torch.from_numpy(mask),
                               causal=True)
        assert asked == [flag, False]


def test_blocked_bwd_checks_its_inputs():
    q, k, v, dout, mask = _inputs(1, 64, 64, 2, 64, seed=1)
    tq, tk, tv, tdo = _t(q, k, v, dout)
    out, m, l = fa.flash_attention_stats(tq, tk, tv, causal=True)
    with pytest.raises(ValueError, match="row stats"):
        fa.flash_attention_blocked_bwd(tq, tk, tv, None, out, tdo, m[:, :1],
                                       l, causal=True)
    with pytest.raises(ValueError, match="sq="):
        fa.flash_attention_blocked_bwd(tq, tk[:, :32], tv[:, :32], None,
                                       out, tdo, m, l, causal=True)
