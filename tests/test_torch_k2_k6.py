"""K2 (CLIP's fused-heads forward) and K6 (the blocked causal backward) on
the wgmma/TMA bodies of mmgl_tpu_torch/csrc/allheads_wgmma.cuh, on the CPU.

K2's bf16 and fp16 entry runs K1's wgmma forward at sq == sk, and K6's runs
K3's wgmma dQ (with delta) and dK/dV bodies from K4's row stats. Their
arithmetic is emulated in torch at the library's tile widths (FwdShape,
DkdvShape and DqShape: 64 query rows a block and 64-row streamed tiles)
by tests/test_torch_tc_numerics.py's ``emulate_forward`` and
``emulate_backward``, and held against the JAX package in interpret mode:
K2 against the Pallas ``_fused_heads_fwd``, K6 against the Pallas ``_fwd``
(with_lse) and ``_bwd_causal_blocked``; a fully masked sample against
xla_attention and its jax.grad (the port follows xla_attention there on
purpose: the Pallas K2 pads S to 128 with masked zero keys, and the Pallas
blocked backward drops a fully masked row). Tolerances are chip_smoke.py's:
atol = rtol = 2e-2 in bf16 and 5e-3 in fp16, a gradient's atol that
fraction of its largest entry.

Then the launch path, taken on the CPU with the library entry replaced by
a recorder: without a key mask, K2 and K6 call their tensor-core entries
through ``_call`` with a null mask pointer and build no mask tensor; the
fp32 entries (the scalar bodies) get a mask of ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mmgl_tpu.ops.flash_attention as jfa
from mmgl_tpu.ops.attention import xla_attention
from mmgl_tpu_torch.ops import flash_attention as fa
from test_torch_regularization import _one_thread  # noqa: F401
from test_torch_tc_numerics import (FP16_TOL, NEG_INF, TOL, _close,
                                    _close_grad, _inputs, _jax_reference,
                                    emulate_backward, emulate_forward)

# the library's tile widths of the forward, dK/dV and dQ bodies
LIBRARY_TILES = (64, 64)
DTYPES = dict(argnames="dtype", argvalues=[torch.bfloat16, torch.float16],
              ids=["bf16", "fp16"])


def _tol(dtype):
    return TOL if dtype == torch.bfloat16 else FP16_TOL


def _jdt(dtype):
    return jnp.dtype(str(dtype).split(".")[1])


# K2: (B, S, S, H), causal: CLIP's 197 patches (three full 64-row tiles
# and a 5-row one), no mask; the CLIP text tower's 77 tokens, causal, sample
# 0 a text right-padded after 50 tokens, sample 1 an empty text
K2_CASES = [((2, 197, 197, 2), False), ((2, 77, 77, 2), True)]
K2_IDS = ["197-patches", "77-texts-causal"]


@pytest.mark.parametrize("dims,causal", K2_CASES, ids=K2_IDS)
@pytest.mark.parametrize(**DTYPES)
def test_k2_wgmma_arithmetic_matches_jax(dtype, dims, causal):
    """K2's wgmma body (K1's forward at sq == sk, 64 x 64 tiles) in bf16 and
    fp16 against the Pallas _fused_heads_fwd in interpret mode; at 77 tokens
    the empty text (its rows fully masked) against xla_attention, which
    averages V over the 77 keys, and the diagonal's early exit ran."""
    tol = _tol(dtype)
    (q, k, v, _), mask = _inputs(dims, "ones", seed=sum(dims) + 11,
                                 dtype=dtype)
    if causal:
        mask[0, 50:] = 0
        mask[1] = 0
    scale = q.shape[-1] ** -0.5
    seen = {"early_exit": 0}
    out, m, _ = emulate_forward(q, k, v, mask, causal, scale, dtype=dtype,
                                seen=seen, tiles=LIBRARY_TILES)
    jq, jk, jv = (jnp.asarray(t.numpy()).astype(_jdt(dtype))
                  for t in (q, k, v))
    want = jfa._fused_heads_fwd(jq, jk, jv, jnp.asarray(mask.numpy()), scale,
                                causal, True)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    if not causal:
        _close(out, want, tol, tol, "out")
        return
    _close(out[:1], want[:1], tol, tol, "right-padded text")
    jq, jk, jv = (jnp.asarray(t[1:].numpy()) for t in (q, k, v))
    plain = xla_attention(jq, jk, jv, kv_mask=jnp.asarray(mask[1:].numpy()),
                          causal=True, scale=scale)
    _close(out[1:], torch.from_numpy(np.array(plain)), tol, tol,
           "empty text")
    _close(out[1], v[1].mean(0, keepdim=True).expand_as(out[1]), tol, tol,
           "empty text: the mean of V")
    assert float(m[1].max()) == np.float32(NEG_INF)
    assert seen["early_exit"] > 0     # the diagonal's early exit ran


# K6: (B, Sq, Sk, H), key mask, all causal: sq == sk with a pad hole, the
# ends aligned at sq < sk, and sample 0 fully masked (sample 1's first 70
# keys masked, so its first causal rows see no real logit)
K6_CASES = [((2, 197, 197, 2), "hole"), ((2, 200, 328, 2), "hole"),
            ((2, 197, 197, 2), "fully_masked")]
K6_IDS = ["197-hole", "200x328-aligned", "fully-masked"]


@pytest.mark.parametrize("dims,mask_kind", K6_CASES, ids=K6_IDS)
@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize(**DTYPES)
def test_k6_wgmma_arithmetic_from_k4_stats_matches_jax(dtype, d, dims,
                                                       mask_kind):
    """K6 on K3's wgmma bodies (64 x 64 tiles) at head dim d, from the row
    max and sum of K4's wgmma forward (the same 64 x 64 body), in bf16 and
    fp16: dq, dk, dv against the Pallas _bwd_causal_blocked from the Pallas
    _fwd's output and LSE in interpret mode, or, with a fully masked sample,
    jax.grad through xla_attention; each gradient's atol the dtype's
    tolerance times its largest entry. The fully masked rows feed dV from
    query tiles wholly before the keys, and give no dQ and no dK."""
    tol = _tol(dtype)
    (q, k, v, dout), mask = _inputs(dims, mask_kind, seed=sum(dims) + d + 13,
                                    dtype=dtype, d=d)
    scale = d ** -0.5
    out, m, l = emulate_forward(q, k, v, mask, True, scale, dtype=dtype,
                                tiles=LIBRARY_TILES)
    seen = {"hidden_tiles": 0}
    got = emulate_backward(q, k, v, mask, out, dout, m, l, True, scale,
                           dtype=dtype, seen=seen, dkdv_tiles=LIBRARY_TILES,
                           dq_tiles=LIBRARY_TILES)
    _, _, want = _jax_reference(dims, True, mask_kind, q, k, v, dout, mask,
                                scale, _jdt(dtype))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close_grad(g, w, name, tol)
    if mask_kind == "fully_masked":
        assert seen["hidden_tiles"] > 0
        assert float(got[0][0].abs().max()) == 0.0
        assert float(got[1][0].abs().max()) == 0.0
        assert float(got[2][0, -1].abs().max()) > 0.0


# ---- the launch path -------------------------------------------------------

@pytest.fixture
def recorded(monkeypatch):
    """The card path on the CPU: every library call recorded as (entry,
    kernel name, arguments) instead of run, and every ``_int_mask`` call
    (a mask tensor built for the call) recorded too."""
    calls, masks = [], []
    int_mask = fa._int_mask

    def fake_call(q, fn, name, *args):
        calls.append((fn, name, args))

    def counted_int_mask(*args):
        masks.append(args)
        return int_mask(*args)

    monkeypatch.setattr(fa, "_plain", lambda q: False)
    monkeypatch.setattr(fa, "_lib_fn", lambda entry: entry)
    monkeypatch.setattr(fa, "_call", fake_call)
    monkeypatch.setattr(fa, "_int_mask", counted_int_mask)
    return calls, masks


def _launches(wrapper):
    return wrapper.launches, wrapper.launches_tc


def test_k2_card_path_takes_a_null_mask(recorded):
    """fused_heads_attention without a mask (CLIP's vision tower) in bf16
    and fp16 calls mmgl_fused_heads_fwd_tc through _call with a null mask
    pointer and (B, S, H, D) = (2, 197, 2, 64), builds no mask tensor and
    counts one tensor-core launch; with an int32 mask it passes that mask's
    pointer; in fp32 the scalar entry gets a mask of ones."""
    calls, masks = recorded
    wrapper = fa.fused_heads_attention
    gen = torch.Generator().manual_seed(2)
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        q, k, v = (torch.randn(2, 197, 2, 64, generator=gen).to(dtype)
                   for _ in range(3))
        before = _launches(wrapper)
        out = wrapper(q, k, v)
        entry, name, args = calls[-1]
        assert out.shape == q.shape and out.dtype == dtype
        assert name == "fused_heads_attention"
        assert args[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
        assert args[4] == out.data_ptr()
        assert args[5:9] == (2, 197, 2, 64) and args[10] is False
        tc = dtype != torch.float32
        assert _launches(wrapper) == (before[0] + 1, before[1] + int(tc))
        if tc:
            assert entry == "mmgl_fused_heads_fwd_tc"
            assert args[3] is None and masks == []
        else:
            assert entry == "mmgl_fused_heads_fwd"
            assert args[3] is not None and len(masks) == 1
    mask = torch.ones(2, 197, dtype=torch.int32)
    wrapper(q.bfloat16(), k.bfloat16(), v.bfloat16(), kv_mask=mask,
            causal=True)
    entry, _, args = calls[-1]
    assert entry == "mmgl_fused_heads_fwd_tc"
    assert args[3] == mask.data_ptr() and args[10] is True
    assert len(masks) == 1


def test_k6_card_path_takes_a_null_mask(recorded):
    """flash_attention_blocked_bwd without a mask at end-aligned (2, 200 x
    328, 2, 64) causal in bf16 and fp16 calls mmgl_blocked_bwd_tc through
    _call with a null mask pointer, K4's row max and sum and a delta scratch
    of B * H * Sq floats, builds no mask tensor and counts one tensor-core
    launch; with an int32 mask it passes that mask's pointer; in fp32 the
    scalar entry gets a mask of ones."""
    calls, masks = recorded
    wrapper = fa.flash_attention_blocked_bwd
    gen = torch.Generator().manual_seed(3)
    b, sq, sk, h, d = 2, 200, 328, 2, 64
    m, l = (torch.rand(b, h, sq, generator=gen) + 1 for _ in range(2))
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        q, out, dout = (torch.randn(b, sq, h, d, generator=gen).to(dtype)
                        for _ in range(3))
        k, v = (torch.randn(b, sk, h, d, generator=gen).to(dtype)
                for _ in range(2))
        before = _launches(wrapper)
        dq, dk, dv = wrapper(q, k, v, None, out, dout, m, l, causal=True)
        entry, name, args = calls[-1]
        assert name == "flash_attention_blocked_bwd"
        assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
        assert args[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
        assert args[4:11] == (out.data_ptr(), dout.data_ptr(), m.data_ptr(),
                              l.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                              dv.data_ptr())
        assert args[12:17] == (b, sq, sk, h, d) and args[18] is True
        tc = dtype != torch.float32
        assert _launches(wrapper) == (before[0] + 1, before[1] + int(tc))
        if tc:
            assert entry == "mmgl_blocked_bwd_tc"
            assert args[3] is None and masks == []
        else:
            assert entry == "mmgl_blocked_bwd"
            assert args[3] is not None and len(masks) == 1
    mask = torch.ones(b, sk, dtype=torch.int32)
    wrapper(q.half(), k.half(), v.half(), mask, out.half(), dout.half(), m, l,
            causal=True)
    entry, _, args = calls[-1]
    assert entry == "mmgl_blocked_bwd_tc" and args[3] == mask.data_ptr()
    assert len(masks) == 1
