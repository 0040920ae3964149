"""K5 (the dense backward of K4) on the wgmma/TMA bodies of
mmgl_tpu_torch/csrc/allheads_wgmma.cuh, on the CPU.

K5's bf16 and fp16 entry runs K4's wgmma forward in its stats-only form
(the rows' max and sum, the bits K4 writes), then K3's dQ body (delta
fused into its prologue) and dK/dV body at K3's library tile widths (64
query rows a dQ block over 64-key tiles, 64 keys a dK/dV block over 64-row
query tiles), in one grid or two launches by the grid's size (which
changes no element's arithmetic). Their arithmetic is emulated in torch by
tests/test_torch_tc_numerics.py's ``emulate_forward`` and
``emulate_backward`` at those tile widths, with K3's visit rules (dQ stops
at its block's causal limit and skips a key tile whose keys are all
masked; dK/dV visits a query tile wholly before its keys, or any tile
where its keys are all masked, only for a fully masked row), and held
against jax.grad through the JAX package's Pallas flash_attention in
interpret mode, whose VJP is checked to reach the dense ``_bwd`` (not
``_bwd_causal_blocked``), in bf16 and fp16: T5's cross-attention (sq < sk),
MPT's cross-attention (sq > sk, one key tile, head dims 64 and 80) and
prefix tuning's causal sq < sk with the ends aligned. A sample without
neighbours (every key masked) is held against xla_attention and its
jax.grad (the port follows xla_attention there on purpose: the Pallas
kernel spreads such a row's P over the keys padded to 128). Tolerances are
chip_smoke.py's: atol = rtol = 2e-2 in bf16 and 5e-3 in fp16, a
gradient's atol that fraction of its largest entry.

Then the launch path, taken on the CPU with the library entry replaced by
a recorder: without a key mask, K5 calls its tensor-core entry through
``_call`` with a null mask pointer, builds no mask tensor and allocates one
fp32 scratch of 3 * B * H * Sq floats (the rows' max, sum and delta); the
fp32 entry (the scalar bodies) still gets a mask of ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mmgl_tpu.ops.flash_attention as jfa
from mmgl_tpu.ops.attention import xla_attention
from mmgl_tpu_torch.ops import flash_attention as fa
from test_torch_k2_k6 import recorded  # noqa: F401
from test_torch_k8_k9 import _reached, allocations  # noqa: F401
from test_torch_regularization import _one_thread  # noqa: F401
from test_torch_tc_numerics import (FP16_TOL, TOL, _close_grad, _inputs,
                                    emulate_backward, emulate_forward)

# K3's library tile widths (DkdvShape, DqShape and the one grid's dQ
# shape alike): (rows a block, rows a streamed tile)
LIBRARY_TILES = (64, 64)
DTYPES = dict(argnames="dtype", argvalues=[torch.bfloat16, torch.float16],
              ids=["bf16", "fp16"])

# (B, Sq, Sk, H), head dim, causal, key mask: T5's cross-attention (a pad
# gap and right padding over the encoder's keys); MPT's cross-attention
# over a 64-token memory, one key tile, sample 0 without neighbours; prefix
# tuning's causal 100 x 164, the ends aligned
CASES = [((2, 70, 197, 2), 64, False, "hole"),
         ((2, 150, 64, 2), 64, False, "no_neighbours"),
         ((2, 150, 64, 2), 80, False, "no_neighbours"),
         ((2, 100, 164, 2), 64, True, "hole")]
IDS = ["t5-cross", "one-key-tile-d64", "one-key-tile-d80", "prefix-causal"]


def _tol(dtype):
    return TOL if dtype == torch.bfloat16 else FP16_TOL


def _jdt(dtype):
    return jnp.dtype(str(dtype).split(".")[1])


def _case_inputs(dims, d, mask_kind, dtype):
    """q, k, v, dO holding ``dtype`` values, and the (B, Sk) key mask; for
    "no_neighbours" sample 0's keys all masked and sample 1's last 5."""
    (q, k, v, dout), mask = _inputs(
        dims, "ones" if mask_kind == "no_neighbours" else mask_kind,
        seed=sum(dims) + d + 31, dtype=dtype, d=d)
    if mask_kind == "no_neighbours":
        mask[0] = 0
        mask[1, -5:] = 0
    return q, k, v, dout, mask


def _emulate(q, k, v, dout, mask, causal, dtype):
    """K4's emulated forward at the library's tiles (K5's stats pass: the
    same m and l), then K3's bodies from its out and row stats."""
    scale = q.shape[-1] ** -0.5
    out, m, l = emulate_forward(q, k, v, mask, causal, scale, dtype=dtype,
                                tiles=LIBRARY_TILES)
    return emulate_backward(q, k, v, mask, out, dout, m, l, causal, scale,
                            dtype=dtype, dkdv_tiles=LIBRARY_TILES,
                            dq_tiles=LIBRARY_TILES)


def _pallas_grads(monkeypatch, q, k, v, dout, mask, causal, dtype):
    """jax.grad through the Pallas flash_attention in ``dtype`` in interpret
    mode, its VJP checked to take the dense ``_bwd``."""
    monkeypatch.setattr(jfa, "_BLOCKED_BWD", False)
    calls = _reached(monkeypatch, "_bwd")
    jq, jk, jv, jdo = (jnp.asarray(t.numpy()).astype(_jdt(dtype))
                       for t in (q, k, v, dout))
    jmask = jnp.asarray(mask.numpy())

    def f(q_, k_, v_):
        return jfa.flash_attention(q_, k_, v_, kv_mask=jmask, causal=causal,
                                   interpret=True)

    _, vjp = jax.vjp(f, jq, jk, jv)
    grads = vjp(jdo)
    assert calls == ["_bwd"]
    return [torch.from_numpy(np.array(g.astype(jnp.float32)))
            for g in grads]


def _xla_grads(q, k, v, dout, mask, causal):
    """jax.grad of xla_attention in fp32 on the same values."""
    jq, jk, jv, jdo = (jnp.asarray(t.numpy()) for t in (q, k, v, dout))
    jmask = jnp.asarray(mask.numpy())

    def f(q_, k_, v_):
        return xla_attention(q_, k_, v_, kv_mask=jmask, causal=causal,
                             scale=q.shape[-1] ** -0.5)

    _, vjp = jax.vjp(f, jq, jk, jv)
    return [torch.from_numpy(np.array(g)) for g in vjp(jdo)]


@pytest.mark.parametrize("dims,d,causal,mask_kind", CASES, ids=IDS)
@pytest.mark.parametrize(**DTYPES)
def test_k5_wgmma_arithmetic_matches_the_pallas_bwd(monkeypatch, dtype, dims,
                                                    d, causal, mask_kind):
    """K5's wgmma bodies (64 x 64 tiles) from K4's emulated out and row
    stats, in bf16 and fp16, against jax.grad through the Pallas
    flash_attention in the same dtype (interpret mode, its dense _bwd): dq,
    dk, dv, each atol the dtype's tolerance times its largest entry. A
    sample without neighbours is held against xla_attention's jax.grad
    instead: its rows feed dV with P = 1 / Sk from every key and give no dQ
    and no dK."""
    tol = _tol(dtype)
    q, k, v, dout, mask = _case_inputs(dims, d, mask_kind, dtype)
    got = _emulate(q, k, v, dout, mask, causal, dtype)
    want = _pallas_grads(monkeypatch, q, k, v, dout, mask, causal, dtype)
    real = slice(1, None) if mask_kind == "no_neighbours" else slice(None)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close_grad(g[real], w[real], name, tol)
    if mask_kind != "no_neighbours":
        return
    plain = _xla_grads(q, k, v, dout, mask, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, plain):
        _close_grad(g, w, f"{name} against xla_attention", tol)
    assert float(got[0][0].abs().max()) == 0.0     # no dQ, no dK
    assert float(got[1][0].abs().max()) == 0.0
    dv0 = dout[0].sum(0) / dims[2]                  # P = 1 / Sk everywhere
    _close_grad(got[2][0], dv0.expand_as(got[2][0]), "dv of the sample",
                tol)


# ---- the launch path -------------------------------------------------------

def _bwd_inputs(dtype, gen, b=2, sq=70, sk=197, h=2, d=64):
    q, out, dout = (torch.randn(b, sq, h, d, generator=gen).to(dtype)
                    for _ in range(3))
    k, v = (torch.randn(b, sk, h, d, generator=gen).to(dtype)
            for _ in range(2))
    return q, k, v, out, dout


def test_k5_card_path_takes_a_null_mask(recorded, allocations):
    """flash_attention_bwd without a mask at T5's cross-attention shape cut
    down, (2, 70 x 197, 2, 64), in bf16 and fp16: calls mmgl_flash_bwd_tc
    through _call with a null mask pointer, out, dO and the gradients'
    pointers, one fp32 scratch of 3 * B * H * Sq floats (the rows' max, sum
    and delta), builds no mask tensor and counts one tensor-core launch;
    with an int32 mask it passes that mask's pointer."""
    calls, masks = recorded
    wrapper = fa.flash_attention_bwd
    gen = torch.Generator().manual_seed(6)
    b, sq, sk, h, d = 2, 70, 197, 2, 64
    for dtype in (torch.bfloat16, torch.float16):
        q, k, v, out, dout = _bwd_inputs(dtype, gen)
        before = (wrapper.launches, wrapper.launches_tc)
        del allocations[:]
        dq, dk, dv = wrapper(q, k, v, None, out, dout)
        entry, name, args = calls[-1]
        assert entry == "mmgl_flash_bwd_tc" and name == "flash_attention_bwd"
        assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
        assert args[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
        assert args[3] is None and masks == []
        assert args[4:9] == (out.data_ptr(), dout.data_ptr(), dq.data_ptr(),
                             dk.data_ptr(), dv.data_ptr())
        assert args[10:15] == (b, sq, sk, h, d) and args[16] is False
        assert allocations == [3 * b * h * sq]
        assert (wrapper.launches, wrapper.launches_tc) == (
            before[0] + 1, before[1] + 1)
    mask = torch.ones(b, sk, dtype=torch.int32)
    wrapper(q, k, v, mask, out, dout)
    entry, _, args = calls[-1]
    assert entry == "mmgl_flash_bwd_tc" and args[3] == mask.data_ptr()
    assert masks == []


def test_k5_fp32_card_path_keeps_a_mask_of_ones(recorded, allocations):
    """In fp32 flash_attention_bwd without a mask calls the scalar entry
    mmgl_flash_bwd through _call with a mask of ones (its bodies read one)
    and the same 3 * B * H * Sq scratch, and counts a launch but no
    tensor-core one."""
    calls, masks = recorded
    wrapper = fa.flash_attention_bwd
    gen = torch.Generator().manual_seed(7)
    b, sq, h = 2, 70, 2
    q, k, v, out, dout = _bwd_inputs(torch.float32, gen)
    before = (wrapper.launches, wrapper.launches_tc)
    wrapper(q, k, v, None, out, dout)
    entry, name, args = calls[-1]
    assert entry == "mmgl_flash_bwd" and name == "flash_attention_bwd"
    assert args[3] is not None and len(masks) == 1
    assert masks[0][2] is None              # built for "no mask"
    assert allocations == [3 * b * h * sq]
    assert (wrapper.launches, wrapper.launches_tc) == (before[0] + 1,
                                                       before[1])
