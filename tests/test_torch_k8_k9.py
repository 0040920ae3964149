"""K8/K9 (T5's bias and dropout attention backward) on the bias form of
K3's wgmma/TMA bodies of mmgl_tpu_torch/csrc/allheads_wgmma.cuh, on the CPU.

K8/K9's bf16 and fp16 entry runs K3's dQ body (delta fused, the fp32
dlogits into the (B, H, Sq, Sk) partial, zeros on every tile it skips) and
dK/dV body in their bias form, at K3's library tile widths (64 query rows
a dQ block over 64-key tiles, 64 keys a dK/dV block over 64-row query
tiles), in one grid or two launches (which changes no element's
arithmetic), from K7's row max and sum, then reduces the partial over the
batch in order. Their arithmetic is emulated in torch by
tests/test_torch_tc_numerics.py's ``emulate_forward`` and
``emulate_backward`` at those tile widths, with K3's visit rules (dQ stops
at its block's causal limit and skips a key tile whose keys are all masked,
its partial zero there; dK/dV visits a query tile wholly before its keys,
or any tile where its keys are all masked, only for a fully masked row),
and held against the JAX package in interpret mode: jax.grad through the
Pallas flash_attention_bias with its backward forced to each of the two
Pallas kernels it can take, the batched one (K8, ``MMGL_BIAS_BWD_BATCHED=1``,
``_bwd_bias_batched``) and the row-serial one (K9, ``=0``), in bf16 and
fp16; a fully masked sample against xla_attention and its jax.grad (the
port follows xla_attention there on purpose: the Pallas kernels keep dS at
a fully masked row's masked logits). With dropout 0.1 the emulation is held
against the port's plain versions under the same Philox key (the TPU's
hardware bits cannot be reproduced). Tolerances are chip_smoke.py's: atol =
rtol = 2e-2 in bf16 and 5e-3 in fp16, a gradient's atol that fraction of
its largest entry.

Then the launch path, taken on the CPU with the library entry replaced by
a recorder: without a key mask, K8/K9 calls its tensor-core entry through
``_call`` with a null mask pointer, builds no mask tensor, and allocates
one fp32 scratch of delta's B * H * Sq floats where K7's row stats are
given (three times that for its stats-only pass) and the partial after
them; the fp32 entry (the scalar bodies) still gets a mask of ones and the
3 * B * H * Sq scratch.
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
from test_torch_regularization import _one_thread  # noqa: F401
from test_torch_tc_numerics import (BIAS_CASES, BIAS_IDS, FP16_TOL, NEG_INF,
                                    RATE, TOL, _bias_inputs, _close,
                                    _close_grad, _jax_bias_reference, _keep,
                                    emulate_backward, emulate_forward)

# K3's library tile widths (DkdvShape<64>, and BiasDqShape<64> and
# DqShape<64> alike): (rows a block, rows a streamed tile)
LIBRARY_TILES = (64, 64)
DTYPES = dict(argnames="dtype", argvalues=[torch.bfloat16, torch.float16],
              ids=["bf16", "fp16"])
# the Pallas backward each run forces: (MMGL_BIAS_BWD_BATCHED, the
# function the VJP must reach)
PALLAS = dict(argnames="pallas", argvalues=[("1", "_bwd_bias_batched"),
                                            ("0", "_bwd_bias")],
              ids=["K8-batched", "K9-serial"])


def _tol(dtype):
    return TOL if dtype == torch.bfloat16 else FP16_TOL


def _jdt(dtype):
    return jnp.dtype(str(dtype).split(".")[1])


def _emulate(q, k, v, dout, mask, bias, causal, dtype, keep=None):
    """K7's emulated forward at the library's tiles, then K8/K9's bodies
    from its out and row stats: (out, m, (dq, dk, dv, dbias))."""
    scale = q.shape[-1] ** -0.5
    out, m, l = emulate_forward(q, k, v, mask, causal, scale, dtype=dtype,
                                bias=bias, keep=keep, tiles=LIBRARY_TILES)
    grads = emulate_backward(q, k, v, mask, out, dout, m, l, causal, scale,
                             dtype=dtype, bias=bias, keep=keep,
                             dkdv_tiles=LIBRARY_TILES,
                             dq_tiles=LIBRARY_TILES)
    return out, m, grads


# the JAX package's results at a (case, dtype, Pallas kernel)
_REFERENCE = {}


def _reached(monkeypatch, name):
    """Count the calls of the JAX package's ``name`` (a Pallas backward)."""
    calls = []
    fn = getattr(jfa, name)

    def counted(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)

    monkeypatch.setattr(jfa, name, counted)
    return calls


@pytest.mark.parametrize("dims,causal,mask_kind", BIAS_CASES, ids=BIAS_IDS)
@pytest.mark.parametrize(**PALLAS)
@pytest.mark.parametrize(**DTYPES)
def test_k8_k9_wgmma_arithmetic_matches_both_pallas_kernels(
        monkeypatch, dtype, pallas, dims, causal, mask_kind):
    """K8/K9's bias-form wgmma bodies (64 x 64 tiles) from K7's emulated
    out and row stats, in bf16 and fp16, against jax.grad through the
    Pallas flash_attention_bias in the same dtype in interpret mode with
    its backward forced to the batched kernel (K8) or the row-serial one
    (K9), which the VJP is checked to reach: dq, dk, dv and dbias, each
    atol the dtype's tolerance times its largest entry."""
    mode, fn = pallas
    seed = sum(dims) + 21
    (q, k, v, dout), mask, bias = _bias_inputs(dims, mask_kind, seed=seed,
                                               dtype=dtype)
    _, _, got = _emulate(q, k, v, dout, mask, bias, causal, dtype)
    key = (dims, causal, mask_kind, str(dtype), mode)
    if key not in _REFERENCE:
        monkeypatch.setenv("MMGL_BIAS_BWD_BATCHED", mode)
        calls = _reached(monkeypatch, fn)
        _REFERENCE[key] = _jax_bias_reference(
            causal, q, k, v, dout, mask, bias, q.shape[-1] ** -0.5,
            _jdt(dtype))
        assert calls == [fn]
    _, want = _REFERENCE[key]
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        _close_grad(g, w, name, _tol(dtype))


@pytest.mark.parametrize(**DTYPES)
def test_k8_k9_wgmma_arithmetic_with_a_fully_masked_sample(dtype):
    """The same at (2, 197, 197, 2) causal with its bias, sample 0 fully
    masked and sample 1's first 70 keys masked (its first causal rows see
    no real logit), against xla_attention and its jax.grad in fp32 on the
    same values, dbias included: the fully masked rows feed dV from every
    key and give no dQ, no dK and no dbias; dbias is 0 wherever every
    sample's logit is masked."""
    dims = (2, 197, 197, 2)
    (q, k, v, dout), mask, bias = _bias_inputs(dims, "fully_masked",
                                               seed=sum(dims) + 22,
                                               dtype=dtype)
    _, _, got = _emulate(q, k, v, dout, mask, bias, True, dtype)
    jq, jk, jv, jdo = (jnp.asarray(t.numpy()) for t in (q, k, v, dout))
    jmask = jnp.asarray(mask.numpy())
    scale = q.shape[-1] ** -0.5

    def f(q_, k_, v_, b_):
        return xla_attention(q_, k_, v_, kv_mask=jmask, bias=b_[None],
                             causal=True, scale=scale)

    _, vjp = jax.vjp(f, jq, jk, jv, jnp.asarray(bias.numpy()))
    want = [torch.from_numpy(np.array(g)) for g in vjp(jdo)]
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        _close_grad(g, w, name, _tol(dtype))
    assert float(got[0][0].abs().max()) == 0.0     # no dQ, no dK
    assert float(got[1][0].abs().max()) == 0.0
    assert float(got[2][0, -1].abs().max()) > 0.0  # dV from every key
    s = dims[1]
    hidden = torch.arange(s)[:, None] < torch.arange(s)[None, :]
    hidden = hidden | ~mask.bool().any(0)[None, :]
    assert bool((got[3][:, hidden] == 0).all())


# dropout 0.1 with a fully masked sample: (B, Sq, Sk, H), causal
DROP_CASES = [((2, 197, 197, 2), False), ((2, 200, 328, 2), True)]
DROP_IDS = ["197", "200x328-aligned"]


@pytest.mark.parametrize("dims,causal", DROP_CASES, ids=DROP_IDS)
@pytest.mark.parametrize(**DTYPES)
def test_k8_k9_wgmma_dropout_matches_the_plain_versions(dtype, dims, causal):
    """K7 and K8/K9's bias-form wgmma bodies with dropout 0.1 (the keep
    factors of the kernels' Philox bits), sample 0 with a pad hole and
    sample 1 fully masked, at sq == sk and at end-aligned sq < sk, against
    the port's plain versions in the same dtype under the same key (which
    round P times the keep factor and dS to it before their products):
    out atol = rtol the dtype's tolerance, each gradient's atol that times
    its largest entry, dbias included."""
    tol = _tol(dtype)
    (q, k, v, dout), mask, bias = _bias_inputs(
        dims, "hole_fully_masked", seed=sum(dims) + 23, dtype=dtype)
    keep, key = _keep(dims, seed=sum(dims) + 3)
    out, m, got = _emulate(q, k, v, dout, mask, bias, causal, dtype,
                           keep=keep)
    tq, tk, tv, tdo, tb = (t.to(dtype) for t in (q, k, v, dout, bias[None]))
    kw = dict(causal=causal, scale=q.shape[-1] ** -0.5, dropout_rate=RATE,
              dropout_seed=key)
    want_out = fa.bias_attention_reference(tq, tk, tv, bias=tb, kv_mask=mask,
                                           **kw)
    _close(out, want_out, tol, tol, "out")
    want = fa.bias_attention_bwd_reference(tq, tk, tv, mask, tb, want_out,
                                           tdo, **kw)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got,
                          want[:3] + (want[3][0],)):
        _close_grad(g, w, name, tol)
    assert float(m[1].max()) == np.float32(NEG_INF)
    assert float(got[0][1].abs().max()) == 0.0   # sample 1: no dQ


# ---- the launch path -------------------------------------------------------

@pytest.fixture
def allocations(monkeypatch):
    """The sizes of the 1-D fp32 tensors ``torch.empty`` makes (the
    wrappers' scratch)."""
    sizes = []
    empty = torch.empty

    def recorded_empty(*args, **kwargs):
        if (len(args) == 1 and isinstance(args[0], int)
                and kwargs.get("dtype") == torch.float32):
            sizes.append(args[0])
        return empty(*args, **kwargs)

    monkeypatch.setattr(torch, "empty", recorded_empty)
    return sizes


def _bias_bwd_inputs(dtype, gen, b=2, sq=128, sk=148, h=2, d=64):
    q, out, dout = (torch.randn(b, sq, h, d, generator=gen).to(dtype)
                    for _ in range(3))
    k, v = (torch.randn(b, sk, h, d, generator=gen).to(dtype)
            for _ in range(2))
    bias = fa.padded_bias(torch.randn(h, sq, sk, generator=gen).to(dtype))
    m, l = (torch.rand(b, h, sq, generator=gen) + 1 for _ in range(2))
    seed = torch.tensor([5, 6], dtype=torch.int64)
    return q, k, v, out, dout, bias, m, l, seed


def test_k8_k9_card_path_takes_a_null_mask(recorded, allocations):
    """flash_attention_bias_bwd without a mask at T5's prefixed decoder
    (2, 128 x 148, 2, 64), causal, its bias rows padded to 152 in place,
    dropout 0.1, in bf16 and fp16: calls mmgl_bias_bwd_tc through _call
    with a null mask pointer, the bias's own pointer and row stride, K7's
    row max and sum, and one fp32 scratch of delta's B * H * Sq floats
    and the partial after them, builds no mask tensor and counts one
    tensor-core launch; without the row stats (its stats-only pass) the
    scratch holds 3 * B * H * Sq floats before the partial; with an int32
    mask it passes that mask's pointer."""
    calls, masks = recorded
    wrapper = fa.flash_attention_bias_bwd
    gen = torch.Generator().manual_seed(4)
    b, sq, sk, h, d = 2, 128, 148, 2, 64
    for dtype in (torch.bfloat16, torch.float16):
        q, k, v, out, dout, bias, m, l, seed = _bias_bwd_inputs(dtype, gen)
        kw = dict(causal=True, scale=1.0, dropout_rate=0.1,
                  dropout_seed=seed)
        before = (wrapper.launches, wrapper.launches_tc)
        del allocations[:]
        dq, dk, dv, dbias = wrapper(q, k, v, None, bias, out, dout,
                                    row_max=m, row_sum=l, **kw)
        entry, name, args = calls[-1]
        assert entry == "mmgl_bias_bwd_tc"
        assert name == "flash_attention_bias_bwd"
        assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
        assert dbias.shape == bias.shape and dbias.dtype == dtype
        assert args[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
        assert args[3] is None and masks == []
        assert args[4] == bias.data_ptr() and args[5] == seed.data_ptr()
        assert args[14:16] == (m.data_ptr(), l.data_ptr())
        assert args[16:21] == (b, sq, sk, h, d) and args[22] is True
        assert args[-1] == 152                      # the bias's row stride
        # one fp32 scratch: delta's B * H * Sq floats, then the partial
        assert allocations == [b * h * sq + b * h * sq * sk]
        assert args[13] == args[12] + 4 * b * h * sq
        assert (wrapper.launches, wrapper.launches_tc) == (
            before[0] + 1, before[1] + 1)
        del allocations[:]
        wrapper(q, k, v, None, bias, out, dout, **kw)
        assert calls[-1][2][14:16] == (None, None)
        assert allocations == [3 * b * h * sq + b * h * sq * sk]
    mask = torch.ones(b, sk, dtype=torch.int32)
    wrapper(q, k, v, mask, bias, out, dout, row_max=m, row_sum=l, **kw)
    entry, _, args = calls[-1]
    assert entry == "mmgl_bias_bwd_tc" and args[3] == mask.data_ptr()
    assert masks == []


def test_k8_k9_fp32_card_path_keeps_a_mask_of_ones(recorded, allocations):
    """In fp32 flash_attention_bias_bwd without a mask calls the scalar
    entry mmgl_bias_bwd through _call with a mask of ones (its bodies read
    one), a contiguous bias and the 3 * B * H * Sq scratch of its stats
    pass, and counts a launch but no tensor-core one."""
    calls, masks = recorded
    wrapper = fa.flash_attention_bias_bwd
    gen = torch.Generator().manual_seed(5)
    b, sq, sk, h = 2, 128, 148, 2
    q, k, v, out, dout, bias, _, _, seed = _bias_bwd_inputs(torch.float32,
                                                            gen)
    before = (wrapper.launches, wrapper.launches_tc)
    dq, _, _, dbias = wrapper(q, k, v, None, bias, out, dout, causal=True,
                              scale=1.0, dropout_rate=0.1, dropout_seed=seed)
    entry, name, args = calls[-1]
    assert entry == "mmgl_bias_bwd" and name == "flash_attention_bias_bwd"
    assert args[3] is not None and len(masks) == 1
    assert masks[0][2] is None              # built for "no mask"
    assert args[4] != bias.data_ptr()       # the padded rows made contiguous
    assert allocations[0] == 3 * b * h * sq
    assert dq.shape == q.shape and dbias.shape == bias.shape
    assert (wrapper.launches, wrapper.launches_tc) == (before[0] + 1,
                                                       before[1])
