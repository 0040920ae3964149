"""The port's CUDA attention kernels against their plain versions, on a card.

Marked ``gpu``: the kernels have no CPU mode, so here they skip. On a machine
with an NVIDIA Hopper GPU and nvcc (this file imports no JAX, and the
repository's conftest imports it, hence --noconftest):

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Every kernel takes its tensor-core body in bf16 and fp16 and its scalar
body in fp32; each case checks which body its launches counted. K8/K9 in
bf16 and fp16 starts from K7's row stats where autograd runs it, and
equals, bit for bit, K8/K9 with its own stats pass.

Forward tolerances: bf16 atol = rtol = 2e-2 (the plain version rounds the
normalised probabilities to bf16 before PV, the kernel the unnormalised ones
and divides after); fp16 atol = rtol = 5e-3 (the same roundings with three
more mantissa bits: 2^-11 against bf16's 2^-8); fp32 atol 2e-5 with TF32
off, for sums taken in another order.

Backward (K3, K5, K6, K8/K9) tolerances, per gradient and relative to its
largest entry m:
atol = 2e-2 m and rtol = 2e-2 in bf16 (the plain version rounds P and dS to
bf16 before their products, as the Pallas kernel does, and so does the
tensor-core body, from logits summed in another order: a sum over hundreds
of keys of terms each off by a bf16 ulp); atol = 5e-3 m and rtol = 5e-3 in
fp16, for the same roundings to fp16;
atol = 1e-5 m in fp32, for sums in another order.
"""

import numpy as np
import pytest
import torch

from mmgl_tpu_torch.ops import flash_attention as fa

TOL = {torch.bfloat16: (2e-2, 2e-2), torch.float16: (5e-3, 5e-3),
       torch.float32: (2e-5, 0.0)}
BWD_TOL = {torch.bfloat16: 2e-2, torch.float16: 5e-3, torch.float32: 1e-5}
# every dtype, and the tensor-core bodies' two
DTYPES = dict(argnames="dtype",
              argvalues=[torch.bfloat16, torch.float16, torch.float32],
              ids=["bf16", "fp16", "fp32"])
TC_DTYPES = dict(argnames="dtype", argvalues=[torch.bfloat16, torch.float16],
                 ids=["bf16", "fp16"])

# (kernel, (B, Sq, Sk, H), causal): the main path's shapes, ragged lengths,
# and K1 with sq < sk (causal aligned at the ends)
CASES = [
    ("flash_attention_allheads", (4, 640, 640, 12), True),
    ("flash_attention_allheads", (4, 512, 512, 12), True),
    ("flash_attention_allheads", (2, 128, 256, 3), True),
    ("flash_attention_allheads", (2, 256, 256, 2), False),
    ("fused_heads_attention", (24, 197, 197, 12), False),
    ("fused_heads_attention", (3, 77, 77, 4), True),
    ("fused_heads_attention", (2, 1, 1, 1), False),
]

# K3: (B, Sq, Sk, H), causal, mask: the training shape with the prompt and
# summary pad hole, the same with a fully masked sample, and ragged lengths
# (tiles cut by the bounds checks, sq < sk)
BWD_CASES = [
    ((4, 640, 640, 12), True, "hole"),
    ((4, 640, 640, 12), True, "fully_masked"),
    ((3, 333, 333, 2), False, "fully_masked"),
    ((2, 100, 228, 3), True, "hole"),
]


def _counts(*wrappers):
    """A function that returns, per wrapper, (launches, tensor-core
    launches) since this call."""
    before = [(w.launches, w.launches_tc) for w in wrappers]
    return lambda: [(w.launches - n, w.launches_tc - n_tc)
                    for w, (n, n_tc) in zip(wrappers, before)]


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the CUDA kernels have no "
                    "CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def hole_mask(b, s, seed):
    """(B, S) int32: every sample a prompt then a summary, each right-padded,
    so the valid keys have a hole (the decoder-only training batch)."""
    rng = np.random.RandomState(seed)
    mask = np.ones((b, s), np.int32)
    cut = s * 4 // 5
    for i in range(b):
        mask[i, rng.randint(cut // 5, cut):cut] = 0
        mask[i, cut + rng.randint(1, s - cut):] = 0
    return mask


@pytest.mark.gpu
@pytest.mark.parametrize(**DTYPES)
@pytest.mark.parametrize("name,dims,causal", CASES)
def test_kernel_matches_plain_version(name, dims, causal, dtype):
    dev = _device()
    b, sq, sk, h = dims
    rng = np.random.RandomState(sq * 7 + sk + h)
    q = torch.from_numpy(rng.randn(b, sq, h, 64).astype(np.float32))
    k = torch.from_numpy(rng.randn(b, sk, h, 64).astype(np.float32))
    v = torch.from_numpy(rng.randn(b, sk, h, 64).astype(np.float32))
    mask = (rng.uniform(size=(b, sk)) > 0.3).astype(np.int32)
    mask[0] = 0                                   # a fully masked sample
    q, k, v = (t.to(dev, dtype) for t in (q, k, v))
    mask = torch.from_numpy(mask).to(dev)

    kernel = getattr(fa, name)
    plain = getattr(fa, {"flash_attention_allheads":
                         "allheads_attention_reference",
                         "fused_heads_attention":
                         "fused_heads_attention_reference"}[name])
    before = (kernel.launches, kernel.launches_tc)
    got = kernel(q, k, v, kv_mask=mask, causal=causal)
    torch.cuda.synchronize()
    assert (kernel.launches, kernel.launches_tc) == (
        before[0] + 1, before[1] + (dtype != torch.float32))
    ref = plain(q, k, v, kv_mask=mask, causal=causal)
    atol, rtol = TOL[dtype]
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)


def texts_mask(b, s, seed, hole):
    """(B, S) int32 key mask of neighbour texts: each right-padded to a
    random length, sample 0 empty (all zero); with ``hole`` also a pad
    hole in the middle of each of the others."""
    rng = np.random.RandomState(seed)
    mask = np.zeros((b, s), np.int32)
    for i in range(1, b):
        n = rng.randint(2, s + 1)
        mask[i, :n] = 1
        if hole and n > 8:
            a = rng.randint(1, n // 2)
            mask[i, a:a + rng.randint(1, n // 4 + 1)] = 0
    return mask


@pytest.mark.gpu
@pytest.mark.parametrize(**DTYPES)
@pytest.mark.parametrize("hole", [False, True], ids=["padded", "hole"])
def test_k2_causal_at_the_clip_text_shape(hole, dtype):
    """K2's causal form at the CLIP text tower's (44, 77, 8, 64): 11
    neighbour texts x 4 samples, 8 heads, S padded to 128 inside the
    kernel, right-padded texts and an empty one (a fully masked sample,
    which the plain version gives the mean of V over the 77 keys), with
    and without a pad hole; against its plain version at the tolerances
    above, on the body its dtype takes."""
    dev = _device()
    b, s, h = 44, 77, 8
    rng = np.random.RandomState(77 + hole)
    q, k, v = (torch.from_numpy(rng.randn(b, s, h, 64).astype(np.float32)
                                ).to(dev, dtype) for _ in range(3))
    mask = torch.from_numpy(texts_mask(b, s, 5, hole)).to(dev)
    kernel = fa.fused_heads_attention
    before = (kernel.launches, kernel.launches_tc)
    got = kernel(q, k, v, kv_mask=mask, causal=True)
    torch.cuda.synchronize()
    assert (kernel.launches, kernel.launches_tc) == (
        before[0] + 1, before[1] + (dtype != torch.float32))
    ref = fa.fused_heads_attention_reference(q, k, v, kv_mask=mask,
                                             causal=True)
    atol, rtol = TOL[dtype]
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize(**DTYPES)
@pytest.mark.parametrize("dims,causal,mask_kind", BWD_CASES)
def test_backward_kernel_matches_plain_version(dims, causal, mask_kind,
                                               dtype):
    dev = _device()
    b, sq, sk, h = dims
    rng = np.random.RandomState(sq + 3 * sk + h)
    q, k, v, dout = (
        torch.from_numpy(rng.randn(b, s, h, 64).astype(np.float32)).to(
            dev, dtype) for s in (sq, sk, sk, sq))
    mask = hole_mask(b, sk, seed=sk)
    if mask_kind == "fully_masked":
        mask[0] = 0
    mask = torch.from_numpy(mask).to(dev)
    out = fa.allheads_attention_reference(q, k, v, kv_mask=mask,
                                          causal=causal)

    counted = _counts(fa.flash_attention_allheads_bwd)
    got = fa.flash_attention_allheads_bwd(q, k, v, mask, out, dout,
                                          causal=causal)
    torch.cuda.synchronize()
    assert counted() == [(1, int(dtype != torch.float32))]
    ref = fa.allheads_attention_bwd_reference(q, k, v, mask, out, dout,
                                              causal=causal)
    tol = BWD_TOL[dtype]
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == dtype and g.shape == r.shape, name
        assert bool(torch.isfinite(g).all()), name
        scale = float(r.float().abs().max())
        torch.testing.assert_close(g.float(), r.float(), atol=tol * scale,
                                   rtol=tol if dtype != torch.float32
                                   else 0.0, msg=name)


@pytest.mark.gpu
def test_attention_grad_runs_the_backward_kernel():
    """autograd through K1 on the card launches K3 once and agrees with the
    plain backward."""
    dev = _device()
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(2, 256, 2, 64).astype(np.float32))
               .to(dev).requires_grad_() for _ in range(3))
    mask = torch.from_numpy(hole_mask(2, 256, seed=1)).to(dev)
    out = fa.flash_attention_allheads(q, k, v, kv_mask=mask, causal=True)
    assert out.grad_fn is not None
    dout = torch.randn_like(out)
    before = fa.flash_attention_allheads_bwd.launches
    got = torch.autograd.grad(out, (q, k, v), dout)
    assert fa.flash_attention_allheads_bwd.launches == before + 1
    ref = fa.allheads_attention_bwd_reference(q.detach(), k.detach(),
                                              v.detach(), mask, out.detach(),
                                              dout, causal=True)
    for g, r in zip(got, ref):
        torch.testing.assert_close(
            g, r, atol=BWD_TOL[torch.float32] * float(r.abs().max()), rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize(**DTYPES)
def test_k1_k3_at_head_dim_128_under_checkpoint(dtype):
    """K1 and K3 at (2, 128, 4, 128), causal with a pad hole, inside
    ``torch.utils.checkpoint`` (non-reentrant, as ``--remat`` runs a
    layer): the forward launches K1 twice (the forward and the recompute),
    the backward K3 once; the output within the forward tolerance, and the
    gradients within the backward one, of the plain versions on the same
    inputs; the tensor-core bodies in bf16 and fp16."""
    dev = _device()
    rng = np.random.RandomState(128)
    q, k, v, dout = (torch.from_numpy(rng.randn(2, 128, 4, 128).astype(
        np.float32)).to(dev, dtype) for _ in range(4))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    mask = torch.from_numpy(hole_mask(2, 128, seed=3)).to(dev)
    counts = _counts(fa.flash_attention_allheads,
                     fa.flash_attention_allheads_bwd)
    out = torch.utils.checkpoint.checkpoint(
        lambda a, b, c: fa.flash_attention_allheads(a, b, c, kv_mask=mask,
                                                    causal=True),
        q, k, v, use_reentrant=False)
    got = torch.autograd.grad(out, (q, k, v), dout)
    tc = int(dtype != torch.float32)
    assert counts() == [(2, 2 * tc), (1, tc)]
    ref = fa.allheads_attention_reference(q.detach(), k.detach(), v.detach(),
                                          kv_mask=mask, causal=True)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.detach().float(), ref.float(), atol=atol,
                               rtol=rtol)
    ref_g = fa.allheads_attention_bwd_reference(
        q.detach(), k.detach(), v.detach(), mask, out.detach(), dout,
        causal=True)
    for name, g, r in zip("qkv", got, ref_g):
        _close_rel(g, r, dtype, f"d{name}")


# ---- K1 and K3 on their wgmma/TMA bodies ----------------------------------

# lengths whose tiles TMA's 64-row boxes and the 64- and 128-row tiles cut
# (a row past S reads zeros), family 7's 205 and OPT's 640
WGMMA_LENGTHS = [1, 63, 64, 65, 127, 128, 129, 205, 640]
# (Sq, Sk) with the ends aligned, causal
WGMMA_ALIGNED = [(65, 129), (100, 228), (205, 640)]


def wgmma_mask(b, s, seed):
    """(B, S) int32, B = 3: sample 0 a prompt and a summary with a pad hole
    (the training batch), sample 1 its first third masked (its first causal
    rows see no valid key: fully masked rows), sample 2 all masked."""
    mask = hole_mask(b, s, seed) if s >= 5 else np.ones((b, s), np.int32)
    mask[1] = 1
    mask[1, :max(1, s // 3)] = 0
    mask[2] = 0
    return mask


def _wgmma_check(b, sq, sk, h, d, dtype, causal, seed):
    """K1 (with its row stats) and K3, without and from them, against the
    plain versions at the tolerances above: the row max within 1e-5 and
    the sum within 1e-4 of ``_row_stats`` (exp2 on the card's ex2, a few
    ulp); K3 from K1's stats equal to K3 with its own stats pass, bit for
    bit; a gradient's atol its tolerance times its largest entry, or 1e-3
    where that is smaller (dQ and dK at S = 1 are 0, the softmax of one
    key, and both sides hold only the residue of dP - delta, ~1e-7)."""
    dev = _device()
    rng = np.random.RandomState(seed)
    q, k, v, dout = (torch.from_numpy(rng.randn(b, s, h, d).astype(
        np.float32)).to(dev, dtype) for s in (sq, sk, sk, sq))
    mask = torch.from_numpy(wgmma_mask(b, sk, seed)).to(dev)
    counts = _counts(fa.flash_attention_allheads,
                     fa.flash_attention_allheads_bwd)
    out, m, l = fa.flash_attention_allheads_stats(q, k, v, kv_mask=mask,
                                                  causal=causal)
    own = fa.flash_attention_allheads_bwd(q, k, v, mask, out, dout,
                                          causal=causal)
    given = fa.flash_attention_allheads_bwd(q, k, v, mask, out, dout,
                                            causal=causal, row_max=m,
                                            row_sum=l)
    torch.cuda.synchronize()
    assert counts() == [(1, 1), (2, 2)]
    ref = fa.allheads_attention_reference(q, k, v, kv_mask=mask,
                                          causal=causal)
    atol, rtol = TOL[dtype]
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)
    want_m, want_l = fa._row_stats(q, k, mask, causal, d ** -0.5)
    torch.testing.assert_close(m, want_m, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(l, want_l, atol=0.0, rtol=1e-4)
    for name, a, g in zip(("dq", "dk", "dv"), own, given):
        assert torch.equal(a, g), name
    ref_g = fa.allheads_attention_bwd_reference(q, k, v, mask, out, dout,
                                                causal=causal)
    tol = BWD_TOL[dtype]
    for name, g, r in zip(("dq", "dk", "dv"), own, ref_g):
        assert g.dtype == dtype and g.shape == r.shape, name
        assert bool(torch.isfinite(g).all()), name
        scale = max(float(r.float().abs().max()), 1e-3)
        torch.testing.assert_close(g.float(), r.float(), atol=tol * scale,
                                   rtol=tol, msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize(**TC_DTYPES)
@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("s", WGMMA_LENGTHS)
def test_wgmma_bodies_match_plain_versions(s, d, dtype):
    """K1's and K3's wgmma bodies at S = s, causal and not, head dim d, with
    a key-mask hole, fully masked rows and a fully masked sample
    (``wgmma_mask``), against the plain versions (``_wgmma_check``)."""
    for causal in (True, False):
        _wgmma_check(3, s, s, 2, d, dtype, causal, seed=s + d + causal)


@pytest.mark.gpu
@pytest.mark.parametrize(**TC_DTYPES)
@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("sq,sk", WGMMA_ALIGNED)
def test_wgmma_bodies_with_sq_below_sk(sq, sk, d, dtype):
    """The same with Sq < Sk, causal with the ends aligned."""
    _wgmma_check(3, sq, sk, 2, d, dtype, True, seed=sq + sk + d)


# ---- K4/K5: per-head attention (T5's eval cross-attention) -------------------

# (B, Sq, Sk, H, K/V heads), causal: the T5-base cross-attention, a causal
# sq < sk, an MQA broadcast head, ragged lengths, MPT-1.3B's
# cross-attention (640 queries against the 64-token neighbour memory: sq >
# sk, the dK/dV body's one key tile over 10 query tiles) and prefix
# tuning's 704 queries against 20 + 704 keys, causal with the ends aligned
FLASH_CASES = [
    ((4, 128, 512, 12, 12), False),
    ((2, 100, 228, 3, 3), True),
    ((2, 128, 128, 4, 1), False),
    ((3, 333, 77, 2, 2), False),
    ((4, 640, 64, 32, 32), False),
    ((4, 704, 724, 12, 12), True),
]


def _qkv(dims, dtype, dev, seed, scale=1.0):
    b, sq, sk, h, kvh = dims
    rng = np.random.RandomState(seed)
    q = rng.randn(b, sq, h, 64).astype(np.float32) * np.float32(scale)
    k, v = (rng.randn(b, sk, kvh, 64).astype(np.float32) for _ in range(2))
    dout = rng.randn(b, sq, h, 64).astype(np.float32)
    return [torch.from_numpy(t).to(dev, dtype) for t in (q, k, v, dout)]


def _close_rel(got, ref, dtype, name):
    """Within the backward tolerance, relative to ref's largest entry."""
    tol = BWD_TOL[dtype]
    assert got.dtype == ref.dtype and got.shape == ref.shape, name
    assert bool(torch.isfinite(got).all()), name
    scale = float(ref.float().abs().max())
    torch.testing.assert_close(got.float(), ref.float(), atol=tol * scale,
                               rtol=tol if dtype != torch.float32 else 0.0,
                               msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize(**DTYPES)
@pytest.mark.parametrize("dims,causal", FLASH_CASES)
def test_flash_kernels_match_plain_versions(dims, causal, dtype):
    """K4 forward and, through autograd, K5 (under MQA dK/dV summed over the
    broadcast heads by expand's gradient) against the plain versions."""
    dev = _device()
    b, sq, sk, h, kvh = dims
    q, k, v, dout = _qkv(dims, dtype, dev, seed=sq + sk + kvh)
    mask = hole_mask(b, sk, seed=sk)
    mask[-1] = 0                                   # a fully masked sample
    mask = torch.from_numpy(mask).to(dev)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    counted = _counts(fa.flash_attention, fa.flash_attention_bwd)
    got = fa.flash_attention(q, k, v, kv_mask=mask, causal=causal)
    grads = torch.autograd.grad(got, (q, k, v), dout)
    torch.cuda.synchronize()
    assert counted() == [(1, int(dtype != torch.float32))] * 2
    kx, vx = (t.detach().expand(b, sk, h, 64) for t in (k, v))
    ref = fa.flash_attention_reference(q.detach(), kx, vx, kv_mask=mask,
                                       causal=causal)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.detach().float(), ref.float(), atol=atol,
                               rtol=rtol)
    rq, rk, rv = fa.flash_attention_bwd_reference(
        q.detach(), kx.contiguous(), vx.contiguous(), mask, got.detach(),
        dout, causal=causal)
    rk, rv = (r.float().sum(2, keepdim=True).to(dtype) if kvh == 1 else r
              for r in (rk, rv))
    for name, g, r in zip(("dq", "dk", "dv"), grads, (rq, rk, rv)):
        _close_rel(g, r, dtype, name)


# ---- K7/K8/K9: bias attention with dropout (T5) -------------------------------

# (B, Sq, Sk, H), causal, bias: the T5-base encoder, decoder self and
# training cross-attention, ragged lengths, and the decoder with 20 prefix
# keys (148: a bias row padded to 152, the last key tile 20 wide, the
# prefix left of the diagonal)
BIAS_CASES = [
    ((4, 512, 512, 12), False, True),
    ((4, 128, 128, 12), True, True),
    ((4, 128, 512, 12), False, False),
    ((3, 333, 333, 2), True, True),
    ((4, 128, 148, 12), True, True),
]


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["nodrop", "drop"])
@pytest.mark.parametrize(**DTYPES)
@pytest.mark.parametrize("dims,causal,with_bias", BIAS_CASES)
def test_bias_kernels_match_plain_versions(dims, causal, with_bias, dtype,
                                           rate):
    """K7 forward and K8/K9 (dq, dk, dv, dbias) against the plain versions,
    which drop the same elements (the same Philox bits); T5's scale 1.0
    with D**-0.5 folded into q."""
    dev = _device()
    b, sq, sk, h = dims
    q, k, v, dout = _qkv((b, sq, sk, h, h), dtype, dev, seed=sq + sk,
                         scale=0.125)
    mask = hole_mask(b, sk, seed=sk + 1)
    mask[0] = 0
    mask = torch.from_numpy(mask).to(dev)
    bias = None
    if with_bias:
        rng = np.random.RandomState(sq)
        bias = torch.from_numpy(rng.randn(1, h, sq, sk).astype(
            np.float32)).to(dev, dtype).requires_grad_()
    seed = torch.tensor([123456789, 987654321], dtype=torch.int64,
                        device=dev)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    counted = _counts(fa.flash_attention_bias, fa.flash_attention_bias_bwd)
    got = fa.flash_attention_bias(q, k, v, bias=bias, kv_mask=mask,
                                  causal=causal, scale=1.0, dropout_rate=rate,
                                  dropout_seed=seed)
    wrt = (q, k, v) + ((bias,) if with_bias else ())
    grads = torch.autograd.grad(got, wrt, dout)
    torch.cuda.synchronize()
    assert counted() == [(1, int(dtype != torch.float32))] * 2
    plain_bias = None if bias is None else bias.detach()
    ref = fa.bias_attention_reference(
        q.detach(), k.detach(), v.detach(), bias=plain_bias, kv_mask=mask,
        causal=causal, scale=1.0, dropout_rate=rate, dropout_seed=seed)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.detach().float(), ref.float(), atol=atol,
                               rtol=rtol)
    refs = fa.bias_attention_bwd_reference(
        q.detach(), k.detach(), v.detach(), mask, plain_bias, got.detach(),
        dout, causal=causal, scale=1.0, dropout_rate=rate, dropout_seed=seed)
    for name, g, r in zip(("dq", "dk", "dv", "dbias"), grads, refs):
        _close_rel(g, r, dtype, name)


def kernel_keep_mask(b, sq, sk, h, seed, rate, dev, dtype=torch.float32):
    """(B, H, Sq, Sk) bool: the elements K7 keeps, read off its output.
    With q = 0 and one 64-key window unmasked, P is 1/64 on the window's
    keys, and with v the identity on the window, out[..., d] is the keep
    factor of key window + d over 64: zero exactly where it was dropped."""
    q = torch.zeros(b, sq, h, 64, device=dev, dtype=dtype)
    keep = torch.zeros(b, h, sq, sk, dtype=torch.bool, device=dev)
    for w0 in range(0, sk, 64):
        n = min(64, sk - w0)
        mask = torch.zeros(b, sk, dtype=torch.int32, device=dev)
        mask[:, w0:w0 + n] = 1
        v = torch.zeros(b, sk, h, 64, device=dev, dtype=dtype)
        v[:, w0:w0 + n, :, :n] = torch.eye(n, device=dev)[:, None, :]
        out = fa.flash_attention_bias(q, torch.zeros_like(v), v, kv_mask=mask,
                                      scale=1.0, dropout_rate=rate,
                                      dropout_seed=seed)
        keep[..., w0:w0 + n] = (out[..., :n] > 0).permute(0, 2, 1, 3)
    return keep


@pytest.mark.gpu
@pytest.mark.parametrize(**DTYPES)
@pytest.mark.parametrize("dims", [(4, 512, 512, 12), (4, 128, 512, 12),
                                  (3, 333, 77, 2), (4, 128, 148, 12)])
def test_dropout_mask_is_the_plain_versions_bit_for_bit(dims, dtype):
    """K7, in its tensor-core body (bf16, fp16) and its scalar one (fp32), keeps
    exactly the elements the plain version keeps, and about 0.9 of them
    (within 6 sigma)."""
    dev = _device()
    b, sq, sk, h = dims
    seed = torch.tensor([2 ** 32 - 3, 17], dtype=torch.int64, device=dev)
    got = kernel_keep_mask(b, sq, sk, h, seed, 0.1, dev, dtype)
    from mmgl_tpu_torch.ops import attention as att
    want = att.dropout_bits(seed, (b, h, sq, sk)) < att.dropout_threshold(
        0.1)[0]
    assert torch.equal(got, want)
    n = got.numel()
    assert abs(float(got.float().mean()) - 0.9) < 6 * (0.09 / n) ** 0.5


# ---- K4 with its row stats and K6, the blocked causal backward (OPT-350M) --

# (B, Sq, Sk, H), mask, all causal: OPT-350M's training shape with its pad
# hole, the same with a fully masked sample, ragged lengths, and an
# end-aligned sq < sk
BLOCKED_CASES = [
    ((4, 2048, 2048, 16), "hole"),
    ((4, 2048, 2048, 16), "fully_masked"),
    ((3, 333, 333, 2), "hole"),
    ((2, 200, 328, 2), "hole"),
]
# K4's row max and sum, atol = rtol: fp32 sums of up to 2048 exponentials in
# another order
STATS_TOL = 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize(**DTYPES)
@pytest.mark.parametrize("dims,mask_kind", BLOCKED_CASES)
def test_blocked_kernels_match_plain_versions(dims, mask_kind, dtype):
    """K4 keeping its row stats, then K6 from them, against the plain
    versions on the same inputs."""
    dev = _device()
    b, sq, sk, h = dims
    q, k, v, dout = _qkv((b, sq, sk, h, h), dtype, dev, seed=sq + 2 * sk)
    mask = hole_mask(b, sk, seed=sk + 3)
    if mask_kind == "fully_masked":
        mask[0] = 0
    mask = torch.from_numpy(mask).to(dev)
    counted = _counts(fa.flash_attention, fa.flash_attention_blocked_bwd)
    out, m, l = fa.flash_attention_stats(q, k, v, kv_mask=mask, causal=True)
    got = fa.flash_attention_blocked_bwd(q, k, v, mask, out, dout, m, l,
                                         causal=True)
    torch.cuda.synchronize()
    assert counted() == [(1, int(dtype != torch.float32))] * 2
    ref_out, ref_m, ref_l = fa.flash_attention_reference(
        q, k, v, kv_mask=mask, causal=True, with_stats=True)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref_out.float(), atol=atol,
                               rtol=rtol)
    for got_s, ref_s in ((m, ref_m), (l, ref_l)):
        assert got_s.dtype == torch.float32 and got_s.shape == (b, h, sq)
        torch.testing.assert_close(got_s, ref_s, atol=STATS_TOL,
                                   rtol=STATS_TOL)
    del ref_out
    refs = fa.flash_attention_blocked_bwd_reference(q, k, v, mask, out, dout,
                                                    m, l, causal=True)
    for name, g, r in zip(("dq", "dk", "dv"), got, refs):
        _close_rel(g, r, dtype, name)


@pytest.mark.gpu
@pytest.mark.parametrize(**DTYPES)
def test_flash_grad_under_the_flag_runs_k6_and_agrees_with_k5(monkeypatch,
                                                              dtype):
    """With the blocked backward selected, autograd through K4 at a long
    causal window launches K4 and K6 once each and K5 not at all, and K6's
    gradient is K5's on the same inputs, bit for bit: K5's stats pass
    computes K4's row max and sum with K4's own code, and the two share the
    delta pass and the tile kernels."""
    dev = _device()
    monkeypatch.setattr(fa, "BLOCKED_BWD", True)
    q, k, v, dout = _qkv((2, 1024, 1024, 4, 4), dtype, dev, seed=5)
    mask = torch.from_numpy(hole_mask(2, 1024, seed=6)).to(dev)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    counted = _counts(fa.flash_attention, fa.flash_attention_blocked_bwd,
                      fa.flash_attention_bwd)
    out = fa.flash_attention(q, k, v, kv_mask=mask, causal=True)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    tc = int(dtype != torch.float32)
    assert counted() == [(1, tc), (1, tc), (0, 0)]
    k5 = fa.flash_attention_bwd(q.detach(), k.detach(), v.detach(), mask,
                                out.detach(), dout, causal=True)
    for name, g, r in zip(("dq", "dk", "dv"), grads, k5):
        _close_rel(g, r, dtype, name)
        assert torch.equal(g, r), name


# ---- the tensor-core bodies at the fragment edges (bf16, fp16) -------------

# lengths that cut the 16-row fragments and the 64-row tiles; causal needs
# sq <= sk (ends aligned)
EDGE_LENGTHS = (1, 15, 17, 63, 65, 197)
EDGE_CASES = [(sq, sk, causal) for sq in EDGE_LENGTHS for sk in EDGE_LENGTHS
              for causal in (False, True) if sq <= sk or not causal]


@pytest.mark.gpu
@pytest.mark.parametrize(**TC_DTYPES)
@pytest.mark.parametrize("sq,sk,causal", EDGE_CASES)
def test_tensor_core_bodies_at_fragment_edges(sq, sk, causal, dtype):
    """In bf16 and fp16: K4 with its row stats, K6 and K5 (and K1 where
    sq <= sk, K2 where sq == sk) against their plain versions, with a fully masked sample
    and a sample whose first third of keys is masked (causal rows that see
    no real logit); every launch counted as the tensor-core body; K5's
    gradients equal K6's bit for bit."""
    dev = _device()
    b, h = 3, 2
    q, k, v, dout = _qkv((b, sq, sk, h, h), dtype, dev,
                         seed=1000 * sq + sk)
    rng = np.random.RandomState(sq + 7 * sk)
    mask = (rng.uniform(size=(b, sk)) > 0.25).astype(np.int32)
    mask[0] = 0
    mask[1, :max(1, sk // 3)] = 0
    mask = torch.from_numpy(mask).to(dev)
    wrappers = (fa.flash_attention, fa.flash_attention_blocked_bwd,
                fa.flash_attention_bwd, fa.flash_attention_allheads,
                fa.fused_heads_attention)
    counted = _counts(*wrappers)
    out, m, l = fa.flash_attention_stats(q, k, v, kv_mask=mask,
                                         causal=causal)
    k6 = fa.flash_attention_blocked_bwd(q, k, v, mask, out, dout, m, l,
                                        causal=causal)
    k5 = fa.flash_attention_bwd(q, k, v, mask, out, dout, causal=causal)
    others = []
    if sq <= sk:
        others.append(fa.flash_attention_allheads(q, k, v, kv_mask=mask,
                                                  causal=causal))
    if sq == sk:
        others.append(fa.fused_heads_attention(q, k, v, kv_mask=mask,
                                               causal=causal))
    torch.cuda.synchronize()
    want = [(1, 1)] * 3 + [(int(sq <= sk),) * 2, (int(sq == sk),) * 2]
    assert counted() == want

    ref_out, ref_m, ref_l = fa.flash_attention_reference(
        q, k, v, kv_mask=mask, causal=causal, with_stats=True)
    atol, rtol = TOL[dtype]
    for got in [out] + others:
        assert got.dtype == dtype and got.shape == q.shape
        torch.testing.assert_close(got.float(), ref_out.float(), atol=atol,
                                   rtol=rtol)
    for got_s, ref_s in ((m, ref_m), (l, ref_l)):
        torch.testing.assert_close(got_s, ref_s, atol=STATS_TOL,
                                   rtol=STATS_TOL)
    refs = fa.flash_attention_blocked_bwd_reference(q, k, v, mask, out, dout,
                                                    m, l, causal=causal)
    # with one key dQ and dK are 0 in exact arithmetic (P = 1, dS = 0) and
    # the kernel's are rounding residue: their atol takes dV's scale there
    floor = float(refs[2].float().abs().max()) if sk == 1 else 0.0
    for name, g, g5, r in zip(("dq", "dk", "dv"), k6, k5, refs):
        scale = max(float(r.float().abs().max()), floor)
        assert bool(torch.isfinite(g).all()), name
        torch.testing.assert_close(g.float(), r.float(),
                                   atol=BWD_TOL[dtype] * scale,
                                   rtol=BWD_TOL[dtype], msg=name)
        assert torch.equal(g, g5), name


# the bias bodies' three forms on T5's path: (bias, dropout rate)
BIAS_FORMS = {"bias": (True, 0.0), "bias_drop": (True, 0.1),
              "drop": (False, 0.1)}


@pytest.mark.gpu
@pytest.mark.parametrize(**TC_DTYPES)
@pytest.mark.parametrize("form", list(BIAS_FORMS))
@pytest.mark.parametrize("sq,sk,causal", EDGE_CASES)
def test_bias_bodies_at_fragment_edges(sq, sk, causal, form, dtype):
    """In bf16 and fp16: K7 and, through autograd from its row stats, K8/K9 (dbias
    included) against their plain versions, with a fully masked sample and
    a sample whose first third of keys is masked; every launch counted as
    the tensor-core body; K8/K9 with its own stats pass equal to the
    autograd gradients bit for bit."""
    dev = _device()
    with_bias, rate = BIAS_FORMS[form]
    b, h = 3, 2
    q, k, v, dout = _qkv((b, sq, sk, h, h), dtype, dev,
                         seed=1000 * sq + sk + 1, scale=0.125)
    rng = np.random.RandomState(sq + 7 * sk + 1)
    mask = (rng.uniform(size=(b, sk)) > 0.25).astype(np.int32)
    mask[0] = 0
    mask[1, :max(1, sk // 3)] = 0
    mask = torch.from_numpy(mask).to(dev)
    bias = None
    if with_bias:
        bias = torch.from_numpy(rng.randn(1, h, sq, sk).astype(
            np.float32)).to(dev, dtype).requires_grad_()
    seed = torch.tensor([sq * 7919 + sk, 31], dtype=torch.int64, device=dev)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    wrt = (q, k, v) + ((bias,) if with_bias else ())
    counted = _counts(fa.flash_attention_bias, fa.flash_attention_bias_bwd)
    out = fa.flash_attention_bias(q, k, v, bias=bias, kv_mask=mask,
                                  causal=causal, scale=1.0, dropout_rate=rate,
                                  dropout_seed=seed)
    grads = torch.autograd.grad(out, wrt, dout)
    plain_bias = None if bias is None else bias.detach()
    own = fa.flash_attention_bias_bwd(
        q.detach(), k.detach(), v.detach(), mask,
        None if bias is None else plain_bias[0], out.detach(), dout,
        causal=causal, scale=1.0, dropout_rate=rate, dropout_seed=seed)
    torch.cuda.synchronize()
    assert counted() == [(1, 1), (2, 2)]
    ref = fa.bias_attention_reference(
        q.detach(), k.detach(), v.detach(), bias=plain_bias, kv_mask=mask,
        causal=causal, scale=1.0, dropout_rate=rate, dropout_seed=seed)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.detach().float(), ref.float(), atol=atol,
                               rtol=rtol)
    refs = fa.bias_attention_bwd_reference(
        q.detach(), k.detach(), v.detach(), mask, plain_bias, out.detach(),
        dout, causal=causal, scale=1.0, dropout_rate=rate, dropout_seed=seed)
    # with one key dQ, dK and dbias are 0 in exact arithmetic (P = 1,
    # dS = 0) and the kernel's are rounding residue: their atol takes dV's
    # scale there
    floor = float(refs[2].float().abs().max()) if sk == 1 else 0.0
    for name, g, g_own, r in zip(("dq", "dk", "dv", "dbias"), grads,
                                 (*own[:3], None if own[3] is None
                                  else own[3][None]), refs):
        scale = max(float(r.float().abs().max()), floor)
        assert bool(torch.isfinite(g).all()), name
        torch.testing.assert_close(g.float(), r.float(),
                                   atol=BWD_TOL[dtype] * scale,
                                   rtol=BWD_TOL[dtype], msg=name)
        assert torch.equal(g, g_own), name


# K1 and K3-K6 at head dims 80 (OPT and MPT at 2.7B) and 128 (6.7B):
# (B, Sq, Sk, H, D), causal; the 2.7B/6.7B training shape with its pad
# hole, MPT-2.7B's cross-attention over the 64-token memory, ragged
HEAD_DIM_CASES = [((4, 640, 640, 32, 80), True),
                  ((4, 640, 64, 32, 80), False),
                  ((4, 640, 640, 32, 128), True),
                  ((3, 333, 333, 2, 80), True),
                  ((3, 333, 333, 2, 128), True)]


def _qkv_d(dims, dtype, dev, seed):
    b, sq, sk, h, d = dims
    rng = np.random.RandomState(seed)
    q, dout = (rng.randn(b, sq, h, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, sk, h, d).astype(np.float32) for _ in range(2))
    return [torch.from_numpy(t).to(dev, dtype) for t in (q, k, v, dout)]


@pytest.mark.gpu
@pytest.mark.parametrize(**DTYPES)
@pytest.mark.parametrize("dims,causal", HEAD_DIM_CASES)
def test_head_dims_80_and_128_match_plain_versions(dims, causal, dtype):
    """At head dims 80 and 128: K1 and K3 (sq == sk), K4 and K5 through
    autograd, and at the causal shapes K4 with its row stats and K6
    (equal to K5 bit for bit), each against its plain version, a pad hole
    in every sample and sample 0 fully masked; the half types on the
    tensor-core bodies."""
    dev = _device()
    b, sq, sk, h, d = dims
    q, k, v, dout = _qkv_d(dims, dtype, dev, seed=sq + sk + d)
    mask = hole_mask(b, sk, seed=sk + d)
    mask[0] = 0
    mask = torch.from_numpy(mask).to(dev)
    kw = dict(kv_mask=mask, causal=causal)
    atol, rtol = TOL[dtype]
    wrappers = (fa.flash_attention_allheads, fa.flash_attention_allheads_bwd,
                fa.flash_attention, fa.flash_attention_bwd,
                fa.flash_attention_blocked_bwd)
    counted = _counts(*wrappers)
    if sq == sk:
        out = fa.flash_attention_allheads(q, k, v, **kw)
        ref = fa.allheads_attention_reference(q, k, v, **kw)
        torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                                   rtol=rtol)
        got = fa.flash_attention_allheads_bwd(q, k, v, mask, ref, dout,
                                              causal=causal)
        refs = fa.allheads_attention_bwd_reference(q, k, v, mask, ref, dout,
                                                   causal=causal)
        for name, g, r in zip(("dq", "dk", "dv"), got, refs):
            _close_rel(g, r, dtype, "K3 " + name)
    wrt = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*wrt, **kw)
    grads = torch.autograd.grad(out, wrt, dout)
    out = out.detach()
    torch.testing.assert_close(
        out.float(), fa.flash_attention_reference(q, k, v, **kw).float(),
        atol=atol, rtol=rtol)
    refs = fa.flash_attention_bwd_reference(q, k, v, mask, out, dout,
                                            causal=causal)
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        _close_rel(g, r, dtype, "K5 " + name)
    if causal:
        out, m, l = fa.flash_attention_stats(q, k, v, **kw)
        ref_out, ref_m, ref_l = fa.flash_attention_reference(
            q, k, v, with_stats=True, **kw)
        torch.testing.assert_close(out.float(), ref_out.float(), atol=atol,
                                   rtol=rtol)
        for got_s, ref_s in ((m, ref_m), (l, ref_l)):
            torch.testing.assert_close(got_s, ref_s, atol=STATS_TOL,
                                       rtol=STATS_TOL)
        got = fa.flash_attention_blocked_bwd(q, k, v, mask, out, dout, m, l,
                                             causal=True)
        refs = fa.flash_attention_blocked_bwd_reference(
            q, k, v, mask, out, dout, m, l, causal=True)
        for name, g, r in zip(("dq", "dk", "dv"), got, refs):
            _close_rel(g, r, dtype, "K6 " + name)
        k5 = fa.flash_attention_bwd(q, k, v, mask, out, dout, causal=True)
        assert all(torch.equal(g, r) for g, r in zip(got, k5))
    torch.cuda.synchronize()
    half = dtype != torch.float32
    for wrapper, (runs, tc) in zip(wrappers, counted()):
        assert tc == (runs if half else 0), wrapper.__name__
    assert counted()[2][0] >= 1 and counted()[3][0] >= 1


@pytest.mark.gpu
@pytest.mark.parametrize(**DTYPES)
def test_k2_and_k7_refuse_head_dim_80(dtype):
    """K2 and K7-K9 are instantiated at head dim 64 only (no model sends
    them another): at 80 their wrappers raise, naming ROADMAP B, before
    anything launches."""
    dev = _device()
    q, k, v, _ = _qkv_d((2, 197, 197, 12, 80), dtype, dev, seed=80)
    counted = _counts(fa.fused_heads_attention, fa.flash_attention_bias)
    with pytest.raises(ValueError, match="ROADMAP B"):
        fa.fused_heads_attention(q, k, v)
    bias = torch.zeros(1, 12, 197, 197, device=dev, dtype=dtype)
    with pytest.raises(ValueError, match="ROADMAP B"):
        fa.flash_attention_bias(q, k, v, bias=bias)
    assert counted() == [(0, 0), (0, 0)]


# ---- K4 and K7 on the wgmma/TMA forward (bf16, fp16) ------------------------

# K4's query and key lengths on the port's paths and at the 64-row TMA
# box's edges: T5's 128 queries, family 7's 205, MPT's 640, OPT-350M's
# 2048; against MPT's 64-token memory (one key tile, sq > sk), T5's
# prefixed 148, its 512 encoder keys and prefix tuning's 724
K4_SQ = (63, 64, 65, 128, 205, 640, 2048)
K4_SK = (64, 148, 512, 724)


@pytest.mark.gpu
@pytest.mark.parametrize(**TC_DTYPES)
@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("sk", K4_SK)
@pytest.mark.parametrize("sq", K4_SQ)
def test_k4_wgmma_body_at_its_lengths(sq, sk, d, dtype):
    """K4's wgmma body against its plain version, not causal, without a
    mask (a null pointer) and with a pad hole in each sample and sample 0
    fully masked; where sq <= sk also causal with its row stats, K6 from
    them against its plain version and equal to K5 (whose stats pass is
    K4's body in its stats-only form) bit for bit."""
    dev = _device()
    b, h = 2, 2
    q, k, v, dout = _qkv_d((b, sq, sk, h, d), dtype, dev,
                           seed=7 * sq + sk + d)
    mask = hole_mask(b, sk, seed=sk + d)
    mask[0] = 0
    mask = torch.from_numpy(mask).to(dev)
    atol, rtol = TOL[dtype]
    counted = _counts(fa.flash_attention)
    for kv_mask in (None, mask):
        out = fa.flash_attention(q, k, v, kv_mask=kv_mask)
        ref = fa.flash_attention_reference(q, k, v, kv_mask=kv_mask)
        assert out.dtype == dtype and out.shape == q.shape
        torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                                   rtol=rtol)
    torch.cuda.synchronize()
    assert counted() == [(2, 2)]
    if sq > sk:
        return
    out, m, l = fa.flash_attention_stats(q, k, v, kv_mask=mask, causal=True)
    ref_out, ref_m, ref_l = fa.flash_attention_reference(
        q, k, v, kv_mask=mask, causal=True, with_stats=True)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=atol,
                               rtol=rtol)
    for got_s, ref_s in ((m, ref_m), (l, ref_l)):
        torch.testing.assert_close(got_s, ref_s, atol=STATS_TOL,
                                   rtol=STATS_TOL)
    k6 = fa.flash_attention_blocked_bwd(q, k, v, mask, out, dout, m, l,
                                        causal=True)
    k5 = fa.flash_attention_bwd(q, k, v, mask, out, dout, causal=True)
    refs = fa.flash_attention_blocked_bwd_reference(q, k, v, mask, out, dout,
                                                    m, l, causal=True)
    for name, g, g5, r in zip(("dq", "dk", "dv"), k6, k5, refs):
        _close_rel(g, r, dtype, "K6 " + name)
        assert torch.equal(g, g5), name


# K7 at T5-base's shapes: the prefixed decoder (128 queries against 20 + 128
# keys, causal), the encoder and the embedding mode's 576-token encoder
K7_CASES = [((4, 128, 148, 12), True), ((4, 512, 512, 12), False),
            ((4, 576, 576, 12), False)]


@pytest.mark.gpu
@pytest.mark.parametrize(**TC_DTYPES)
@pytest.mark.parametrize("bias_fp32", [False, True], ids=["bias_T",
                                                          "bias_fp32"])
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["nodrop", "drop"])
@pytest.mark.parametrize("dims,causal", K7_CASES)
def test_k7_wgmma_body_at_t5_shapes(dims, causal, rate, bias_fp32, dtype):
    """K7's wgmma body with its bias in the input's type or in fp32, a pad
    hole in each sample and sample 0 fully masked: the same bits from a
    bias whose rows are padded (``padded_bias``, read in place) as from a
    contiguous one; against the plain version; K8/K9 through autograd from
    K7's row stats against its plain version and equal to K8/K9 with its
    own stats pass (K7's body in its stats-only form) bit for bit."""
    dev = _device()
    b, sq, sk, h = dims
    q, k, v, dout = _qkv((b, sq, sk, h, h), dtype, dev, seed=sq + sk + 5,
                         scale=0.125)
    mask = hole_mask(b, sk, seed=sk + 2)
    mask[0] = 0
    mask = torch.from_numpy(mask).to(dev)
    rng = np.random.RandomState(sq + sk)
    bias = torch.from_numpy(rng.randn(1, h, sq, sk).astype(np.float32)).to(
        dev, torch.float32 if bias_fp32 else dtype)
    seed = torch.tensor([sq * 7919 + sk, 2 ** 31 + 5], dtype=torch.int64,
                        device=dev)
    kw = dict(kv_mask=mask, causal=causal, scale=1.0, dropout_rate=rate,
              dropout_seed=seed)
    # the same bias in rows padded to a multiple of 8, read in place
    ld = -(-sk // 8) * 8
    base = torch.nn.functional.pad(bias, (0, ld - sk)).requires_grad_()
    padded = base[..., :sk]
    assert fa._bias_ld(padded[0]) == ld
    counted = _counts(fa.flash_attention_bias, fa.flash_attention_bias_bwd)
    out = fa.flash_attention_bias(q, k, v, bias=bias, **kw)
    wrt = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    got = fa.flash_attention_bias(*wrt, bias=padded, **kw)
    grads = list(torch.autograd.grad(got, wrt + [base], dout))
    assert not bool(grads[3][..., sk:].any())
    grads[3] = grads[3][..., :sk]
    own = fa.flash_attention_bias_bwd(q, k, v, mask, bias[0], out, dout,
                                      causal=causal, scale=1.0,
                                      dropout_rate=rate, dropout_seed=seed)
    torch.cuda.synchronize()
    assert counted() == [(2, 2), (2, 2)]
    assert torch.equal(got.detach(), out)
    ref = fa.bias_attention_reference(q, k, v, bias=bias, **kw)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)
    refs = fa.bias_attention_bwd_reference(q, k, v, mask, bias, out, dout,
                                           causal=causal, scale=1.0,
                                           dropout_rate=rate,
                                           dropout_seed=seed)
    for name, g, g_own, r in zip(("dq", "dk", "dv", "dbias"), grads,
                                 (*own[:3], own[3][None]), refs):
        _close_rel(g, r, dtype, name)
        assert torch.equal(g, g_own), name
