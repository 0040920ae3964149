"""The port's CUDA attention kernels against their plain versions, on a card.

Marked ``gpu``: the kernels have no CPU mode, so here they skip. On a machine
with an NVIDIA Hopper GPU and nvcc (this file imports no JAX, and the
repository's conftest imports it, hence --noconftest):

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Forward tolerances: bf16 atol = rtol = 2e-2 (the plain version rounds the
probabilities to bf16 before PV, the kernel keeps them fp32); fp32 atol 2e-5
with TF32 off, for sums taken in another order.

Backward (K3) tolerances, per gradient and relative to its largest entry m:
atol = 2e-2 m and rtol = 2e-2 in bf16 (the plain version rounds P and dS to
bf16 before their products, as the Pallas kernel does, the kernel keeps
them fp32: a sum over hundreds of keys of terms each off by a bf16 ulp);
atol = 1e-5 m in fp32, for sums in another order.
"""

import numpy as np
import pytest
import torch

from mmgl_tpu_torch.ops import flash_attention as fa

TOL = {torch.bfloat16: (2e-2, 2e-2), torch.float32: (2e-5, 0.0)}
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}

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
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
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
    before = kernel.launches
    got = kernel(q, k, v, kv_mask=mask, causal=causal)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    ref = plain(q, k, v, kv_mask=mask, causal=causal)
    atol, rtol = TOL[dtype]
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
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

    before = fa.flash_attention_allheads_bwd.launches
    got = fa.flash_attention_allheads_bwd(q, k, v, mask, out, dout,
                                          causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_allheads_bwd.launches == before + 1
    ref = fa.allheads_attention_bwd_reference(q, k, v, mask, out, dout,
                                              causal=causal)
    tol = BWD_TOL[dtype]
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == dtype and g.shape == r.shape, name
        assert bool(torch.isfinite(g).all()), name
        scale = float(r.float().abs().max())
        torch.testing.assert_close(g.float(), r.float(), atol=tol * scale,
                                   rtol=tol if dtype == torch.bfloat16
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
