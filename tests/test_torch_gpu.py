"""The port's CUDA attention kernels against their plain versions, on a card.

Marked ``gpu``: the kernels have no CPU mode, so here they skip. On a machine
with an NVIDIA Hopper GPU and nvcc (this file imports no JAX, and the
repository's conftest imports it, hence --noconftest):

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Tolerances: bf16 atol = rtol = 2e-2 (the plain version rounds the
probabilities to bf16 before PV, the kernel keeps them fp32); fp32 atol 2e-5
with TF32 off, for sums taken in another order.
"""

import numpy as np
import pytest
import torch

from mmgl_tpu_torch.ops import flash_attention as fa

TOL = {torch.bfloat16: (2e-2, 2e-2), torch.float32: (2e-5, 0.0)}

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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("name,dims,causal", CASES)
def test_kernel_matches_plain_version(name, dims, causal, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the CUDA kernels have no "
                    "CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b, sq, sk, h = dims
    rng = np.random.RandomState(sq * 7 + sk + h)
    dev = torch.device("cuda")
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
