"""Head dims 80 and 128 (OPT and MPT at 2.7B and 6.7B) in the port, against
the JAX package on the CPU.

The attention route (``multi_head_attention``) against the JAX package's,
whose kernels run in interpret mode as tests/test_attention.py runs them:
which kernel each picks, and the forward and gradients in fp32 (atol 1e-5,
sums in another order). Then 2-layer OPT and MPT models at widths 160 and
256 (2 heads of 80 and of 128): both factories' tiny OPT row is widened
for the test (the tables themselves are unchanged), the weights are the
port's seeded ones in both packages (tests/test_torch_peft.py's
``shape_pair``), and logits and every trainable gradient are compared.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

import mmgl_tpu.ops.attention as jatt
import mmgl_tpu.ops.flash_attention as jfa
from mmgl_tpu.models import factory as jfactory
from mmgl_tpu_torch.models import factory, opt
from mmgl_tpu_torch.ops import attention as att
from mmgl_tpu_torch.utils import convert
from test_torch_attention import _close, _hole_mask, _inputs, _t, \
    _weighted_sum
from test_torch_embedding import _args, _batches
from test_torch_peft import check_forward_and_grads, perturb, shape_pair

# (q shape, k shape, causal): self-attention inside K1's envelope, past it
# (K4), sq != sk (K4), CLIP-like ragged lengths inside and outside K2's
# width envelope (H * D <= 1024)
ROUTE_CASES = [((2, 128, 2, 80), (2, 128, 2, 80), True),
               ((2, 128, 2, 128), (2, 128, 2, 128), True),
               ((2, 256, 32, 80), (2, 256, 32, 80), True),
               ((1, 896, 2, 80), (1, 896, 2, 80), True),
               ((2, 128, 2, 128), (2, 256, 2, 128), False),
               ((2, 197, 12, 80), (2, 197, 12, 80), False),
               ((2, 197, 32, 80), (2, 197, 32, 80), False)]
# the JAX package's function -> the port's route
_JAX_ROUTES = {"flash_attention_allheads": "allheads",
               "flash_attention": "flash",
               "fused_heads_attention": "fused_heads",
               "flash_attention_bias": "bias",
               "xla_attention": "reference"}


def _jax_route(monkeypatch, q_shape, k_shape, causal):
    """The function the JAX package's multi_head_attention calls for these
    shapes (use_pallas=True, interpret), by spying on each."""
    calls = []
    for module, name in ((jfa, "flash_attention_allheads"),
                         (jfa, "flash_attention"),
                         (jfa, "fused_heads_attention"),
                         (jfa, "flash_attention_bias"),
                         (jatt, "xla_attention")):
        orig = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _o=orig, _n=name, **kw: (
            calls.append(_n), _o(*a, **kw))[1])
    q = jnp.zeros(q_shape, jnp.float32)
    k = jnp.zeros(k_shape, jnp.float32)
    jatt.multi_head_attention(q, k, k, causal=causal, use_pallas=True,
                              interpret=True)
    return calls[0]


@pytest.mark.parametrize("q_shape,k_shape,causal", ROUTE_CASES)
def test_route_picks_the_jax_mapping(monkeypatch, q_shape, k_shape, causal):
    """At D 80 and 128 the port's route takes the JAX package's kernel
    wherever that takes one; where it takes XLA for a ragged length past
    K2's width envelope (H * D = 2560), the port takes K1, its stated
    route for such lengths (ops/attention.py), and never K2."""
    want = _JAX_ROUTES[_jax_route(monkeypatch, q_shape, k_shape, causal)]
    got = att.attention_route(q_shape, k_shape)
    if want == "reference" and q_shape[1] % 128:
        assert got == "allheads" and q_shape[2] * q_shape[3] > 1024
    else:
        assert got == want
    assert att.allheads_head_pair(q_shape[3]) == jfa._allheads_hp(
        q_shape[3])


# (B, Sq, Sk, H, D, causal): K1/K3 at an aligned self-attention, K4/K5 at
# sq != sk and causal with the ends aligned
KERNEL_CASES = [(2, 128, 128, 2, 80, True), (2, 128, 128, 2, 128, False),
                (2, 128, 256, 2, 80, False), (2, 128, 256, 2, 128, True)]


@pytest.mark.parametrize("b,sq,sk,h,d,causal", KERNEL_CASES)
def test_attention_matches_jax_at_head_dims_80_and_128(b, sq, sk, h, d,
                                                       causal):
    """The port's multi_head_attention (the kernels' plain versions on CPU
    tensors) against the JAX package's, whose Pallas kernels run in
    interpret mode, with a hole mask: forward and the gradients of q, k
    and v, fp32, atol 1e-5."""
    q, k, v, _ = _inputs(b, sq, sk, h, d, seed=sq + sk + d)
    mask = _hole_mask(b, sk, seed=d)

    def jloss(q, k, v):
        return _weighted_sum(jatt.multi_head_attention(
            q, k, v, kv_mask=jnp.asarray(mask), causal=causal,
            use_pallas=True, interpret=True), jnp.cos)

    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_out = jatt.multi_head_attention(jq, jk, jv,
                                         kv_mask=jnp.asarray(mask),
                                         causal=causal, use_pallas=True,
                                         interpret=True)
    want = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = att.multi_head_attention(tq, tk, tv,
                                   kv_mask=torch.from_numpy(mask),
                                   causal=causal)
    assert out.grad_fn is not None
    _close(out.detach(), want_out)
    got = torch.autograd.grad(_weighted_sum(out), (tq, tk, tv))
    for g, w in zip(got, want):
        _close(g, w)


# the tiny OPT row widened: (hidden, layers, heads, ffn, word_embed_proj)
WIDE = {80: (160, 2, 2, 320, None), 128: (256, 2, 2, 512, None)}
MODEL_CASES = {"opt": ("opt-tiny", "text_only", ()),
               "mpt": ("mpt-tiny", "all", ("--peft_type", "flamingo"))}


@pytest.mark.parametrize("head_dim", [80, 128])
@pytest.mark.parametrize("family", list(MODEL_CASES))
def test_models_match_jax_at_head_dims_80_and_128(monkeypatch, family,
                                                  head_dim):
    """A 2-layer OPT (embedding mode, text_only) and MPT (flamingo, all,
    the gates seeded non-zero) with 2 heads of 80 and of 128, on the same
    weights in both packages: labels exact, logits atol 1e-4, every
    trainable gradient atol 1e-4 of its largest entry plus 1e-7 (the
    tolerance of tests/test_torch_embedding.py)."""
    for module in (jfactory, factory):
        monkeypatch.setattr(module, "_OPT_SIZES", {
            **module._OPT_SIZES, "tiny": WIDE[head_dim]})
    model_name, context, flags = MODEL_CASES[family]
    args = _args(model_name, context, "none", *flags)
    batch = _batches(args, 1)[0]
    jmodel, params, model = shape_pair(args, batch)
    params = perturb(params)
    model.load_state_dict(convert.state_dict_from_jax(params))
    dims = []
    orig = opt.multi_head_attention
    monkeypatch.setattr(opt, "multi_head_attention", lambda q, *a, **kw: (
        dims.append(q.shape[-1]), orig(q, *a, **kw))[1])
    checked = check_forward_and_grads(args, batch, jmodel, params, model)
    # every LM attention, the cross layers' too, at the head dim
    assert dims and set(dims) == {head_dim}
    assert any("self_attn.q_proj" in n for n in checked)
    if family == "mpt":
        assert any("neighbor_layers" in n for n in checked)
