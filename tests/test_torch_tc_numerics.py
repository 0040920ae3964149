"""The arithmetic of the bf16 tensor-core attention bodies, emulated in torch
on the CPU and held against the JAX package.

The bodies (mmgl_tpu_torch/csrc/attention_fwd_tc.cuh for K1/K2/K4, K7 and
the stats passes of K3/K5 and K8/K9; the dK/dV and dQ bodies of
attention_bwd_tiles.cuh for K3/K5/K6 and K8/K9) run only on a card. This
file repeats their arithmetic order in torch:
  * 64 x 64 tiles; products of bf16 values accumulated in fp32 (mma.sync);
  * the forward's online softmax: a running row max, the sum rescaled by
    exp(m_old - m_new), p rounded to bf16 before P V, out = O / l;
  * the backward from the rows' max m and sum l: p = exp(logit - m) * (1 / l),
    dS = p (dP - delta) scale and 0 at masked logits, P and dS rounded to bf16
    before their products;
  * the skip rules: the forward ends past the causal diagonal once every row
    of the block has seen a real logit; dQ stops at the diagonal and skips a
    tile whose keys are all masked; dK/dV visits a query tile wholly before
    its keys, or any tile if its keys are all masked, only where a row of it
    is fully masked (m == -1e30);
  * the bias form (K7, K8/K9): the bias added to every logit; dropout's keep
    factor on P after the softmax sums, P times the factor rounded to bf16
    before P V and dV; dlogits = P (factor dP - delta) in fp32, dbias its
    sum over the batch before any rounding, dS = dlogits scale rounded to
    bf16; the backward from the forward's row max and sum.
The card takes exp as 2^x of the logits in log2 units on its ex2 unit, a
few ulp from torch.exp, far inside bf16's rounding; the emulation uses
torch.exp.
The emulation is held in bf16, with chip_smoke.py's tolerances (atol = rtol =
2e-2; a gradient's atol is 2e-2 of its largest entry), against the Pallas
forward with with_lse and the Pallas backwards in interpret mode, and against
xla_attention and its jax.grad where a sample is fully masked (the port
follows xla_attention there on purpose; the Pallas kernels drop such rows).
The bias form is held against the Pallas flash_attention_bias and its
jax.grad (dq, dk, dv, dbias) in interpret mode without dropout, and with
dropout 0.1 against the port's plain versions under the same Philox key
(the TPU's hardware bits cannot be reproduced; the keep fraction is what
compares with the JAX package, tests/test_torch_attention.py).
Without the bf16 roundings the emulation is the port's plain versions, to
1e-5. Shapes are small (H <= 2, S <= 333): each case runs in seconds.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mmgl_tpu.ops.flash_attention as jfa
from mmgl_tpu.ops.attention import xla_attention
from mmgl_tpu_torch.ops import attention as att
from mmgl_tpu_torch.ops import flash_attention as fa

TILE = 64
NEG_INF = -1e30
D = 64
TOL = 2e-2      # chip_smoke.py's bf16 forward (atol, rtol) and backward

# (B, Sq, Sk, H), causal, key mask
CASES = [
    ((2, 197, 197, 2), False, "ones"),             # CLIP's patches
    ((2, 333, 333, 2), True, "hole"),               # prompt + summary, ragged
    ((2, 200, 328, 2), True, "hole"),               # end-aligned sq < sk
    ((2, 197, 197, 2), True, "fully_masked"),       # sample 0 all masked
]
IDS = ["197-noncausal", "333-causal-hole", "200x328-aligned", "fully-masked"]


def _inputs(dims, mask_kind, seed):
    """q, k, v, dO as fp32 tensors holding bf16 values, and the (B, Sk) int32
    key mask: "hole" pads a prompt of 4/5 Sk and the rest in the middle and
    at the end; "fully_masked" has sample 0 all masked and the first 70 keys
    of sample 1, so its first causal rows see no real logit."""
    b, sq, sk, h = dims
    rng = np.random.RandomState(seed)
    q, dout = (rng.randn(b, sq, h, D).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, sk, h, D).astype(np.float32) for _ in range(2))
    mask = np.ones((b, sk), np.int32)
    if mask_kind == "hole":
        cut = sk * 4 // 5
        for i in range(b):
            mask[i, rng.randint(cut // 5, cut):cut] = 0
            mask[i, cut + rng.randint(1, sk - cut):] = 0
    elif mask_kind == "fully_masked":
        mask[0] = 0
        mask[1, :70] = 0
    tensors = [torch.from_numpy(t).to(torch.bfloat16).float()
               for t in (q, k, v, dout)]
    return tensors, torch.from_numpy(mask)


def _round(x, on):
    return x.to(torch.bfloat16).float() if on else x


def _allowed(rows, cols, mask, shift, causal):
    """(B, 1, rows, cols) bool: the logits that are not masked."""
    ok = mask.bool()[:, None, None, cols]
    if causal:
        ok = ok & (rows[:, None] + shift >= cols[None, :])
    return ok


def emulate_forward(q, k, v, mask, causal, scale, bf16=True, seen=None,
                    bias=None, keep=None):
    """The forward body: (out, m, l), out (B, Sq, H, D), the stats (B, H,
    Sq). ``seen["early_exit"]`` counts (block, head, batch) loops that ended
    at a causally hidden tile. The bias form: ``bias`` (H, Sq, Sk) fp32,
    ``keep`` the (B, H, Sq, Sk) keep factor (1 / keep or 0)."""
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    out = torch.zeros(b, h, sq, D)
    m_all = torch.zeros(b, h, sq)
    l_all = torch.zeros(b, h, sq)
    shift = sk - sq
    n_tiles = math.ceil(sk / TILE)
    for q0 in range(0, sq, TILE):
        rows = torch.arange(q0, min(q0 + TILE, sq))
        qt = qh[:, :, q0:q0 + TILE]
        m = torch.full((b, h, len(rows)), -math.inf)
        l = torch.zeros(b, h, len(rows))
        o = torch.zeros(b, h, len(rows), D)
        n_vis = (min(n_tiles, (int(rows[-1]) + shift) // TILE + 1) if causal
                 else n_tiles)
        active = torch.ones(b, h, 1, dtype=torch.bool)
        for t in range(n_tiles):
            if t >= n_vis:
                # per block: stop once every row has seen a real logit
                done = (m > NEG_INF).all(-1, keepdim=True)
                if seen is not None:
                    seen["early_exit"] += int((active & done).sum())
                active = active & ~done
                if not bool(active.any()):
                    break
            cols = torch.arange(t * TILE, min((t + 1) * TILE, sk))
            s = (qt @ kh[:, :, cols].transpose(-1, -2)) * scale
            if bias is not None:
                s = s + _tile(bias[None], rows, cols)
            x = torch.where(_allowed(rows, cols, mask, shift, causal), s,
                            torch.tensor(NEG_INF))
            m_new = torch.maximum(m, x.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(x - m_new[..., None])
            l_new = l * alpha + p.sum(-1)
            if keep is not None:
                p = p * _tile(keep, rows, cols)
            o_new = o * alpha[..., None] + _round(p, bf16) @ vh[:, :, cols]
            m = torch.where(active, m_new, m)
            l = torch.where(active, l_new, l)
            o = torch.where(active[..., None], o_new, o)
        out[:, :, q0:q0 + TILE] = _round(o / l[..., None], bf16)
        m_all[:, :, q0:q0 + TILE] = m
        l_all[:, :, q0:q0 + TILE] = l
    return out.permute(0, 2, 1, 3), m_all, l_all


def _tile(x, rows, cols):
    """x[..., rows, cols] of a (..., Sq, Sk) tensor, rows and cols
    consecutive."""
    r0, c0 = int(rows[0]), int(cols[0])
    return x[..., r0:r0 + len(rows), c0:c0 + len(cols)]


def emulate_backward(q, k, v, mask, out, dout, m, l, causal, scale,
                     bf16=True, seen=None, bias=None, keep=None):
    """The dK/dV and dQ bodies from the rows' max and sum: (dq, dk, dv),
    and dbias (H, Sq, Sk) in the bias form (``bias`` and ``keep`` as
    ``emulate_forward`` takes them), summed over the batch from the fp32
    dlogits the dQ body writes. ``seen["hidden_tiles"]`` counts the query
    tiles wholly before a key tile that dK/dV visited (for a fully masked
    row)."""
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    qh, kh, vh, oh, doh = (t.permute(0, 2, 1, 3)
                           for t in (q, k, v, out, dout))
    delta = (doh * oh).sum(-1)
    inv_l = 1.0 / l
    dq = torch.zeros(b, h, sq, D)
    dk = torch.zeros(b, h, sk, D)
    dv = torch.zeros(b, h, sk, D)
    shift = sk - sq

    def tile(rows, cols):
        """P (times the keep factor), dS and the fp32 dlogits of the rows x
        cols tile."""
        s = qh[:, :, rows] @ kh[:, :, cols].transpose(-1, -2)
        dp = doh[:, :, rows] @ vh[:, :, cols].transpose(-1, -2)
        ok = _allowed(rows, cols, mask, shift, causal)
        s = s * scale
        if bias is not None:
            s = s + _tile(bias[None], rows, cols)
        logit = torch.where(ok, s, torch.tensor(NEG_INF))
        p = torch.exp(logit - m[:, :, rows, None]) * inv_l[:, :, rows, None]
        factor = 1.0 if keep is None else _tile(keep, rows, cols)
        dl = torch.where(ok, p * (factor * dp - delta[:, :, rows, None]),
                         torch.tensor(0.0))
        return _round(p * factor, bf16), _round(dl * scale, bf16), dl

    for k0 in range(0, sk, TILE):
        cols = torch.arange(k0, min(k0 + TILE, sk))
        t_first = max(0, k0 - shift) // TILE if causal else 0
        # per sample: the tile's keys are all masked
        no_keys = ~mask.bool()[:, cols].any(-1)[:, None, None, None]
        for q0 in range(0, sq, TILE):
            rows = torch.arange(q0, min(q0 + TILE, sq))
            full = (m[:, :, rows] == NEG_INF).any(-1)[..., None, None]
            visit = full | ~no_keys
            if q0 // TILE < t_first:
                visit = full
                if seen is not None:
                    seen["hidden_tiles"] += int(visit.sum())
            p, ds, _ = tile(rows, cols)
            dv[:, :, cols] += torch.where(
                visit, p.transpose(-1, -2) @ doh[:, :, rows], 0.0)
            dk[:, :, cols] += torch.where(
                visit, ds.transpose(-1, -2) @ qh[:, :, rows], 0.0)
    n_k = math.ceil(sk / TILE)
    # the dQ body's dlogits, zero on the tiles it skips
    dlogits = torch.zeros(b, h, sq, sk)
    for q0 in range(0, sq, TILE):
        rows = torch.arange(q0, min(q0 + TILE, sq))
        n_tiles = (min(n_k, (int(rows[-1]) + shift) // TILE + 1) if causal
                   else n_k)
        for t in range(n_tiles):
            cols = torch.arange(t * TILE, min((t + 1) * TILE, sk))
            _, ds, dl = tile(rows, cols)
            keys = mask.bool()[:, cols].any(-1)[:, None, None, None]
            dq[:, :, rows] += torch.where(keys, ds @ kh[:, :, cols], 0.0)
            _tile(dlogits, rows, cols)[:] = torch.where(keys, dl, 0.0)
    grads = tuple(_round(g, bf16).permute(0, 2, 1, 3) for g in (dq, dk, dv))
    if bias is None:
        return grads
    return grads + (_round(dlogits.sum(0), bf16),)


def _heads_first(x, dtype=jnp.bfloat16):
    """BSHD torch -> the Pallas kernels' (B*H, S, D) JAX array."""
    b, s, h, d = x.shape
    x = x.permute(0, 2, 1, 3).reshape(b * h, s, d).numpy()
    return jnp.asarray(x).astype(dtype)


def _seq_first(x, b, h):
    """(B*H, S, D) JAX -> BSHD fp32 torch."""
    x = np.array(jnp.asarray(x).astype(jnp.float32))
    return torch.from_numpy(x.reshape(b, h, x.shape[1], x.shape[2])
                            ).permute(0, 2, 1, 3)


def _close(got, want, atol, rtol, what):
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol, msg=what)


def _close_grad(got, want, what):
    _close(got, want, TOL * float(want.abs().max()), TOL, what)


def _jax_reference(dims, causal, mask_kind, q, k, v, dout, mask, scale):
    """(out, lse or None, (dq, dk, dv)) of the JAX package for these inputs:
    the Pallas forward with with_lse and the Pallas backward (blocked where
    causal, dense otherwise) in bf16 in interpret mode; for a fully masked
    sample xla_attention and its jax.grad, in fp32 on the same bf16 values."""
    b, _, _, h = dims
    if mask_kind == "fully_masked":
        jq, jk, jv, jdo = (jnp.asarray(t.numpy()) for t in (q, k, v, dout))
        jmask = jnp.asarray(mask.numpy())

        def f(q_, k_, v_):
            return xla_attention(q_, k_, v_, kv_mask=jmask, causal=causal,
                                 scale=scale)

        out, vjp = jax.vjp(f, jq, jk, jv)
        grads = vjp(jdo)
        return (torch.from_numpy(np.array(out)), None,
                tuple(torch.from_numpy(np.array(g)) for g in grads))
    qf, kf, vf, dof = (_heads_first(t) for t in (q, k, v, dout))
    maskf = jnp.repeat(jnp.asarray(mask.numpy()), h, axis=0)
    out, lse = jfa._fwd(qf, kf, vf, maskf, scale, causal, True,
                        with_lse=True)
    if causal:
        grads = jfa._bwd_causal_blocked(qf, kf, vf, maskf, scale, True, out,
                                        dof, lse)
    else:
        grads = jfa._bwd(qf, kf, vf, maskf, scale, False, True, out, dof)
    lse = torch.from_numpy(np.array(lse)).reshape(b, h, -1)
    return (_seq_first(out, b, h), lse,
            tuple(_seq_first(g, b, h) for g in grads))


@pytest.mark.parametrize("dims,causal,mask_kind", CASES, ids=IDS)
def test_tensor_core_forward_arithmetic_matches_jax(dims, causal, mask_kind):
    """The forward body's arithmetic in bf16 against the Pallas forward
    (out, and m + log l against its LSE) or, with a fully masked sample,
    against xla_attention: atol = rtol = 2e-2."""
    (q, k, v, dout), mask = _inputs(dims, mask_kind, seed=sum(dims))
    scale = D ** -0.5
    seen = {"early_exit": 0}
    out, m, l = emulate_forward(q, k, v, mask, causal, scale, seen=seen)
    want_out, want_lse, _ = _jax_reference(dims, causal, mask_kind, q, k, v,
                                           dout, mask, scale)
    _close(out, want_out, TOL, TOL, "out")
    if want_lse is not None:
        _close(m + torch.log(l), want_lse, TOL, TOL, "m + log l")
    if mask_kind == "fully_masked":
        # sample 0 averages v over every key; its rows never end early
        _close(out[0], v[0].mean(0, keepdim=True).expand_as(out[0]), TOL,
               TOL, "fully masked rows")
        assert float(m[0].max()) == np.float32(NEG_INF)
        assert torch.equal(l[0], torch.full_like(l[0], dims[2]))
    if causal:
        assert seen["early_exit"] > 0     # the diagonal's early exit ran


@pytest.mark.parametrize("dims,causal,mask_kind", CASES, ids=IDS)
def test_tensor_core_backward_arithmetic_matches_jax(dims, causal, mask_kind):
    """The dK/dV and dQ bodies' arithmetic in bf16, from the emulated
    forward's out, m and l, against the Pallas blocked backward (causal) or
    dense backward, or, with a fully masked sample, jax.grad through
    xla_attention: per gradient atol = 2e-2 of its largest entry, rtol
    2e-2."""
    (q, k, v, dout), mask = _inputs(dims, mask_kind, seed=sum(dims) + 1)
    scale = D ** -0.5
    out, m, l = emulate_forward(q, k, v, mask, causal, scale)
    seen = {"hidden_tiles": 0}
    got = emulate_backward(q, k, v, mask, out, dout, m, l, causal, scale,
                           seen=seen)
    _, _, want = _jax_reference(dims, causal, mask_kind, q, k, v, dout, mask,
                                scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close_grad(g, w, name)
    if mask_kind == "fully_masked":
        # the fully masked rows feed dV from keys past their diagonal, and
        # nothing else: no dQ, and no dK from sample 0
        assert seen["hidden_tiles"] > 0
        assert float(got[0][0].abs().max()) == 0.0
        assert float(got[1][0].abs().max()) == 0.0
        assert float(got[2][0, -1].abs().max()) > 0.0


@pytest.mark.parametrize("dims,causal,mask_kind", CASES, ids=IDS)
def test_emulation_without_rounding_is_the_plain_math(dims, causal,
                                                      mask_kind):
    """Without the bf16 roundings, in fp32, the emulation is the port's plain
    versions (K4 with its stats, K6): atol 1e-5. So the emulation computes
    the kernels' function, and the bf16 checks above measure its roundings
    and order."""
    (q, k, v, dout), mask = _inputs(dims, mask_kind, seed=sum(dims) + 2)
    scale = D ** -0.5
    out, m, l = emulate_forward(q, k, v, mask, causal, scale, bf16=False)
    want_out, want_m, want_l = fa.flash_attention_reference(
        q, k, v, kv_mask=mask, causal=causal, scale=scale, with_stats=True)
    _close(out, want_out, 1e-5, 0, "out")
    _close(m, want_m, 1e-5, 0, "m")
    _close(l, want_l, 1e-5, 1e-5, "l")
    got = emulate_backward(q, k, v, mask, out, dout, m, l, causal, scale,
                           bf16=False)
    want = fa.flash_attention_blocked_bwd_reference(
        q, k, v, mask, out, dout, m, l, causal=causal, scale=scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g, w, 1e-5, 0, name)


# K7 and K8/K9: (B, Sq, Sk, H), causal, key mask, with T5's bf16 bias
BIAS_CASES = [
    ((2, 197, 197, 2), False, "hole"),
    ((2, 200, 328, 2), True, "hole"),
]
BIAS_IDS = ["197-bias", "200x328-aligned-bias"]
# with dropout, against the plain versions: also a fully masked sample
DROP_CASES = BIAS_CASES + [((2, 197, 197, 2), True, "fully_masked")]
DROP_IDS = BIAS_IDS + ["fully-masked-bias"]
RATE = 0.1


def _bias_inputs(dims, mask_kind, seed):
    """_inputs' tensors and mask, and an (H, Sq, Sk) bias of bf16 values in
    fp32."""
    tensors, mask = _inputs(dims, mask_kind, seed)
    _, sq, sk, h = dims
    rng = np.random.RandomState(seed + 1)
    bias = torch.from_numpy(rng.randn(h, sq, sk).astype(np.float32))
    return tensors, mask, bias.to(torch.bfloat16).float()


def _keep(dims, seed):
    """The (B, H, Sq, Sk) keep factor of the kernels' Philox bits, and the
    key."""
    b, sq, sk, h = dims
    key = torch.tensor([seed * 7919 + 1, 2 ** 32 - seed], dtype=torch.int64)
    return att.dropout_keep_factor(key, (b, h, sq, sk), RATE), key


def _jax_bias_reference(causal, q, k, v, dout, mask, bias, scale):
    """(out, (dq, dk, dv, dbias)) of the Pallas flash_attention_bias in bf16
    in interpret mode and its jax.grad, as fp32 torch tensors; dbias (H,
    Sq, Sk)."""
    jq, jk, jv, jdo = (jnp.asarray(t.numpy()).astype(jnp.bfloat16)
                       for t in (q, k, v, dout))
    jb = jnp.asarray(bias.numpy())[None].astype(jnp.bfloat16)
    jmask = jnp.asarray(mask.numpy())

    def f(q_, k_, v_, b_):
        return jfa.flash_attention_bias(q_, k_, v_, bias=b_, kv_mask=jmask,
                                        causal=causal, scale=scale,
                                        interpret=True)

    out, vjp = jax.vjp(f, jq, jk, jv, jb)
    grads = vjp(jdo)

    def to_torch(x):
        return torch.from_numpy(np.array(jnp.asarray(x).astype(jnp.float32)))

    return to_torch(out), tuple(to_torch(g) for g in grads[:3]) + (
        to_torch(grads[3])[0],)


@pytest.mark.parametrize("dims,causal,mask_kind", BIAS_CASES, ids=BIAS_IDS)
def test_bias_forward_arithmetic_matches_jax(dims, causal, mask_kind):
    """K7's body (the forward body with the bias on S) in bf16 against the
    Pallas flash_attention_bias in interpret mode: atol = rtol = 2e-2."""
    (q, k, v, dout), mask, bias = _bias_inputs(dims, mask_kind,
                                               seed=sum(dims) + 3)
    scale = D ** -0.5
    out, _, _ = emulate_forward(q, k, v, mask, causal, scale, bias=bias)
    want, _ = _jax_bias_reference(causal, q, k, v, dout, mask, bias, scale)
    _close(out, want, TOL, TOL, "out")


@pytest.mark.parametrize("dims,causal,mask_kind", BIAS_CASES, ids=BIAS_IDS)
def test_bias_backward_arithmetic_matches_jax(dims, causal, mask_kind):
    """K8/K9's bodies in bf16, from the emulated K7's out and row stats,
    against jax.grad through the Pallas flash_attention_bias in interpret
    mode: dq, dk, dv and dbias, each atol = 2e-2 of its largest entry, rtol
    2e-2."""
    (q, k, v, dout), mask, bias = _bias_inputs(dims, mask_kind,
                                               seed=sum(dims) + 4)
    scale = D ** -0.5
    out, m, l = emulate_forward(q, k, v, mask, causal, scale, bias=bias)
    got = emulate_backward(q, k, v, mask, out, dout, m, l, causal, scale,
                           bias=bias)
    _, want = _jax_bias_reference(causal, q, k, v, dout, mask, bias, scale)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        _close_grad(g, w, name)


def _bf16(*tensors):
    return [t.to(torch.bfloat16) for t in tensors]


@pytest.mark.parametrize("dims,causal,mask_kind", DROP_CASES, ids=DROP_IDS)
def test_bias_dropout_arithmetic_matches_the_plain_versions(dims, causal,
                                                            mask_kind):
    """K7 and K8/K9's bodies with dropout 0.1 in bf16 against the port's
    plain versions in bf16 under the same Philox key (which round P times
    the keep factor and dS to bf16 before their products, as the Pallas
    kernels do): the chip check's tolerances."""
    (q, k, v, dout), mask, bias = _bias_inputs(dims, mask_kind,
                                               seed=sum(dims) + 5)
    keep, key = _keep(dims, seed=sum(dims))
    scale = D ** -0.5
    out, m, l = emulate_forward(q, k, v, mask, causal, scale, bias=bias,
                                keep=keep)
    got = emulate_backward(q, k, v, mask, out, dout, m, l, causal, scale,
                           bias=bias, keep=keep)
    bq, bk, bv, bdo, bb = _bf16(q, k, v, dout, bias[None])
    kw = dict(causal=causal, scale=scale, dropout_rate=RATE,
              dropout_seed=key)
    want_out = fa.bias_attention_reference(bq, bk, bv, bias=bb, kv_mask=mask,
                                           **kw)
    _close(out, want_out, TOL, TOL, "out")
    want = fa.bias_attention_bwd_reference(bq, bk, bv, mask, bb,
                                           want_out, bdo, **kw)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got,
                          want[:3] + (want[3][0],)):
        _close_grad(g, w, name)


@pytest.mark.parametrize("dims,causal,mask_kind", DROP_CASES, ids=DROP_IDS)
def test_bias_emulation_without_rounding_is_the_plain_math(dims, causal,
                                                           mask_kind):
    """Without the bf16 roundings, in fp32 with dropout 0.1, the bias form
    of the emulation is the port's plain versions (K7 with its row stats,
    K8/K9 with dbias): atol 1e-5."""
    (q, k, v, dout), mask, bias = _bias_inputs(dims, mask_kind,
                                               seed=sum(dims) + 6)
    keep, key = _keep(dims, seed=sum(dims) + 1)
    scale = D ** -0.5
    out, m, l = emulate_forward(q, k, v, mask, causal, scale, bf16=False,
                                bias=bias, keep=keep)
    kw = dict(causal=causal, scale=scale, dropout_rate=RATE,
              dropout_seed=key)
    want_out, want_m, want_l = fa.bias_attention_reference(
        q, k, v, bias=bias[None], kv_mask=mask, with_stats=True, **kw)
    _close(out, want_out, 1e-5, 0, "out")
    _close(m, want_m, 1e-5, 0, "m")
    _close(l, want_l, 1e-5, 1e-5, "l")
    got = emulate_backward(q, k, v, mask, out, dout, m, l, causal, scale,
                           bf16=False, bias=bias, keep=keep)
    want = fa.bias_attention_bwd_reference(q, k, v, mask, bias[None], out,
                                           dout, **kw)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got,
                          want[:3] + (want[3][0],)):
        _close(g, w, 1e-5, 0, name)
