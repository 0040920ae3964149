"""The arithmetic of the tensor-core attention bodies (bf16 and fp16),
emulated in torch on the CPU and held against the JAX package.

The bodies (mmgl_tpu_torch/csrc/attention_fwd_tc.cuh for K2; the dK/dV
and dQ bodies of attention_bwd_tiles.cuh for K5/K6 and K8/K9; the wgmma
bodies of allheads_wgmma.cuh for K1, K3, K4, K7 and the stats passes of K5
and K8/K9) run only on a card. This file repeats their arithmetic order in
torch:
  * 64 x 64 tiles (mma.sync, and the wgmma bodies' library shapes), or the
    wgmma bodies' other widths (WGMMA_TILES, K7_TILES);
    products of bf16 (or fp16) values accumulated in fp32;
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

The fp16 form rounds to float16 where the bf16 form rounds to bfloat16 (the
bodies' second element type: the same instructions, m16n8k16 in .f16): the
same comparisons, with the Pallas kernels in float16, at atol = rtol = 5e-3
(fp16 keeps 11 significant bits to bf16's 8; the masks stay -1e30 in fp32,
which fp16 cannot hold).
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
from test_torch_regularization import _one_thread  # noqa: F401

TILE = 64
NEG_INF = -1e30
D = 64
TOL = 2e-2      # chip_smoke.py's bf16 forward (atol, rtol) and backward
FP16_TOL = 5e-3  # its fp16 ones

# the tile widths of K1's and K3's wgmma bodies (csrc/allheads_wgmma.cuh):
# (rows a block, rows a streamed tile): the forward's and dQ's (query rows,
# keys), dK/dV's (keys, query rows); 64 rows a consumer warpgroup, one or
# two a block, tiles of 64 or 128
WGMMA_TILES = [(64, 128), (128, 64)]
WGMMA_TILE_IDS = ["64x128", "128x64"]

# (B, Sq, Sk, H), causal, key mask
CASES = [
    ((2, 197, 197, 2), False, "ones"),             # CLIP's patches
    ((2, 333, 333, 2), True, "hole"),               # prompt + summary, ragged
    ((2, 200, 328, 2), True, "hole"),               # end-aligned sq < sk
    ((2, 197, 197, 2), True, "fully_masked"),       # sample 0 all masked
]
IDS = ["197-noncausal", "333-causal-hole", "200x328-aligned", "fully-masked"]


def _inputs(dims, mask_kind, seed, dtype=torch.bfloat16, d=D):
    """q, k, v, dO as fp32 tensors holding ``dtype`` values, head dim d, and
    the (B, Sk) int32 key mask: "hole" pads a prompt of 4/5 Sk and the rest
    in the middle and at the end; "fully_masked" has sample 0 all masked
    and the first 70 keys of sample 1, so its first causal rows see no real
    logit; "hole_fully_masked" has sample 0's hole and sample 1 all
    masked."""
    b, sq, sk, h = dims
    rng = np.random.RandomState(seed)
    q, dout = (rng.randn(b, sq, h, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, sk, h, d).astype(np.float32) for _ in range(2))
    mask = np.ones((b, sk), np.int32)
    if mask_kind in ("hole", "hole_fully_masked"):
        cut = sk * 4 // 5
        for i in range(b):
            mask[i, rng.randint(cut // 5, cut):cut] = 0
            mask[i, cut + rng.randint(1, sk - cut):] = 0
        if mask_kind == "hole_fully_masked":
            mask[1] = 0
    elif mask_kind == "fully_masked":
        mask[0] = 0
        mask[1, :70] = 0
    tensors = [torch.from_numpy(t).to(dtype).float()
               for t in (q, k, v, dout)]
    return tensors, torch.from_numpy(mask)


def _round(x, dtype):
    """x rounded to ``dtype`` (a body's element type), or x for None."""
    return x.to(dtype).float() if dtype is not None else x


def _allowed(rows, cols, mask, shift, causal):
    """(B, 1, rows, cols) bool: the logits that are not masked."""
    ok = mask.bool()[:, None, None, cols]
    if causal:
        ok = ok & (rows[:, None] + shift >= cols[None, :])
    return ok


def emulate_forward(q, k, v, mask, causal, scale, dtype=torch.bfloat16,
                    seen=None, bias=None, keep=None, tiles=(TILE, TILE)):
    """The forward body in element type ``dtype`` (None: no rounding):
    (out, m, l), out (B, Sq, H, D), the stats (B, H, Sq). ``tiles``: the
    body's (query rows a block, keys a tile), (64, 64) for the mma.sync
    body, (64 NC, KT) for K1's wgmma body. ``seen["early_exit"]`` counts
    (block, head, batch) loops that ended at a causally hidden tile. The
    bias form: ``bias`` (H, Sq, Sk) fp32, ``keep`` the (B, H, Sq, Sk) keep
    factor (1 / keep or 0)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    out = torch.zeros(b, h, sq, d)
    m_all = torch.zeros(b, h, sq)
    l_all = torch.zeros(b, h, sq)
    shift = sk - sq
    q_tile, k_tile = tiles
    n_tiles = math.ceil(sk / k_tile)
    for q0 in range(0, sq, q_tile):
        rows = torch.arange(q0, min(q0 + q_tile, sq))
        qt = qh[:, :, q0:q0 + q_tile]
        m = torch.full((b, h, len(rows)), -math.inf)
        l = torch.zeros(b, h, len(rows))
        o = torch.zeros(b, h, len(rows), d)
        n_vis = (min(n_tiles, (int(rows[-1]) + shift) // k_tile + 1)
                 if causal else n_tiles)
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
            cols = torch.arange(t * k_tile, min((t + 1) * k_tile, sk))
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
            o_new = o * alpha[..., None] + _round(p, dtype) @ vh[:, :, cols]
            m = torch.where(active, m_new, m)
            l = torch.where(active, l_new, l)
            o = torch.where(active[..., None], o_new, o)
        out[:, :, q0:q0 + q_tile] = _round(o / l[..., None], dtype)
        m_all[:, :, q0:q0 + q_tile] = m
        l_all[:, :, q0:q0 + q_tile] = l
    return out.permute(0, 2, 1, 3), m_all, l_all


def _tile(x, rows, cols):
    """x[..., rows, cols] of a (..., Sq, Sk) tensor, rows and cols
    consecutive."""
    r0, c0 = int(rows[0]), int(cols[0])
    return x[..., r0:r0 + len(rows), c0:c0 + len(cols)]


def emulate_backward(q, k, v, mask, out, dout, m, l, causal, scale,
                     dtype=torch.bfloat16, seen=None, bias=None, keep=None,
                     dkdv_tiles=(TILE, TILE), dq_tiles=(TILE, TILE)):
    """The dK/dV and dQ bodies from the rows' max and sum: (dq, dk, dv),
    and dbias (H, Sq, Sk) in the bias form (``bias`` and ``keep`` as
    ``emulate_forward`` takes them), summed over the batch from the fp32
    dlogits the dQ body writes. ``dkdv_tiles``: dK/dV's (keys a block,
    query rows a tile); ``dq_tiles``: dQ's (query rows a block, keys a
    tile); (64, 64) each for the mma.sync bodies. ``seen["hidden_tiles"]``
    counts the query tiles wholly before a key block that dK/dV visited
    (for a fully masked row)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qh, kh, vh, oh, doh = (t.permute(0, 2, 1, 3)
                           for t in (q, k, v, out, dout))
    delta = (doh * oh).sum(-1)
    inv_l = 1.0 / l
    dq = torch.zeros(b, h, sq, d)
    dk = torch.zeros(b, h, sk, d)
    dv = torch.zeros(b, h, sk, d)
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
        return _round(p * factor, dtype), _round(dl * scale, dtype), dl

    kv_rows, q_tile = dkdv_tiles
    for k0 in range(0, sk, kv_rows):
        cols = torch.arange(k0, min(k0 + kv_rows, sk))
        t_first = max(0, k0 - shift) // q_tile if causal else 0
        # per sample: the block's keys are all masked
        no_keys = ~mask.bool()[:, cols].any(-1)[:, None, None, None]
        for q0 in range(0, sq, q_tile):
            rows = torch.arange(q0, min(q0 + q_tile, sq))
            full = (m[:, :, rows] == NEG_INF).any(-1)[..., None, None]
            visit = full | ~no_keys
            if q0 // q_tile < t_first:
                visit = full
                if seen is not None:
                    seen["hidden_tiles"] += int(visit.sum())
            p, ds, _ = tile(rows, cols)
            dv[:, :, cols] += torch.where(
                visit, p.transpose(-1, -2) @ doh[:, :, rows], 0.0)
            dk[:, :, cols] += torch.where(
                visit, ds.transpose(-1, -2) @ qh[:, :, rows], 0.0)
    q_rows, k_tile = dq_tiles
    n_k = math.ceil(sk / k_tile)
    # the dQ body's dlogits, zero on the tiles it skips
    dlogits = torch.zeros(b, h, sq, sk)
    for q0 in range(0, sq, q_rows):
        rows = torch.arange(q0, min(q0 + q_rows, sq))
        n_tiles = (min(n_k, (int(rows[-1]) + shift) // k_tile + 1)
                   if causal else n_k)
        for t in range(n_tiles):
            cols = torch.arange(t * k_tile, min((t + 1) * k_tile, sk))
            _, ds, dl = tile(rows, cols)
            keys = mask.bool()[:, cols].any(-1)[:, None, None, None]
            dq[:, :, rows] += torch.where(keys, ds @ kh[:, :, cols], 0.0)
            _tile(dlogits, rows, cols)[:] = torch.where(keys, dl, 0.0)
    grads = tuple(_round(g, dtype).permute(0, 2, 1, 3) for g in (dq, dk, dv))
    if bias is None:
        return grads
    return grads + (_round(dlogits.sum(0), dtype),)


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


def _close_grad(got, want, what, tol=TOL):
    _close(got, want, tol * float(want.abs().max()), tol, what)


def _jax_reference(dims, causal, mask_kind, q, k, v, dout, mask, scale,
                   dtype=jnp.bfloat16):
    """(out, lse or None, (dq, dk, dv)) of the JAX package for these inputs:
    the Pallas forward with with_lse and the Pallas backward (blocked where
    causal, dense otherwise) in ``dtype`` in interpret mode; for a fully
    masked sample xla_attention and its jax.grad, in fp32 on the same
    values."""
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
    qf, kf, vf, dof = (_heads_first(t, dtype) for t in (q, k, v, dout))
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


def _check_forward(dims, causal, mask_kind, dtype, tol):
    """The forward body's arithmetic in ``dtype`` against the JAX package's
    forward in the same dtype (``_jax_reference``): out and m + log l."""
    (q, k, v, dout), mask = _inputs(dims, mask_kind, seed=sum(dims),
                                    dtype=dtype)
    scale = D ** -0.5
    seen = {"early_exit": 0}
    out, m, l = emulate_forward(q, k, v, mask, causal, scale, dtype=dtype,
                                seen=seen)
    want_out, want_lse, _ = _jax_reference(
        dims, causal, mask_kind, q, k, v, dout, mask, scale,
        jnp.dtype(str(dtype).split(".")[1]))
    _close(out, want_out, tol, tol, "out")
    if want_lse is not None:
        _close(m + torch.log(l), want_lse, tol, tol, "m + log l")
    if mask_kind == "fully_masked":
        # sample 0 averages v over every key; its rows never end early
        _close(out[0], v[0].mean(0, keepdim=True).expand_as(out[0]), tol,
               tol, "fully masked rows")
        assert float(m[0].max()) == np.float32(NEG_INF)
        assert torch.equal(l[0], torch.full_like(l[0], dims[2]))
    if causal:
        assert seen["early_exit"] > 0     # the diagonal's early exit ran


def _check_backward(dims, causal, mask_kind, dtype, tol):
    """The dK/dV and dQ bodies' arithmetic in ``dtype``, from the emulated
    forward, against the JAX package's backward in the same dtype."""
    (q, k, v, dout), mask = _inputs(dims, mask_kind, seed=sum(dims) + 1,
                                    dtype=dtype)
    scale = D ** -0.5
    out, m, l = emulate_forward(q, k, v, mask, causal, scale, dtype=dtype)
    seen = {"hidden_tiles": 0}
    got = emulate_backward(q, k, v, mask, out, dout, m, l, causal, scale,
                           dtype=dtype, seen=seen)
    _, _, want = _jax_reference(dims, causal, mask_kind, q, k, v, dout, mask,
                                scale, jnp.dtype(str(dtype).split(".")[1]))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close_grad(g, w, name, tol)
    if mask_kind == "fully_masked":
        # the fully masked rows feed dV from keys past their diagonal, and
        # nothing else: no dQ, and no dK from sample 0
        assert seen["hidden_tiles"] > 0
        assert float(got[0][0].abs().max()) == 0.0
        assert float(got[1][0].abs().max()) == 0.0
        assert float(got[2][0, -1].abs().max()) > 0.0


@pytest.mark.parametrize("dims,causal,mask_kind", CASES, ids=IDS)
def test_tensor_core_forward_arithmetic_matches_jax(dims, causal, mask_kind):
    """The forward body's arithmetic in bf16 against the Pallas forward
    (out, and m + log l against its LSE) or, with a fully masked sample,
    against xla_attention: atol = rtol = 2e-2."""
    _check_forward(dims, causal, mask_kind, torch.bfloat16, TOL)


@pytest.mark.parametrize("dims,causal,mask_kind", CASES, ids=IDS)
def test_tensor_core_backward_arithmetic_matches_jax(dims, causal, mask_kind):
    """The dK/dV and dQ bodies' arithmetic in bf16, from the emulated
    forward's out, m and l, against the Pallas blocked backward (causal) or
    dense backward, or, with a fully masked sample, jax.grad through
    xla_attention: per gradient atol = 2e-2 of its largest entry, rtol
    2e-2."""
    _check_backward(dims, causal, mask_kind, torch.bfloat16, TOL)


@pytest.mark.parametrize("dims,causal,mask_kind", CASES, ids=IDS)
def test_fp16_forward_arithmetic_matches_jax(dims, causal, mask_kind):
    """The forward body's fp16 form against the Pallas forward in float16
    in interpret mode (or xla_attention with a fully masked sample): atol =
    rtol = 5e-3."""
    _check_forward(dims, causal, mask_kind, torch.float16, FP16_TOL)


@pytest.mark.parametrize("dims,causal,mask_kind", CASES, ids=IDS)
def test_fp16_backward_arithmetic_matches_jax(dims, causal, mask_kind):
    """The backward bodies' fp16 form (P and dS rounded to float16) against
    the Pallas backwards in float16 in interpret mode (or jax.grad through
    xla_attention): per gradient atol = 5e-3 of its largest entry, rtol
    5e-3."""
    _check_backward(dims, causal, mask_kind, torch.float16, FP16_TOL)


@pytest.mark.parametrize("dims,causal,mask_kind", CASES, ids=IDS)
def test_emulation_without_rounding_is_the_plain_math(dims, causal,
                                                      mask_kind):
    """Without the bf16 roundings, in fp32, the emulation is the port's plain
    versions (K4 with its stats, K6): atol 1e-5. So the emulation computes
    the kernels' function, and the bf16 checks above measure its roundings
    and order."""
    (q, k, v, dout), mask = _inputs(dims, mask_kind, seed=sum(dims) + 2)
    scale = D ** -0.5
    out, m, l = emulate_forward(q, k, v, mask, causal, scale, dtype=None)
    want_out, want_m, want_l = fa.flash_attention_reference(
        q, k, v, kv_mask=mask, causal=causal, scale=scale, with_stats=True)
    _close(out, want_out, 1e-5, 0, "out")
    _close(m, want_m, 1e-5, 0, "m")
    _close(l, want_l, 1e-5, 1e-5, "l")
    got = emulate_backward(q, k, v, mask, out, dout, m, l, causal, scale,
                           dtype=None)
    want = fa.flash_attention_blocked_bwd_reference(
        q, k, v, mask, out, dout, m, l, causal=causal, scale=scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g, w, 1e-5, 0, name)


def test_forward_rounding_grows_with_the_scale_of_v():
    """At q and v six times unit scale (a LoRA adapter with alpha / r = 2
    and B seeded at N(0, 0.5) gives them about that): the emulated bf16
    forward and the plain version in bf16 differ by more than a fixed
    atol = rtol = 2e-2 allows (each rounds the probabilities to bf16 before
    P V, an error that scales with |v|, not with the output), and by no
    more than that tolerance with its atol scaled by max |v|, as
    chip_smoke.py's PlainCheck holds a forward launch."""
    (q, k, v, _), mask = _inputs((2, 640, 640, 4), "hole", seed=6)
    q, v = (_round(t * 6.0, torch.bfloat16) for t in (q, v))
    scale = D ** -0.5
    out, _, _ = emulate_forward(q, k, v, mask, True, scale)
    out = _round(out, torch.bfloat16)
    plain = fa.allheads_attention_reference(
        q.bfloat16(), k.bfloat16(), v.bfloat16(), kv_mask=mask, causal=True,
        scale=scale).float()
    err = (out - plain).abs()
    assert not bool((err <= TOL + TOL * plain.abs()).all())
    v_max = float(v.abs().max())
    assert bool((err <= TOL * max(1.0, v_max) + TOL * plain.abs()).all())


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


def _bias_inputs(dims, mask_kind, seed, dtype=torch.bfloat16):
    """_inputs' tensors and mask, and an (H, Sq, Sk) bias of ``dtype``
    values in fp32."""
    tensors, mask = _inputs(dims, mask_kind, seed, dtype)
    _, sq, sk, h = dims
    rng = np.random.RandomState(seed + 1)
    bias = torch.from_numpy(rng.randn(h, sq, sk).astype(np.float32))
    return tensors, mask, bias.to(dtype).float()


def _keep(dims, seed):
    """The (B, H, Sq, Sk) keep factor of the kernels' Philox bits, and the
    key."""
    b, sq, sk, h = dims
    key = torch.tensor([seed * 7919 + 1, 2 ** 32 - seed], dtype=torch.int64)
    return att.dropout_keep_factor(key, (b, h, sq, sk), RATE), key


def _jax_bias_reference(causal, q, k, v, dout, mask, bias, scale,
                        dtype=jnp.bfloat16):
    """(out, (dq, dk, dv, dbias)) of the Pallas flash_attention_bias in
    ``dtype`` in interpret mode and its jax.grad, as fp32 torch tensors;
    dbias (H, Sq, Sk)."""
    jq, jk, jv, jdo = (jnp.asarray(t.numpy()).astype(dtype)
                       for t in (q, k, v, dout))
    jb = jnp.asarray(bias.numpy())[None].astype(dtype)
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


# the JAX package's results at a (case, seed), shared by the tile widths
_BIAS_REFERENCE = {}


def _jax_bias_cached(dims, causal, mask_kind, seed, *args):
    """``_jax_bias_reference(causal, *args)``, once a (case, seed)."""
    key = (dims, causal, mask_kind, seed)
    if key not in _BIAS_REFERENCE:
        _BIAS_REFERENCE[key] = _jax_bias_reference(causal, *args)
    return _BIAS_REFERENCE[key]


def _check_bias_forward(dims, causal, mask_kind, tiles):
    """K7's body at ``tiles`` (the forward body with the bias on S) in bf16
    against the Pallas flash_attention_bias in interpret mode."""
    seed = sum(dims) + 3
    (q, k, v, dout), mask, bias = _bias_inputs(dims, mask_kind, seed=seed)
    scale = D ** -0.5
    out, _, _ = emulate_forward(q, k, v, mask, causal, scale, bias=bias,
                                tiles=tiles)
    want, _ = _jax_bias_cached(dims, causal, mask_kind, seed, q, k, v, dout,
                               mask, bias, scale)
    _close(out, want, TOL, TOL, "out")


def _check_bias_backward(dims, causal, mask_kind, tiles):
    """K8/K9's bodies (64 x 64 tiles) in bf16, from the emulated K7's out
    and row stats at ``tiles``, against jax.grad through the Pallas
    flash_attention_bias in interpret mode."""
    seed = sum(dims) + 4
    (q, k, v, dout), mask, bias = _bias_inputs(dims, mask_kind, seed=seed)
    scale = D ** -0.5
    out, m, l = emulate_forward(q, k, v, mask, causal, scale, bias=bias,
                                tiles=tiles)
    got = emulate_backward(q, k, v, mask, out, dout, m, l, causal, scale,
                           bias=bias)
    _, want = _jax_bias_cached(dims, causal, mask_kind, seed, q, k, v, dout,
                               mask, bias, scale)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        _close_grad(g, w, name)


@pytest.mark.parametrize("dims,causal,mask_kind", BIAS_CASES, ids=BIAS_IDS)
def test_bias_forward_arithmetic_matches_jax(dims, causal, mask_kind):
    """K7's body (the forward body with the bias on S, 64 x 64 tiles) in
    bf16 against the Pallas flash_attention_bias in interpret mode: atol =
    rtol = 2e-2."""
    _check_bias_forward(dims, causal, mask_kind, (TILE, TILE))


@pytest.mark.parametrize("dims,causal,mask_kind", BIAS_CASES, ids=BIAS_IDS)
def test_bias_backward_arithmetic_matches_jax(dims, causal, mask_kind):
    """K8/K9's bodies in bf16, from the emulated K7's out and row stats,
    against jax.grad through the Pallas flash_attention_bias in interpret
    mode: dq, dk, dv and dbias, each atol = 2e-2 of its largest entry, rtol
    2e-2."""
    _check_bias_backward(dims, causal, mask_kind, (TILE, TILE))


def _bf16(*tensors):
    return [t.to(torch.bfloat16) for t in tensors]


def _check_bias_dropout(dims, causal, mask_kind, tiles):
    """K7 at ``tiles`` and K8/K9's bodies with dropout 0.1 in bf16 against
    the port's plain versions in bf16 under the same Philox key."""
    (q, k, v, dout), mask, bias = _bias_inputs(dims, mask_kind,
                                               seed=sum(dims) + 5)
    keep, key = _keep(dims, seed=sum(dims))
    scale = D ** -0.5
    out, m, l = emulate_forward(q, k, v, mask, causal, scale, bias=bias,
                                keep=keep, tiles=tiles)
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
def test_bias_dropout_arithmetic_matches_the_plain_versions(dims, causal,
                                                            mask_kind):
    """K7 and K8/K9's bodies with dropout 0.1 in bf16 against the port's
    plain versions in bf16 under the same Philox key (which round P times
    the keep factor and dS to bf16 before their products, as the Pallas
    kernels do): the chip check's tolerances."""
    _check_bias_dropout(dims, causal, mask_kind, (TILE, TILE))


# the other tile widths of K7's wgmma body (csrc/allheads_wgmma.cuh; the
# library's FwdShape takes 64 x 64, sweep_attention times these too):
# (query rows a block, keys a tile); K8/K9's tiles stay 64 x 64
K7_TILES = [(128, 64), (64, 128)]
K7_TILE_IDS = ["128x64", "64x128"]


@pytest.mark.parametrize("dims,causal,mask_kind", BIAS_CASES, ids=BIAS_IDS)
@pytest.mark.parametrize("tiles", K7_TILES, ids=K7_TILE_IDS)
def test_bias_forward_arithmetic_matches_jax_at_k7_tiles(tiles, dims, causal,
                                                         mask_kind):
    """``test_bias_forward_arithmetic_matches_jax`` at K7's other tile
    widths: the online softmax a key tile at a time, the early exit a block
    at a time; atol = rtol = 2e-2."""
    _check_bias_forward(dims, causal, mask_kind, tiles)


@pytest.mark.parametrize("dims,causal,mask_kind", BIAS_CASES, ids=BIAS_IDS)
@pytest.mark.parametrize("tiles", K7_TILES, ids=K7_TILE_IDS)
def test_bias_backward_arithmetic_matches_jax_at_k7_tiles(tiles, dims,
                                                          causal, mask_kind):
    """``test_bias_backward_arithmetic_matches_jax`` from the row stats of
    K7 at its other tile widths: each gradient atol = 2e-2 of its largest
    entry, rtol 2e-2."""
    _check_bias_backward(dims, causal, mask_kind, tiles)


@pytest.mark.parametrize("dims,causal,mask_kind", DROP_CASES, ids=DROP_IDS)
@pytest.mark.parametrize("tiles", K7_TILES, ids=K7_TILE_IDS)
def test_bias_dropout_arithmetic_at_k7_tiles(tiles, dims, causal, mask_kind):
    """``test_bias_dropout_arithmetic_matches_the_plain_versions`` at K7's
    other tile widths (the same Philox bits at every width: each element's
    counter is its own (b, h, i, j)): the chip check's tolerances."""
    _check_bias_dropout(dims, causal, mask_kind, tiles)


# K4 on the wgmma forward at sq != sk: (B, Sq, Sk, H), causal: not causal
# with sq < sk; not causal with sq > sk over one key tile (MPT's and family
# 7's cross-attention over the 64-token memory); causal with the ends
# aligned (T5's prefixed decoder)
K4_CASES = [((2, 100, 228, 2), False), ((2, 205, 64, 2), False),
            ((2, 128, 148, 2), True)]
K4_IDS = ["100x228", "205x64-one-key-tile", "128x148-causal"]


@pytest.mark.parametrize("dims,causal", K4_CASES, ids=K4_IDS)
@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
def test_k4_wgmma_arithmetic_at_sq_ne_sk_matches_jax(dtype, d, dims, causal):
    """K4's wgmma forward (64 x 64 tiles) at head dim d, sample 0 with a
    key-mask hole, sample 1 fully masked: sample 0's out and m + log l
    against the Pallas _fwd with with_lse (the JAX flash_attention's) in
    interpret mode, sample 1 against xla_attention (a fully masked row
    averages V over the sk keys; the Pallas kernel pads the keys to 128
    first): atol = rtol = 2e-2 in bf16, 5e-3 in fp16."""
    tol = TOL if dtype == torch.bfloat16 else FP16_TOL
    (q, k, v, _), mask = _inputs(dims, "hole_fully_masked",
                                 seed=sum(dims) + d, dtype=dtype, d=d)
    scale = d ** -0.5
    seen = {"early_exit": 0}
    out, m, l = emulate_forward(q, k, v, mask, causal, scale, dtype=dtype,
                                seen=seen)
    b, _, _, h = dims
    jdt = jnp.dtype(str(dtype).split(".")[1])
    qf, kf, vf = (_heads_first(t[:1], jdt) for t in (q, k, v))
    maskf = jnp.repeat(jnp.asarray(mask[:1].numpy()), h, axis=0)
    want, lse = jfa._fwd(qf, kf, vf, maskf, scale, causal, True,
                         with_lse=True)
    _close(out[:1], _seq_first(want, 1, h), tol, tol, "out")
    lse = torch.from_numpy(np.array(lse)).reshape(1, h, -1)
    _close(m[:1] + torch.log(l[:1]), lse, tol, tol, "m + log l")
    jq, jk, jv = (jnp.asarray(t[1:].numpy()) for t in (q, k, v))
    plain = xla_attention(jq, jk, jv, kv_mask=jnp.asarray(mask[1:].numpy()),
                          causal=causal, scale=scale)
    _close(out[1:], torch.from_numpy(np.array(plain)), tol, tol,
           "fully masked sample")
    assert float(m[1].max()) == np.float32(NEG_INF)
    if causal:
        assert seen["early_exit"] > 0     # the diagonal's early exit ran


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
    out, m, l = emulate_forward(q, k, v, mask, causal, scale, dtype=None,
                                bias=bias, keep=keep)
    kw = dict(causal=causal, scale=scale, dropout_rate=RATE,
              dropout_seed=key)
    want_out, want_m, want_l = fa.bias_attention_reference(
        q, k, v, bias=bias[None], kv_mask=mask, with_stats=True, **kw)
    _close(out, want_out, 1e-5, 0, "out")
    _close(m, want_m, 1e-5, 0, "m")
    _close(l, want_l, 1e-5, 1e-5, "l")
    got = emulate_backward(q, k, v, mask, out, dout, m, l, causal, scale,
                           dtype=None, bias=bias, keep=keep)
    want = fa.bias_attention_bwd_reference(q, k, v, mask, bias[None], out,
                                           dout, **kw)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got,
                          want[:3] + (want[3][0],)):
        _close(g, w, 1e-5, 0, name)


@pytest.mark.parametrize("dims,causal,mask_kind", BIAS_CASES, ids=BIAS_IDS)
def test_fp16_bias_arithmetic_matches_jax(dims, causal, mask_kind):
    """K7's and K8/K9's bodies in their fp16 form against the Pallas
    flash_attention_bias in float16 in interpret mode and its jax.grad:
    out atol = rtol = 5e-3; dq, dk, dv and dbias each atol = 5e-3 of its
    largest entry, rtol 5e-3."""
    f16 = torch.float16
    (q, k, v, dout), mask, bias = _bias_inputs(dims, mask_kind,
                                               seed=sum(dims) + 7, dtype=f16)
    scale = D ** -0.5
    out, m, l = emulate_forward(q, k, v, mask, causal, scale, dtype=f16,
                                bias=bias)
    got = emulate_backward(q, k, v, mask, out, dout, m, l, causal, scale,
                           dtype=f16, bias=bias)
    want_out, want = _jax_bias_reference(causal, q, k, v, dout, mask, bias,
                                         scale, jnp.float16)
    _close(out, want_out, FP16_TOL, FP16_TOL, "out")
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        _close_grad(g, w, name, FP16_TOL)


@pytest.mark.parametrize("dims,causal,mask_kind", DROP_CASES, ids=DROP_IDS)
def test_fp16_bias_dropout_arithmetic_matches_the_plain_versions(
        dims, causal, mask_kind):
    """K7 and K8/K9's bodies with dropout 0.1 in their fp16 form against the
    port's plain versions in float16 under the same Philox key (which round
    P times the keep factor and dS to float16 before their products): atol
    = rtol = 5e-3, a gradient's atol 5e-3 of its largest entry. The keep
    factor 1 / 0.9 multiplies P before the rounding, as in bf16."""
    f16 = torch.float16
    (q, k, v, dout), mask, bias = _bias_inputs(dims, mask_kind,
                                               seed=sum(dims) + 8, dtype=f16)
    keep, key = _keep(dims, seed=sum(dims) + 2)
    scale = D ** -0.5
    out, m, l = emulate_forward(q, k, v, mask, causal, scale, dtype=f16,
                                bias=bias, keep=keep)
    got = emulate_backward(q, k, v, mask, out, dout, m, l, causal, scale,
                           dtype=f16, bias=bias, keep=keep)
    hq, hk, hv, hdo, hb = (t.to(f16) for t in (q, k, v, dout, bias[None]))
    kw = dict(causal=causal, scale=scale, dropout_rate=RATE,
              dropout_seed=key)
    want_out = fa.bias_attention_reference(hq, hk, hv, bias=hb, kv_mask=mask,
                                           **kw)
    _close(out, want_out, FP16_TOL, FP16_TOL, "out")
    want = fa.bias_attention_bwd_reference(hq, hk, hv, mask, hb, want_out,
                                           hdo, **kw)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got,
                          want[:3] + (want[3][0],)):
        _close_grad(g, w, name, FP16_TOL)


# the JAX package's results at a (case, dtype), shared by the tile widths
_ALLHEADS_REFERENCE = {}


def _jax_allheads_reference(dims, causal, mask_kind, q, k, v, dout, mask,
                            scale, dtype):
    """(out, (dq, dk, dv)) of the JAX package for K1 and K3's inputs: the
    Pallas ``_allheads`` (``_allheads_fwd`` and its VJP ``_allheads_vjp_bwd``)
    in ``dtype`` in interpret mode where sq == sk and no sample is fully
    masked; ``_jax_reference``'s otherwise (the all-heads kernel's mask
    block takes sq keys, and with a fully masked sample the port follows
    xla_attention's gradient)."""
    key = (dims, causal, mask_kind, str(dtype))
    if key in _ALLHEADS_REFERENCE:
        return _ALLHEADS_REFERENCE[key]
    b, sq, sk, h = dims
    if mask_kind == "fully_masked" or sq != sk:
        out, _, grads = _jax_reference(dims, causal, mask_kind, q, k, v,
                                       dout, mask, scale, dtype)
    else:
        q2, k2, v2, do2 = (jnp.asarray(t.reshape(b, t.shape[1], h * D)
                                       .numpy()).astype(dtype)
                           for t in (q, k, v, dout))
        jmask = jnp.asarray(mask.numpy())

        def f(q_, k_, v_):
            return jfa._allheads(q_, k_, v_, jmask, scale, causal, True, h, D)

        jout, vjp = jax.vjp(f, q2, k2, v2)

        def bshd(x):
            x = np.array(jnp.asarray(x).astype(jnp.float32))
            return torch.from_numpy(x).reshape(b, x.shape[1], h, D)

        out, grads = bshd(jout), tuple(bshd(g) for g in vjp(do2))
    _ALLHEADS_REFERENCE[key] = (out, grads)
    return out, grads


@pytest.mark.parametrize("dims,causal,mask_kind", CASES, ids=IDS)
@pytest.mark.parametrize("tiles", WGMMA_TILES, ids=WGMMA_TILE_IDS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
def test_wgmma_arithmetic_matches_allheads(dtype, tiles, dims, causal,
                                           mask_kind):
    """K1's and K3's wgmma bodies, emulated at their tile widths in bf16 and
    fp16 (the forward's online softmax a key tile at a time, the early exit
    a block at a time; K3 from the forward's row max and sum), against the
    Pallas _allheads_fwd and _allheads_vjp_bwd in interpret mode (or, as
    ``_jax_allheads_reference`` says, the per-head Pallas kernels or
    xla_attention): out atol = rtol = 2e-2 in bf16, 5e-3 in fp16; each
    gradient atol that fraction of its largest entry."""
    tol = TOL if dtype == torch.bfloat16 else FP16_TOL
    (q, k, v, dout), mask = _inputs(dims, mask_kind, seed=sum(dims) + 9,
                                    dtype=dtype)
    scale = D ** -0.5
    seen = {"early_exit": 0, "hidden_tiles": 0}
    out, m, l = emulate_forward(q, k, v, mask, causal, scale, dtype=dtype,
                                seen=seen, tiles=tiles)
    got = emulate_backward(q, k, v, mask, out, dout, m, l, causal, scale,
                           dtype=dtype, seen=seen, dkdv_tiles=tiles,
                           dq_tiles=tiles)
    want_out, want = _jax_allheads_reference(
        dims, causal, mask_kind, q, k, v, dout, mask, scale,
        jnp.dtype(str(dtype).split(".")[1]))
    _close(out, want_out, tol, tol, "out")
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close_grad(g, w, name, tol)
    if causal and mask_kind != "fully_masked":
        assert seen["early_exit"] > 0     # the diagonal's early exit ran
    if mask_kind == "fully_masked":
        assert seen["hidden_tiles"] > 0
        assert float(got[0][0].abs().max()) == 0.0    # no dQ, no dK
        assert float(got[1][0].abs().max()) == 0.0


def test_allheads_stats_hand_off_on_the_plain_path():
    """fp32 on the CPU, a prompt with a pad hole (sample 0) and causal rows
    that see only masked keys (sample 1): K1's row stats
    (flash_attention_allheads_stats) are _row_stats's (1e-6), a fully
    masked row's max -1e30 and sum Sk; K3 given them equals K3 without them
    to 1e-6; and both match jax.grad of the JAX package's _allheads in
    interpret mode to 1e-5, out and every gradient of sample 0 and dV of
    both. Sample 1's dQ and dK match jax.grad of xla_attention instead: at a
    fully masked row the Pallas kernel keeps dS at the masked logits, and
    the port, as xla_attention, does not."""
    b, s, h = 2, 96, 2
    rng = np.random.RandomState(12)
    q, k, v, dout = (torch.from_numpy(rng.randn(b, s, h, D).astype(np.float32))
                     for _ in range(4))
    mask = np.ones((b, s), np.int32)
    mask[0, 40:60] = 0
    mask[0, 90:] = 0
    mask[1, :30] = 0
    mask[1, 70:80] = 0
    mask = torch.from_numpy(mask)
    scale = D ** -0.5
    out, m, l = fa.flash_attention_allheads_stats(q, k, v, kv_mask=mask,
                                                  causal=True, scale=scale)
    want_m, want_l = fa._row_stats(q, k, mask, True, scale)
    _close(m, want_m, 1e-6, 0, "row max")
    _close(l, want_l, 1e-6, 1e-6, "row sum")
    assert bool((m[1, :, :30] == NEG_INF).all())
    assert torch.equal(l[1, :, :30], torch.full_like(l[1, :, :30], s))
    given = fa.flash_attention_allheads_bwd(q, k, v, mask, out, dout,
                                            causal=True, scale=scale,
                                            row_max=m, row_sum=l)
    own = fa.flash_attention_allheads_bwd(q, k, v, mask, out, dout,
                                          causal=True, scale=scale)
    for name, g, w in zip(("dq", "dk", "dv"), given, own):
        _close(g, w, 1e-6, 0, name)

    jq, jk, jv, jdo = (jnp.asarray(t.numpy()) for t in (q, k, v, dout))
    jmask = jnp.asarray(mask.numpy())

    def allheads(q_, k_, v_):
        return jfa._allheads(q_.reshape(b, s, h * D), k_.reshape(b, s, h * D),
                             v_.reshape(b, s, h * D), jmask, scale, True,
                             True, h, D).reshape(b, s, h, D)

    def xla(q_, k_, v_):
        return xla_attention(q_, k_, v_, kv_mask=jmask, causal=True,
                             scale=scale)

    pallas_out, vjp = jax.vjp(allheads, jq, jk, jv)
    pallas = [torch.from_numpy(np.array(g)) for g in vjp(jdo)]
    _, vjp = jax.vjp(xla, jq, jk, jv)
    plain = [torch.from_numpy(np.array(g)) for g in vjp(jdo)]
    _close(out, torch.from_numpy(np.array(pallas_out)), 1e-5, 0, "out")
    for grads in (given, own):
        for name, g, p, x in zip(("dq", "dk", "dv"), grads, pallas, plain):
            _close(g[0], p[0], 1e-5, 0, name + " sample 0")
            _close(g[1], x[1], 1e-5, 0, name + " sample 1")
        _close(grads[2], pallas[2], 1e-5, 0, "dv")
