"""Time shapes of the bf16 tensor-core attention bodies on the card.

    python -m mmgl_tpu_torch.sweep_attention [--allheads | --no-allheads |
                                             --k4-k7]

``--allheads`` times K1's and K3's wgmma/TMA bodies alone (a few minutes),
``--no-allheads`` everything else, ``--k4-k7`` only K4's and K7's wgmma
shapes (about two minutes); no flag, everything. K4 and K7
(csrc/sweep/k4_k7_shapes.cu, on the forward of csrc/allheads_wgmma.cuh, in
its bias form for K7): each in several (consumer warpgroups, key tile rows,
ring stages, blocks an SM) shapes, beside the mma.sync body each replaced
(shape -1), the library's wrapper and scaled_dot_product_attention, at
every K4 and K7 row of PERF.md §6 (K4: T5's, MPT-2.7B's and family 7's
cross-attention, prefix tuning's 704 x 724, OPT-350M's 2048 and (4, 1024,
32, 80/128) causal with the row stats; K7: T5's encoder at 512 and 576,
its decoder at 128² and its prefixed decoder at 128 x 148, each without
and with dropout 0.1, and the training cross-attention), with the
device time of each body (kernel events under torch.profiler); each shape
held to the library's output within 2^-7 of its largest entry. K1 and K3
(csrc/sweep/allheads_shapes.cu, on the bodies of csrc/allheads_wgmma.cuh):
the forward, dK/dV and dQ bodies each in several (consumer warpgroups,
streamed tile rows, ring stages, blocks an SM) shapes, beside the mma.sync
bodies they replaced (the forward; K3's four launches) and the library's
wrappers, at K1's and K3's shapes of PERF.md §6: OPT-125M's (4, 640, 12, 64)
causal, Roberta's (44, 512, 12, 64), family 7's (4, 205, 32, 80), OPT-2.7B's
(4, 640, 32, 80) and OPT-6.7B's (4, 640, 32, 128) causal, against
scaled_dot_product_attention, and the device time of the library's K1 and
K3 and of the mma.sync bodies (their kernel events under torch.profiler);
each shape held to the library's outputs within 2^-7 of their largest entry
(another tile width sums the softmax in another order). The rest:

Builds csrc/sweep/attention_shapes.cu (the forward body and K6's dK/dV and
dQ bodies in several (warps, ring stages, blocks an SM) shapes, each at
head dims 64, 80 and 128) and
csrc/sweep/bias_shapes.cu (their bias form, K7 and K8/K9, in T5's three
forms) with two concurrent nvcc into build/mmgl_tpu_torch/. Then at
OPT-350M's (4, 2048, 16, 64), at (4, 1024, 16, 64) (both causal, with the
prompt and summary pad hole), OPT-125M's (4, 640, 12, 64) causal,
OPT-2.7B's (4, 640, 32, 80) and OPT-6.7B's (4, 640, 32, 128) causal,
CLIP's (24, 197, 12, 64) and the CLIP text tower's (44, 77, 8, 64)
causal, and at T5-base's encoder (4, 512, 12, 64) with
its bias, decoder (4, 128, 12, 64) causal with its bias and training
cross-attention (q 128, k/v 512, no bias), each with and without dropout
0.1 (the cross-attention only with), it times each shape, the library's
wrappers (K4 with its stats, K6; K7 with its stats, K8/K9 from them) and
scaled_dot_product_attention with the masks and bias as a float attn_mask
(and its backward, the bias's gradient included). A sample is the mean of
10 calls back to back (CUDA events); each time is the median of 10
samples, taken in turns. Every shape's output is held to the library's:
the forward bit for bit (the shapes change no row's arithmetic), the
gradients within a bf16 ulp of their largest entry (the sweep feeds them
torch's delta, not the delta pass's). Prints the card, nvcc's registers
and spills, and one JSON line per case; exits 1 without a GPU or if a
shape disagrees. nvcc's report names each kernel by its mangled template
arguments: the head dim is the first of the tensor-core bodies' (``Li64E``,
``Li80E``, ``Li128E``).
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F

from mmgl_tpu_torch.ops import _build
from mmgl_tpu_torch.ops import attention as att
from mmgl_tpu_torch.ops import flash_attention as fa

SOURCES = [_build.CSRC / "sweep" / name
           for name in ("attention_shapes.cu", "bias_shapes.cu",
                        "allheads_shapes.cu", "k4_k7_shapes.cu")]
RUN = 10        # calls back to back in a sample
SAMPLES = 10
# (B, Sq = Sk, H, D), causal, backward too
CASES = [((4, 2048, 16, 64), True, True), ((4, 1024, 16, 64), True, True),
         ((4, 640, 12, 64), True, True), ((4, 640, 32, 80), True, True),
         ((4, 640, 32, 128), True, True), ((24, 197, 12, 64), False, False),
         ((44, 77, 8, 64), True, False)]
# T5-base: (name, (B, Sq, Sk, H), causal, bias), each without and with
# dropout 0.1 (the cross-attention, which has no bias, only with)
BIAS_CASES = [("enc", (4, 512, 512, 12), False, True),
              ("dec", (4, 128, 128, 12), True, True),
              ("cross", (4, 128, 512, 12), False, False)]
RATE = 0.1


def build(which=(0, 1, 2, 3)):
    """The sweep libraries (``which``: indices into SOURCES; the others are
    None), each source built by its own nvcc, all at once; prints each
    kernel's registers and any spills."""
    h = hashlib.sha256(_build._digest().encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    outs = [_build.BUILD_DIR / f"sweep_{src.stem}-{h.hexdigest()[:16]}.so"
            for src in SOURCES]
    todo = [(src, out) for i, (src, out) in enumerate(zip(SOURCES, outs))
            if i in which and not out.exists()]
    if todo:
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        report = _build._run([[_build.find_nvcc(), *_build.NVCC_FLAGS,
                               "-shared", str(src), "-o", str(out)]
                              for src, out in todo])
        print("\n".join(line for line in report.splitlines()
                        if "Compiling entry" in line or "Used" in line
                        or "spill" in line
                        and " 0 bytes spill stores" not in line))
    lib, bias_lib, allheads_lib, k4k7_lib = (
        ctypes.CDLL(str(out)) if i in which else None
        for i, out in enumerate(outs))
    ptr, i32, f32, u32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                          ctypes.c_uint)
    tail = [i32] * 4 + [f32, i32, ptr]
    if lib is not None:
        lib.sweep_fwd.argtypes = [i32, i32] + [ptr] * 7 + tail
        lib.sweep_bwd.argtypes = [i32, i32] + [ptr] * 11 + tail
    if bias_lib is not None:
        bias_tail = [i32] * 4 + [f32, i32, u32, f32, ptr]
        bias_lib.sweep_bias_fwd.argtypes = [i32] + [ptr] * 9 + bias_tail
        bias_lib.sweep_bias_bwd.argtypes = [i32] + [ptr] * 14 + bias_tail
    if allheads_lib is not None:
        allheads_lib.sweep_k1.argtypes = [i32, i32] + [ptr] * 7 + tail
        allheads_lib.sweep_dkdv.argtypes = [i32, i32] + [ptr] * 11 + tail
        allheads_lib.sweep_dq.argtypes = [i32, i32] + [ptr] * 10 + tail
        allheads_lib.sweep_k3_before.argtypes = [i32] + [ptr] * 10 + tail
    if k4k7_lib is not None:
        k4k7_lib.sweep_k4.argtypes = [i32, i32] + [ptr] * 7 + tail
        k4k7_lib.sweep_k7.argtypes = ([i32] + [ptr] * 5 + [i32, i32]
                                      + [ptr] * 4 + [i32] * 4
                                      + [f32, i32, u32, f32, ptr])
    return lib, bias_lib, allheads_lib, k4k7_lib


def inputs(b, s, h, d, seed, device):
    """q, k, v, dO (bf16) and a (B, S) int32 key mask: a prompt of S - S/16
    keys and a summary of S/16, each right-padded, so the valid keys have
    a hole (the decoder-only training batch)."""
    g = torch.Generator().manual_seed(seed)
    q, k, v, dout = (torch.randn(b, s, h, d, generator=g).to(
        device, torch.bfloat16) for _ in range(4))
    mask = torch.ones(b, s, dtype=torch.int32)
    cut = s - s // 16
    for i in range(b):
        lo = int(torch.randint(s // 20, cut, (1,), generator=g))
        mask[i, lo:cut] = 0
        mask[i, cut + int(torch.randint(1, s // 16, (1,), generator=g)):] = 0
    return q, k, v, dout, mask.to(device)


def medians(fns):
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    order = list(fns) + list(fns)[::-1]
    samples = {name: [] for name in fns}
    for _ in range(SAMPLES // 2):
        for name in order:
            start.record()
            for _ in range(RUN):
                fns[name]()
            end.record()
            end.synchronize()
            samples[name].append(start.elapsed_time(end) / RUN)
    return {name: round(statistics.median(t), 4)
            for name, t in samples.items()}


def sweep_case(lib, dims, causal, with_bwd, device):
    b, s, h, d = dims
    q, k, v, dout, mask = inputs(b, s, h, d, s + h, device)
    if not causal:
        mask = torch.ones_like(mask)
    scale = d ** -0.5
    stream = torch.cuda.current_stream().cuda_stream
    out, m, l = fa.flash_attention_stats(q, k, v, kv_mask=mask, causal=causal)
    allowed = mask.bool()[:, None, None, :].expand(b, 1, s, s)
    if causal:
        allowed = allowed & torch.ones(s, s, dtype=torch.bool,
                                       device=device).tril()
    am = torch.zeros(b, 1, s, s, device=device).masked_fill(
        ~allowed, -1e30).to(torch.bfloat16)
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous()
                       for t in (q, k, v, dout))
    fwd = {"library K4 with stats": lambda: fa.flash_attention_stats(
        q, k, v, kv_mask=mask, causal=causal)}
    same = {}
    for i in range(lib.sweep_fwd_shapes()):
        o2, m2, l2 = torch.empty_like(out), torch.empty_like(m), \
            torch.empty_like(l)

        def call(i=i, o2=o2, m2=m2, l2=l2):
            err = lib.sweep_fwd(i, d, q.data_ptr(), k.data_ptr(),
                                v.data_ptr(), mask.data_ptr(), o2.data_ptr(),
                                m2.data_ptr(), l2.data_ptr(), b, s, s, h,
                                scale, int(causal), stream)
            if err:
                raise RuntimeError(f"forward shape {i}: CUDA error {err}")
        call()
        torch.cuda.synchronize()
        # the library's K4 is the wgmma body: the same math, products on
        # other instructions
        same[f"forward shape {i}"] = _near([o2], [out]) and _stats_near(
            (m2, l2), (m, l))
        fwd[f"forward shape {i}"] = call
    fwd["scaled_dot_product_attention"] = \
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am)
    result = {"shape": [b, s, h, d], "causal": causal,
              "forward_ms": medians(fwd)}
    if with_bwd:
        ref = fa.flash_attention_blocked_bwd(q, k, v, mask, out, dout, m, l,
                                             causal=causal)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        bwd = {"library K6": lambda: fa.flash_attention_blocked_bwd(
            q, k, v, mask, out, dout, m, l, causal=causal)}
        for i in range(lib.sweep_bwd_shapes()):
            grads = [torch.empty_like(q) for _ in range(3)]

            def call(i=i, grads=grads):
                err = lib.sweep_bwd(
                    i, d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    mask.data_ptr(), dout.data_ptr(), m.data_ptr(),
                    l.data_ptr(), delta.data_ptr(),
                    *(t.data_ptr() for t in grads), b, s, s, h, scale,
                    int(causal), stream)
                if err:
                    raise RuntimeError(f"backward shape {i}: CUDA error "
                                       f"{err}")
            call()
            torch.cuda.synchronize()
            # the delta here is torch's sum, not the delta pass's: within
            # a bf16 ulp of the largest entry
            same[f"backward shape {i}"] = all(
                float((x.float() - y.float()).abs().max())
                <= 2 ** -7 * float(y.float().abs().max())
                for x, y in zip(grads, ref))
            bwd[f"backward shape {i}"] = call
        ins = [t.detach().requires_grad_() for t in (qt, kt, vt)]
        lib_out = F.scaled_dot_product_attention(*ins, attn_mask=am)
        bwd["scaled_dot_product_attention backward"] = \
            lambda: torch.autograd.grad(lib_out, ins, dot, retain_graph=True)
        result["backward_ms"] = medians(bwd)
    result["agrees_with_library"] = same
    return result


def bias_inputs(dims, with_bias, rate, device):
    """T5's bf16 q (its D**-0.5 folded in), k, v, dO, the (H, Sq, Sk) bias
    or None, a right-padded (B, Sk) int32 key mask, and the dropout key,
    threshold and keep factor (None, 0, 1 without dropout)."""
    b, sq, sk, h = dims
    g = torch.Generator().manual_seed(sq + sk + h)
    q = torch.randn(b, sq, h, 64, generator=g) * 0.125
    k, v = (torch.randn(b, sk, h, 64, generator=g) for _ in range(2))
    dout = torch.randn(b, sq, h, 64, generator=g)
    bias = torch.randn(h, sq, sk, generator=g) if with_bias else None
    mask = torch.ones(b, sk, dtype=torch.int32)
    for i in range(b):
        mask[i, sk - int(torch.randint(1, sk // 4, (1,), generator=g)):] = 0
    q, k, v, dout = (t.to(device, torch.bfloat16) for t in (q, k, v, dout))
    if bias is not None:
        bias = bias.to(device, torch.bfloat16)
    seed, thr, keep_inv = None, 0, 1.0
    if rate:
        seed = torch.tensor([2 ** 31 + 7, 99], dtype=torch.int64,
                            device=device)
        thr, keep_inv = att.dropout_threshold(rate)
    return q, k, v, dout, bias, mask.to(device), seed, thr, keep_inv


def sweep_bias_case(lib, tag, dims, causal, with_bias, rate, device):
    """K7 with its row stats and K8/K9's tile bodies from them, each shape
    against the library's wrappers and SDPA, at one of T5's shapes."""
    b, sq, sk, h = dims
    q, k, v, dout, bias, mask, seed, thr, keep_inv = bias_inputs(
        dims, with_bias, rate, device)
    stream = torch.cuda.current_stream().cuda_stream
    kw = dict(bias=None if bias is None else bias[None], kv_mask=mask,
              causal=causal, scale=1.0, dropout_rate=rate, dropout_seed=seed)
    out, m, l = fa.flash_attention_bias_stats(q, k, v, **kw)
    ptr = fa._ptr
    fwd = {"library K7 with stats":
           lambda: fa.flash_attention_bias_stats(q, k, v, **kw)}
    same = {}
    for i in range(lib.sweep_bias_fwd_shapes()):
        o2, m2, l2 = (torch.empty_like(t) for t in (out, m, l))

        def call(i=i, o2=o2, m2=m2, l2=l2):
            err = lib.sweep_bias_fwd(
                i, q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                ptr(bias), ptr(seed), o2.data_ptr(), m2.data_ptr(),
                l2.data_ptr(), b, sq, sk, h, 1.0, int(causal), thr, keep_inv,
                stream)
            if err:
                raise RuntimeError(f"bias forward shape {i}: CUDA error "
                                   f"{err}")
        call()
        torch.cuda.synchronize()
        # the library's K7 is the wgmma body
        same[f"forward shape {i}"] = _near([o2], [out]) and _stats_near(
            (m2, l2), (m, l))
        fwd[f"forward shape {i}"] = call
    allowed = mask.bool()[:, None, None, :].expand(b, 1, sq, sk)
    if causal:
        allowed = allowed & torch.ones(sq, sk, dtype=torch.bool,
                                       device=device).tril(sk - sq)
    am = torch.zeros(b, 1, sq, sk, device=device)
    if bias is not None:
        am = am + bias.float()
    am = am.masked_fill(~allowed, -1e30).to(torch.bfloat16)
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous()
                       for t in (q, k, v, dout))
    fwd["scaled_dot_product_attention"] = \
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am,
                                               dropout_p=rate, scale=1.0)
    bkw = dict(causal=causal, scale=1.0, dropout_rate=rate,
               dropout_seed=seed, row_max=m, row_sum=l)
    ref = fa.flash_attention_bias_bwd(q, k, v, mask, bias, out, dout, **bkw)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2) \
        .contiguous()
    bwd = {"library K8/K9 from K7's stats":
           lambda: fa.flash_attention_bias_bwd(q, k, v, mask, bias, out,
                                               dout, **bkw)}
    partial = (torch.empty(b * h * sq * sk, dtype=torch.float32,
                           device=device) if bias is not None else None)
    for i in range(lib.sweep_bias_bwd_shapes()):
        grads = [torch.empty_like(t) for t in (q, k, v)]

        def call(i=i, grads=grads):
            err = lib.sweep_bias_bwd(
                i, q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                ptr(bias), ptr(seed), dout.data_ptr(), m.data_ptr(),
                l.data_ptr(), delta.data_ptr(),
                *(t.data_ptr() for t in grads), ptr(partial), b, sq, sk, h,
                1.0, int(causal), thr, keep_inv, stream)
            if err:
                raise RuntimeError(f"bias backward shape {i}: CUDA error "
                                   f"{err}")
        call()
        torch.cuda.synchronize()
        same[f"backward shape {i}"] = all(
            float((x.float() - y.float()).abs().max())
            <= 2 ** -7 * float(y.float().abs().max())
            for x, y in zip(grads, ref))
        bwd[f"backward shape {i}"] = call
    ins = [t.detach().requires_grad_() for t in (qt, kt, vt)]
    if bias is not None:
        am = am.detach().requires_grad_()
        ins.append(am)
    lib_out = F.scaled_dot_product_attention(*ins[:3], attn_mask=am,
                                             dropout_p=rate, scale=1.0)
    bwd["scaled_dot_product_attention backward"] = \
        lambda: torch.autograd.grad(lib_out, ins, dot, retain_graph=True)
    return {"case": tag, "shape": list(dims), "causal": causal,
            "bias": with_bias, "dropout": rate,
            "forward_ms": medians(fwd), "backward_ms": medians(bwd),
            "agrees_with_library": same}


# K1's and K3's shapes of PERF.md §6: (B, S, H, D), causal
ALLHEADS_CASES = [((4, 640, 12, 64), True), ((44, 512, 12, 64), False),
                  ((4, 205, 32, 80), True), ((4, 640, 32, 80), True),
                  ((4, 640, 32, 128), True)]


def device_ms(fns, calls=20):
    """The device time of one call of each callable: the sum of its kernel
    events under torch.profiler (CUDA activity) over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total = sum(getattr(e, "self_device_time_total", 0)
                    for e in prof.key_averages()
                    if e.device_type.name == "CUDA")
        out[name] = round(total / calls / 1e3, 4)
    return out


def _near(got, want):
    """Within 2^-7 of the largest entry of each of ``want``."""
    return all(float((x.float() - y.float()).abs().max())
               <= 2 ** -7 * float(y.float().abs().max())
               for x, y in zip(got, want))


def _stats_near(got, want):
    """Row max and sum within 1e-4 (fp32 sums in another order)."""
    return all(torch.allclose(x, y, atol=1e-4, rtol=1e-4)
               for x, y in zip(got, want))


def sweep_allheads_case(lib, dims, causal, device):
    """K1's and K3's wgmma shapes, the mma.sync bodies before them, the
    library's wrappers and SDPA at one shape."""
    b, s, h, d = dims
    q, k, v, dout, mask = inputs(b, s, h, d, s + h + d, device)
    scale = d ** -0.5
    stream = torch.cuda.current_stream().cuda_stream
    out, m, l = fa.flash_attention_allheads_stats(q, k, v, kv_mask=mask,
                                                  causal=causal)
    args = (b, s, s, h, scale, int(causal), stream)
    fwd = {"library K1 (wrapper)": lambda: fa.flash_attention_allheads(
        q, k, v, kv_mask=mask, causal=causal)}
    same = {}
    for i in range(-1, lib.sweep_k1_shapes()):
        o2 = torch.empty_like(out)
        name = "mma.sync forward (before)" if i < 0 else f"k1 shape {i}"

        def call(i=i, o2=o2):
            err = lib.sweep_k1(i, d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               mask.data_ptr(), o2.data_ptr(), None, None,
                               *args)
            if err:
                raise RuntimeError(f"k1 shape {i}: CUDA error {err}")
        call()
        torch.cuda.synchronize()
        same[name] = _near([o2], [out])
        fwd[name] = call
    am = _float_mask(mask, s, causal, device)
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous()
                       for t in (q, k, v, dout))
    fwd["scaled_dot_product_attention"] = \
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am)

    ref = fa.flash_attention_allheads_bwd(q, k, v, mask, out, dout,
                                          causal=causal, row_max=m,
                                          row_sum=l)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2) \
        .contiguous()
    scratch = torch.empty(3 * b * h * s, dtype=torch.float32, device=device)
    bwd = {"library K3 from K1's stats (wrapper)":
           lambda: fa.flash_attention_allheads_bwd(
               q, k, v, mask, out, dout, causal=causal, row_max=m,
               row_sum=l),
           "library K3 with its stats pass (wrapper)":
           lambda: fa.flash_attention_allheads_bwd(
               q, k, v, mask, out, dout, causal=causal)}
    grads = [torch.empty_like(q) for _ in range(3)]

    def before():
        err = lib.sweep_k3_before(
            d, q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            out.data_ptr(), dout.data_ptr(), *(t.data_ptr() for t in grads),
            scratch.data_ptr(), *args)
        if err:
            raise RuntimeError(f"k3 before: CUDA error {err}")
    before()
    torch.cuda.synchronize()
    same["mma.sync K3 (before)"] = _near(grads, ref)
    bwd["mma.sync K3, four launches (before)"] = before
    stats = (m.data_ptr(), l.data_ptr(), delta.data_ptr())
    for i in range(-1, lib.sweep_dkdv_shapes()):
        g = [torch.empty_like(q) for _ in range(3)]
        name = ("mma.sync dK/dV + dQ (before)" if i < 0
                else f"dkdv shape {i}")

        def call(i=i, g=g):
            err = lib.sweep_dkdv(i, d, q.data_ptr(), k.data_ptr(),
                                 v.data_ptr(), mask.data_ptr(),
                                 dout.data_ptr(), *stats,
                                 *(t.data_ptr() for t in g), *args)
            if err:
                raise RuntimeError(f"dkdv shape {i}: CUDA error {err}")
        call()
        torch.cuda.synchronize()
        same[name] = _near(g[1:] if i >= 0 else g, ref[1:] if i >= 0 else ref)
        bwd[name] = call
    for i in range(lib.sweep_dq_shapes()):
        g = torch.empty_like(q)

        def call(i=i, g=g):
            err = lib.sweep_dq(i, d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               mask.data_ptr(), out.data_ptr(),
                               dout.data_ptr(), *stats, g.data_ptr(), *args)
            if err:
                raise RuntimeError(f"dq shape {i}: CUDA error {err}")
        call()
        torch.cuda.synchronize()
        same[f"dq shape {i}"] = _near([g], ref[:1])
        bwd[f"dq shape {i}"] = call
    ins = [t.detach().requires_grad_() for t in (qt, kt, vt)]
    lib_out = F.scaled_dot_product_attention(*ins, attn_mask=am)
    bwd["scaled_dot_product_attention backward"] = \
        lambda: torch.autograd.grad(lib_out, ins, dot, retain_graph=True)
    bodies = ("library K1 (wrapper)", "mma.sync forward (before)",
              "library K3 from K1's stats (wrapper)",
              "mma.sync K3, four launches (before)")
    return {"case": "allheads", "shape": list(dims), "causal": causal,
            "forward_ms": medians(fwd), "backward_ms": medians(bwd),
            "device_ms": device_ms({k: fn for k, fn in {**fwd, **bwd}.items()
                                    if k in bodies}),
            "agrees_with_library": same}


def _float_mask(mask, s, causal, device):
    """The key mask (and causal mask) as SDPA's bf16 float attn_mask."""
    b = mask.shape[0]
    allowed = mask.bool()[:, None, None, :].expand(b, 1, s, s)
    if causal:
        allowed = allowed & torch.ones(s, s, dtype=torch.bool,
                                       device=device).tril()
    return torch.zeros(b, 1, s, s, device=device).masked_fill(
        ~allowed, -1e30).to(torch.bfloat16)


# K4's rows of PERF.md §6: (name, (B, Sq, Sk, H, D), causal, with the row
# stats)
K4_CASES = [("t5 cross", (4, 128, 512, 12, 64), False, False),
            ("opt-350m", (4, 2048, 2048, 16, 64), True, True),
            ("prefix", (4, 704, 724, 12, 64), True, False),
            ("mpt-2.7b cross", (4, 640, 64, 32, 80), False, False),
            ("family 7 cross", (4, 205, 64, 32, 80), False, False),
            ("d128 cross", (4, 640, 64, 32, 128), False, False),
            ("1024 d80", (4, 1024, 1024, 32, 80), True, True),
            ("1024 d128", (4, 1024, 1024, 32, 128), True, True)]
# K7's: (name, (B, Sq, Sk, H), causal, bias, dropout rate)
K7_CASES = [("enc", (4, 512, 512, 12), False, True, 0.0),
            ("enc", (4, 512, 512, 12), False, True, RATE),
            ("enc576", (4, 576, 576, 12), False, True, 0.0),
            ("enc576", (4, 576, 576, 12), False, True, RATE),
            ("dec", (4, 128, 128, 12), True, True, 0.0),
            ("dec", (4, 128, 128, 12), True, True, RATE),
            ("t5prefix", (4, 128, 148, 12), True, True, 0.0),
            ("t5prefix", (4, 128, 148, 12), True, True, RATE),
            ("cross", (4, 128, 512, 12), False, False, RATE)]


def _key_mask(b, sk, causal, seed, device):
    """A decoder-only batch's pad hole where causal, else right padding
    with a gap: (B, Sk) int32."""
    g = torch.Generator().manual_seed(seed)
    mask = torch.ones(b, sk, dtype=torch.int32)
    for i in range(b):
        lo = int(torch.randint(sk // 5, sk // 2, (1,), generator=g))
        mask[i, lo:sk // 2] = 0
        mask[i, sk - int(torch.randint(1, max(2, sk // 8), (1,),
                                       generator=g)):] = 0
    return mask.to(device)


def _sdpa_mask(mask, sq, causal, device, bias=None):
    """The key mask, causal mask (ends aligned) and bias as SDPA's bf16
    float attn_mask."""
    b, sk = mask.shape
    allowed = mask.bool()[:, None, None, :].expand(b, 1, sq, sk)
    if causal:
        allowed = allowed & torch.ones(sq, sk, dtype=torch.bool,
                                       device=device).tril(sk - sq)
    am = torch.zeros(b, 1, sq, sk, device=device)
    if bias is not None:
        am = am + bias.float()
    return am.masked_fill(~allowed, -1e30).to(torch.bfloat16)


def sweep_k4_case(lib, tag, dims, causal, stats, device):
    """K4's wgmma shapes, the mma.sync body (shape -1), the library's
    wrapper (no gradient; with the row stats where ``stats``) and SDPA."""
    b, sq, sk, h, d = dims
    g = torch.Generator().manual_seed(sq + sk + d)
    q, k, v = (torch.randn(b, s, h, d, generator=g).to(device, torch.bfloat16)
               for s in (sq, sk, sk))
    mask = _key_mask(b, sk, causal, sq + sk, device)
    scale = d ** -0.5
    stream = torch.cuda.current_stream().cuda_stream
    if stats:
        out, m, l = fa.flash_attention_stats(q, k, v, kv_mask=mask,
                                             causal=causal)
        fwd = {"library K4 (wrapper)": lambda: fa.flash_attention_stats(
            q, k, v, kv_mask=mask, causal=causal)}
    else:
        out = fa.flash_attention(q, k, v, kv_mask=mask, causal=causal)
        fwd = {"library K4 (wrapper)": lambda: fa.flash_attention(
            q, k, v, kv_mask=mask, causal=causal)}
    same = {}
    for i in range(-1, lib.sweep_k4_shapes()):
        o2 = torch.empty_like(out)
        st = fa._empty_stats(q) if stats else (None, None)
        name = "mma.sync (before)" if i < 0 else f"k4 shape {i}"

        def call(i=i, o2=o2, st=st):
            err = lib.sweep_k4(i, d, q.data_ptr(), k.data_ptr(),
                               v.data_ptr(), mask.data_ptr(), o2.data_ptr(),
                               *(fa._ptr(t) for t in st), b, sq, sk, h, scale,
                               int(causal), stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
        call()
        torch.cuda.synchronize()
        same[name] = _near([o2], [out]) and (
            not stats or _stats_near(st, (m, l)))
        fwd[name] = call
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    am = _sdpa_mask(mask, sq, causal, device)
    fwd["scaled_dot_product_attention"] = \
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am)
    return {"case": f"k4 {tag}", "shape": list(dims), "causal": causal,
            "stats": stats, "forward_ms": medians(fwd),
            "device_ms": device_ms(fwd), "agrees_with_library": same}


def sweep_k7_case(lib, tag, dims, causal, with_bias, rate, device):
    """K7's wgmma shapes (its bias in rows padded to a multiple of 8, read
    in place), the mma.sync body's bias form (shape -1), the library's
    wrapper (no gradient, the bias contiguous) and SDPA, in bf16."""
    b, sq, sk, h = dims
    q, k, v, _, bias, mask, seed, thr, keep_inv = bias_inputs(
        dims, with_bias, rate, device)
    stream = torch.cuda.current_stream().cuda_stream
    kw = dict(bias=None if bias is None else bias[None], kv_mask=mask,
              causal=causal, scale=1.0, dropout_rate=rate, dropout_seed=seed)
    out = fa.flash_attention_bias(q, k, v, **kw)
    fwd = {"library K7 (wrapper)":
           lambda: fa.flash_attention_bias(q, k, v, **kw)}
    padded = None if bias is None else fa.padded_bias(bias)
    ld = 0 if bias is None else fa._bias_ld(padded)
    same = {}
    for i in range(-1, lib.sweep_k7_shapes()):
        o2 = torch.empty_like(out)
        name = "mma.sync (before)" if i < 0 else f"k7 shape {i}"

        def call(i=i, o2=o2):
            err = lib.sweep_k7(i, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               mask.data_ptr(), fa._ptr(padded), ld, 0,
                               fa._ptr(seed), o2.data_ptr(), None, None, b,
                               sq, sk, h, 1.0, int(causal), thr, keep_inv,
                               stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
        call()
        torch.cuda.synchronize()
        same[name] = _near([o2], [out])
        fwd[name] = call
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    am = _sdpa_mask(mask, sq, causal, device, bias)
    fwd["scaled_dot_product_attention"] = \
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am,
                                               dropout_p=rate, scale=1.0)
    return {"case": f"k7 {tag}", "shape": list(dims), "causal": causal,
            "bias": with_bias, "dropout": rate, "forward_ms": medians(fwd),
            "device_ms": device_ms(fwd), "agrees_with_library": same}


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    only_new = "--k4-k7" in args
    allheads = "--no-allheads" not in args and not only_new
    rest = "--allheads" not in args and not only_new
    new = "--allheads" not in args
    if not torch.cuda.is_available():
        print("sweep_attention: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"], capture_output=True,
        text=True).stdout.strip())
    lib, bias_lib, allheads_lib, k4k7_lib = build(
        ((0, 1) if rest else ()) + ((2,) if allheads else ())
        + ((3,) if new else ()))
    runs = []
    if new:
        runs += [lambda c=c: sweep_k4_case(k4k7_lib, *c, device)
                 for c in K4_CASES]
        runs += [lambda c=c: sweep_k7_case(k4k7_lib, *c, device)
                 for c in K7_CASES]
    if allheads:
        runs += [lambda c=c: sweep_allheads_case(allheads_lib, *c, device)
                 for c in ALLHEADS_CASES]
    if rest:
        runs += [lambda c=c: sweep_case(lib, *c, device) for c in CASES]
        runs += [lambda c=c, r=r: sweep_bias_case(bias_lib, *c, r, device)
                 for c in BIAS_CASES
                 for r in ((0.0, RATE) if c[3] else (RATE,))]
    ok = True
    for run in runs:
        result = run()
        ok = ok and all(result["agrees_with_library"].values())
        print(json.dumps(result), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
