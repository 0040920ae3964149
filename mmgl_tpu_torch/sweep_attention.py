"""Time shapes of the bf16 tensor-core attention bodies on the card.

    python -m mmgl_tpu_torch.sweep_attention

Builds csrc/sweep/attention_shapes.cu (the forward body and K6's dK/dV and
dQ bodies in several (warps, ring stages, blocks an SM) shapes) and
csrc/sweep/bias_shapes.cu (their bias form, K7 and K8/K9, in T5's three
forms) with two concurrent nvcc into build/mmgl_tpu_torch/. Then at
OPT-350M's (4, 2048, 16, 64), at (4, 1024, 16, 64) (both causal, with the
prompt and summary pad hole), OPT-125M's (4, 640, 12, 64) causal and
CLIP's (24, 197, 12, 64), and at T5-base's encoder (4, 512, 12, 64) with
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
shape disagrees.
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
           for name in ("attention_shapes.cu", "bias_shapes.cu")]
RUN = 10        # calls back to back in a sample
SAMPLES = 10
# (B, Sq = Sk, H), causal, backward too
CASES = [((4, 2048, 16), True, True), ((4, 1024, 16), True, True),
         ((4, 640, 12), True, True), ((24, 197, 12), False, False)]
# T5-base: (name, (B, Sq, Sk, H), causal, bias), each without and with
# dropout 0.1 (the cross-attention, which has no bias, only with)
BIAS_CASES = [("enc", (4, 512, 512, 12), False, True),
              ("dec", (4, 128, 128, 12), True, True),
              ("cross", (4, 128, 512, 12), False, False)]
RATE = 0.1


def build():
    """The two sweep libraries, each source built by its own nvcc, both at
    once; prints each kernel's registers and any spills."""
    h = hashlib.sha256(_build._digest().encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    outs = [_build.BUILD_DIR / f"sweep_{src.stem}-{h.hexdigest()[:16]}.so"
            for src in SOURCES]
    todo = [(src, out) for src, out in zip(SOURCES, outs)
            if not out.exists()]
    if todo:
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        report = _build._run([[_build.find_nvcc(), *_build.NVCC_FLAGS,
                               "-shared", str(src), "-o", str(out)]
                              for src, out in todo])
        print("\n".join(line for line in report.splitlines()
                        if "Compiling entry" in line or "Used" in line
                        or "spill" in line
                        and " 0 bytes spill stores" not in line))
    lib, bias_lib = (ctypes.CDLL(str(out)) for out in outs)
    ptr, i32, f32, u32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                          ctypes.c_uint)
    lib.sweep_fwd.argtypes = [i32] + [ptr] * 7 + [i32] * 4 + [f32, i32, ptr]
    lib.sweep_bwd.argtypes = [i32] + [ptr] * 11 + [i32] * 4 + [f32, i32, ptr]
    tail = [i32] * 4 + [f32, i32, u32, f32, ptr]
    bias_lib.sweep_bias_fwd.argtypes = [i32] + [ptr] * 9 + tail
    bias_lib.sweep_bias_bwd.argtypes = [i32] + [ptr] * 14 + tail
    return lib, bias_lib


def inputs(b, s, h, seed, device):
    """q, k, v, dO (bf16) and a (B, S) int32 key mask: a prompt of S - S/16
    keys and a summary of S/16, each right-padded, so the valid keys have
    a hole (the decoder-only training batch)."""
    g = torch.Generator().manual_seed(seed)
    q, k, v, dout = (torch.randn(b, s, h, 64, generator=g).to(
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
    b, s, h = dims
    q, k, v, dout, mask = inputs(b, s, h, s + h, device)
    if not causal:
        mask = torch.ones_like(mask)
    scale = 64 ** -0.5
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
            err = lib.sweep_fwd(i, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                mask.data_ptr(), o2.data_ptr(), m2.data_ptr(),
                                l2.data_ptr(), b, s, s, h, scale, int(causal),
                                stream)
            if err:
                raise RuntimeError(f"forward shape {i}: CUDA error {err}")
        call()
        torch.cuda.synchronize()
        same[f"forward shape {i}"] = all(
            torch.equal(x, y) for x, y in ((o2, out), (m2, m), (l2, l)))
        fwd[f"forward shape {i}"] = call
    fwd["scaled_dot_product_attention"] = \
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am)
    result = {"shape": [b, s, h, 64], "causal": causal,
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
                    i, q.data_ptr(), k.data_ptr(), v.data_ptr(),
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
        same[f"forward shape {i}"] = all(
            torch.equal(x, y) for x, y in ((o2, out), (m2, m), (l2, l)))
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


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_attention: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"], capture_output=True,
        text=True).stdout.strip())
    lib, bias_lib = build()
    runs = [lambda c=c: sweep_case(lib, *c, device) for c in CASES]
    runs += [lambda c=c, r=r: sweep_bias_case(bias_lib, *c, r, device)
             for c in BIAS_CASES for r in ((0.0, RATE) if c[3] else (RATE,))]
    ok = True
    for run in runs:
        result = run()
        ok = ok and all(result["agrees_with_library"].values())
        print(json.dumps(result), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
