#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (mmgl_tpu_torch).

    python3 chip_smoke.py

Needs one NVIDIA Hopper GPU with nvcc (on PATH or in $CUDA_HOME/bin) and
imports no JAX. Phases, each fatal on failure:

  1. the card: CUDA visible, its name and power limit from nvidia-smi;
  2. build the kernels from mmgl_tpu_torch/csrc (time, ptxas report);
  3. each kernel against its plain version on the card, bf16 and fp32, with
     pad holes and fully masked rows: K1 and K2 forward and K3 (K1's
     backward) at the OPT shapes; K4 and K5 (forward and gradient) at
     T5-base's cross-attention, with an MQA head, and K7 with K8/K9 (dbias
     included) at T5-base's encoder, decoder and cross-attention shapes,
     each without and with dropout 0.1; ragged lengths for every kernel.
     The dropout mask K7 draws is read off its output, in bf16 and fp32,
     and compared with the plain version's bit for bit. At the encoder's
     shape with dropout, K7's row stats against the plain version's, and
     K8/K9 from them equal, bit for bit, to K8/K9 with its own stats pass;
  4. the OPT-125M + CLIP ViT-B/16 test pass at full width (task=section,
     context=all, raw neighbors, the --test pass of mmgl_tpu_torch.cli on
     the synthetic corpus with seeded random weights); K1 and K2 must launch
     in it. Then one sample's fp32 eval step on the card against the CPU;
  5. OPT training at the same width through the CLI (bf16, batch 4 x 4
     micro-batches, 4 updates, the val passes, the best checkpoint, the
     test pass on it restored): K1, K2 and K3 must launch inside the steps,
     losses and gradient norms be finite, every trainable tensor move and
     no tower tensor. Then one fp32 micro-step on the card against the CPU;
  6. the T5-base + CLIP test pass through the CLI (batch 4, 4 batches):
     every eval step launches K7 24 times (12 encoder, 12 decoder
     self-attention) and K4 12 times (cross), every generated batch K7 12
     times (the encoder) and K2 on every image (12 layers). Then one
     sample's fp32 eval step, card against CPU;
  7. T5-base training through the CLI (Adafactor, dropout 0.1, 4 updates of
     4 x 4): every micro-step launches K7 and K8/K9 36 times each; the
     checks of phase 5. Then one fp32 micro-step in eval mode (no dropout:
     K7, K8/K9, K4 and K5 on the card) against the CPU;
  8. every kernel timed (bf16, CUDA events over runs of 10 calls back to
     back) against its plain version and against the one PyTorch call that
     computes the same function (scaled_dot_product_attention with the bias
     and mask as a float attn_mask, and its backward), beside its bound:
     max(FLOPs / 989 TFLOP/s, bytes / 3.35 TB/s), each input read and each
     output written once, FLOPs over the pairs the masks leave (dropout's
     bits excluded); K8/K9 from K7's row stats, as training runs it; K4
     with its row stats, K6 and K5 also at OPT-350M's (4, 2048, 16, 64), K6
     and K5 again at (4, 1024, 16, 64);
  9. OPT-350M + CLIP training at OPT's whole 2048-token window through the
     CLI (--max_input_length 1920 --max_output_length 128, bf16, 4 updates
     of 4 x 4, AdamW) with the blocked backward selected (the module flag
     that MMGL_BLOCKED_BWD=1 sets at import), for this phase only: every update launches K4 and K6 96 times each (24 layers x 4
     micro-batches) and K1, K3 and K5 none; every eval step and every
     generated batch (its 1920-token prefill) K4 24 times; the checks of
     phase 5. Then one sample's fp32 micro-step in eval mode, K4 and K6
     against the plain versions on the card (the CPU would take too long).

Phase 3 also holds K4 with its row stats and K6 against their plain
versions at OPT-350M's shape with a pad hole and with a fully masked
sample, ragged and end-aligned sq < sk, and K6 against K5 at OPT-350M's
shape, bit for bit. The launch counts are set to 0 just before each path
and read just after. Every kernel has two bodies, tensor cores for bf16
and scalar FMAs for fp32: phases 4, 5, 6, 7 and 9 (bf16) check that every
launch of K1-K9 took the tensor-core body, and their fp32 checks that none
did.
Prints a kernels JSON line, then as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
fp32 comparisons run with TF32 off (cuBLAS and cuDNN), so the plain
versions compute in full fp32.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from functools import partial

OPT_TEST_ARGV = ["--model_name_or_path", "opt-125m", "--task", "section",
                 "--context", "all", "--neighbor_mode", "raw", "--test",
                 "true", "--bf16", "true", "--tokenizer_path", "byte:50272",
                 "--per_device_val_batch_size", "4", "--val_steps_per_epoch",
                 "4", "--seed", "0", "--device", "cuda"]
OPT_TRAIN_ARGV = ["--model_name_or_path", "opt-125m", "--task", "section",
                  "--context", "all", "--neighbor_mode", "raw",
                  "--bf16", "true", "--tokenizer_path", "byte:50272",
                  "--per_device_train_batch_size", "4",
                  "--grad_accumulation_steps", "4", "--steps_per_epoch", "16",
                  "--epochs", "1", "--per_device_val_batch_size", "4",
                  "--val_steps_per_epoch", "2", "--print_freq", "1",
                  "--seed", "0", "--device", "cuda"]
# T5-base: the same flags with its model name and its vocabulary
T5_TEST_ARGV = [a.replace("opt-125m", "t5-base").replace("byte:50272",
                                                         "byte:32128")
                for a in OPT_TEST_ARGV]
T5_TRAIN_ARGV = [a.replace("opt-125m", "t5-base").replace("byte:50272",
                                                          "byte:32128")
                 for a in OPT_TRAIN_ARGV]
# OPT-350M (post-LN, project_in/out) at its 2048-token position table
OPT350_TRAIN_ARGV = [a.replace("opt-125m", "opt-350m")
                     for a in OPT_TRAIN_ARGV] + [
    "--max_input_length", "1920", "--max_output_length", "128"]
TRAIN_UPDATES = 4
T5_LAYERS = 12
OPT350_LAYERS = 24

FWD_SOURCE = "mmgl_tpu_torch/csrc/attention_fwd.cu"
BWD_SOURCE = "mmgl_tpu_torch/csrc/attention_bwd.cu"
BIAS_FWD_SOURCE = "mmgl_tpu_torch/csrc/attention_bias_fwd.cu"
BIAS_BWD_SOURCE = "mmgl_tpu_torch/csrc/attention_bias_bwd.cu"
BLOCKED_SOURCE = "mmgl_tpu_torch/csrc/attention_blocked_bwd.cu"
PALLAS = "mmgl_tpu/ops/flash_attention.py"
# kernel wrapper -> (its plain version, the Pallas kernel it replaces, source)
KERNELS = {
    "flash_attention_allheads": ("allheads_attention_reference",
                                 f"{PALLAS}:1283", FWD_SOURCE),
    "fused_heads_attention": ("fused_heads_attention_reference",
                              f"{PALLAS}:1152", FWD_SOURCE),
    "flash_attention_allheads_bwd": ("allheads_attention_bwd_reference",
                                     f"{PALLAS}:1307", BWD_SOURCE),
    "flash_attention": ("flash_attention_reference", f"{PALLAS}:179",
                        FWD_SOURCE),
    "flash_attention_bwd": ("flash_attention_bwd_reference", f"{PALLAS}:457",
                            BWD_SOURCE),
    "flash_attention_blocked_bwd": ("flash_attention_blocked_bwd_reference",
                                    f"{PALLAS}:336", BLOCKED_SOURCE),
    "flash_attention_bias": ("bias_attention_reference", f"{PALLAS}:768",
                             BIAS_FWD_SOURCE),
    "flash_attention_bias_bwd": ("bias_attention_bwd_reference",
                                 f"{PALLAS}:942", BIAS_BWD_SOURCE),
}
BIAS_KERNELS = ("flash_attention_bias", "flash_attention_bias_bwd")
# the bf16 bodies the kernels line names (every timed case is bf16)
DESIGNS = {"tc": "bf16 tensor cores: mma.sync m16n8k16, fp32 accumulators, "
                 "64 x 64 tiles, 4 warps of 16 rows, 2-stage cp.async ring",
           "bias_tc": "the same bodies in their bias form: the bias tile in "
                      "the cp.async ring, Philox dropout on the P fragment "
                      "(one call a lane per 16 keys, words swapped by a "
                      "shuffle), K8/K9 from K7's row stats, dlogits into "
                      "an fp32 partial reduced over the batch in order"}
OPT_TEST_KERNELS = ("flash_attention_allheads", "fused_heads_attention")
OPT_TRAIN_KERNELS = OPT_TEST_KERNELS + ("flash_attention_allheads_bwd",)
# the OPT attention calls: (kernel, (B, S, H, D), causal, mask)
CASES = [
    ("flash_attention_allheads", (4, 640, 12, 64), True, "hole"),   # eval
    ("flash_attention_allheads", (4, 512, 12, 64), True, "prompt"),  # prefill
    ("fused_heads_attention", (24, 197, 12, 64), False, "ones"),    # CLIP
    ("flash_attention_allheads", (4, 640, 12, 64), False, "fully_masked"),
    ("fused_heads_attention", (24, 197, 12, 64), False, "fully_masked"),
]
# K3 (the training step's attention backward): ((B, S, H, D), causal, mask);
# the training shape, the same with a fully masked sample, and a ragged
# length whose tiles the bounds checks cut
BWD_CASES = [((4, 640, 12, 64), True, "hole"),
             ((4, 640, 12, 64), True, "hole_fully_masked"),
             ((3, 333, 2, 64), True, "hole333")]
# K4/K5: ((B, Sq, Sk, H, K/V heads), causal, key mask): T5-base's eval
# cross-attention over the padded encoder input, MQA, ragged lengths
FLASH_CASES = [((4, 128, 512, 12, 12), False, "gap"),
               ((4, 128, 128, 12, 1), False, "gap"),
               ((3, 333, 77, 2, 2), False, "gap_fully_masked")]
# K4 with its row stats and K6: ((B, Sq, Sk, H), causal, key mask):
# OPT-350M's training shape (prompt 1920 + summary 128, a pad hole in each),
# the same with a fully masked sample, ragged, end-aligned sq < sk
BLOCKED_CASES = [((4, 2048, 2048, 16), True, "hole"),
                 ((4, 2048, 2048, 16), True, "hole_fully_masked"),
                 ((3, 333, 333, 2), True, "hole333"),
                 ((2, 200, 328, 2), True, "gap")]
# K7/K8/K9: (name, (B, Sq, Sk, H), causal, bias): T5-base's encoder, decoder
# self- and training cross-attention, ragged lengths; each without and with
# dropout 0.1, T5's scale 1.0
BIAS_CASES = [("enc", (4, 512, 512, 12), False, True),
              ("dec", (4, 128, 128, 12), True, True),
              ("cross", (4, 128, 512, 12), False, False),
              ("ragged", (3, 333, 333, 2), True, True)]
RATE = 0.1
# (atol, rtol) by dtype name
TOLERANCES = {"bfloat16": (2e-2, 2e-2), "float32": (2e-5, 0.0)}
# backward, per gradient: (atol as a fraction of its largest entry, rtol);
# bf16: P (times the keep factor) and dS rounded to bf16 before their
# products from logits summed in another order, in the tensor-core bodies
# and the plain versions alike
BWD_TOLERANCES = {"bfloat16": (2e-2, 2e-2), "float32": (1e-5, 0.0)}
# K4's row max and sum, (atol, rtol) in either dtype: fp32 sums of up to
# 2048 exponentials in another order
STATS_TOLERANCES = (1e-4, 1e-4)
# whole-model fp32 check, card vs CPU: logits and loss
MODEL_ATOL = 1e-3
# fp32 training micro-step, card vs CPU: (loss atol, gradient-norm rtol,
# largest gradient error as a fraction of the largest gradient); sums over
# hundreds of tokens through 12 layers in another order; a wrong kernel is
# off by the gradient's own size. T5's random-init gradient moves more
# under reordered sums: its plain versions on the card differ from the CPU
# by 1.1e-2 of a largest gradient of 2.3 and by 8e-4 in norm (on an H100
# 80GB HBM3 at 700 W), so its bound is wider, and its kernels are also held
# to twice the plain versions' own error on the card
STEP_TOL = (1e-3, 1e-4, 1e-3)
T5_STEP_TOL = (1e-3, 5e-3, 1e-2)
# phase 8: calls back to back in one timed sample
TIMING_RUN = 10
# H100 SXM data-sheet peaks (dense bf16, HBM3)
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def make_mask(kind: str, b: int, s: int, seed: int):
    """(B, S) int32 key mask. "hole": a decoder-only batch, prompt padded to
    S - 128 then summary padded to 128, so the valid keys have a hole
    ("hole333": the same at S = 333, prompt 250); "prompt": right-padded
    prompts; "gap": a pad hole in the middle and right padding, any S;
    "fully_masked": sample 0 all zero (with holes in the others for
    "hole_fully_masked" and "gap_fully_masked")."""
    import numpy as np

    rng = np.random.RandomState(seed)
    mask = np.ones((b, s), np.int32)
    if kind == "hole":
        cut = s - 128
        for i in range(b):
            mask[i, rng.randint(100, cut):cut] = 0
            mask[i, cut + rng.randint(20, 128):] = 0
    elif kind == "prompt":
        for i in range(b):
            mask[i, rng.randint(100, s):] = 0
    elif kind == "hole333":
        for i in range(b):
            mask[i, rng.randint(50, 250):250] = 0
            mask[i, 250 + rng.randint(1, 83):] = 0
    elif kind == "gap":
        for i in range(b):
            mask[i, rng.randint(s // 5, s // 2):s // 2] = 0
            mask[i, s - rng.randint(1, max(2, s // 8)):] = 0
    elif kind in ("hole_fully_masked", "gap_fully_masked"):
        mask = make_mask(kind.split("_")[0], b, s, seed)
        mask[0] = 0
    elif kind == "fully_masked":
        mask[0] = 0
    return mask


def kernel_inputs(case_index: int, dtype, device):
    import torch

    _, shape, causal, mask_kind = CASES[case_index]
    g = torch.Generator().manual_seed(case_index)
    q, k, v = (torch.randn(shape, generator=g).to(device=device, dtype=dtype)
               for _ in range(3))
    mask = torch.from_numpy(make_mask(mask_kind, shape[0], shape[1],
                                      case_index)).to(device)
    return (q, k, v), dict(kv_mask=mask, causal=causal)


def bwd_inputs(case_index: int, dtype, device):
    """K3's inputs: q, k, v, the mask, the forward output (plain version)
    and a random cotangent."""
    import torch
    from mmgl_tpu_torch.ops import flash_attention as fa

    shape, causal, mask_kind = BWD_CASES[case_index]
    g = torch.Generator().manual_seed(100 + case_index)
    q, k, v, dout = (torch.randn(shape, generator=g).to(device=device,
                                                         dtype=dtype)
                     for _ in range(4))
    mask = torch.from_numpy(make_mask(mask_kind, shape[0], shape[1],
                                      case_index)).to(device)
    out = fa.allheads_attention_reference(q, k, v, kv_mask=mask,
                                          causal=causal)
    return (q, k, v, mask, out, dout), dict(causal=causal)


def reset_launches(fa) -> None:
    """Every wrapper's launch counts to 0."""
    for name in KERNELS:
        getattr(fa, name).launches = 0
        getattr(fa, name).launches_tc = 0


def check_bodies(fa, tag: str, bf16: bool):
    """Every kernel launch since the counts were reset took the
    tensor-core body (bf16) or none did (fp32); returns {name: (launches,
    tensor-core launches)}."""
    counts = {n: (getattr(fa, n).launches, getattr(fa, n).launches_tc)
              for n in KERNELS}
    print(f"[{tag}] K1-K9 launches (all, tensor-core body): {counts}")
    wrong = {n: c for n, c in counts.items() if c[1] != (c[0] if bf16 else 0)}
    if wrong:
        fail(f"{tag}: kernel launches took the "
             f"{'scalar' if bf16 else 'tensor-core'} body: {wrong}")
    return counts


def _within(got, ref, atol, rtol) -> bool:
    import torch

    err = (got.float() - ref.float()).abs()
    return (got.dtype == ref.dtype and got.shape == ref.shape
            and bool(torch.isfinite(got).all())
            and bool((err <= atol + rtol * ref.float().abs()).all()))


def _grads_within(name, got, ref, dtype_name, label, worst):
    """Each gradient against its plain version at the backward tolerance;
    records the worst error under ``name``; returns the report."""
    atol, rtol = BWD_TOLERANCES[dtype_name]
    report = []
    for grad, g, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
        if r is None:
            continue
        max_err = float((g.float() - r.float()).abs().max())
        ok = _within(g, r, atol * float(r.float().abs().max()), rtol)
        report.append(f"{grad} {max_err:.3e}{'' if ok else ' FAIL'}")
        worst[name] = max(worst[name], max_err)
        if not ok:
            print(f"[check] {name} {label} {dtype_name}: {', '.join(report)}")
            fail(f"{name} {grad} disagrees with its plain version")
    return ", ".join(report)


def check_opt_kernels(fa, device, worst):
    """Phase 3, K1-K3: each case in each dtype."""
    import torch

    for i, (name, shape, causal, mask_kind) in enumerate(CASES):
        kernel = getattr(fa, name)
        plain = getattr(fa, KERNELS[name][0])
        for dtype_name, (atol, rtol) in TOLERANCES.items():
            args, kw = kernel_inputs(i, getattr(torch, dtype_name), device)
            got = kernel(*args, **kw)
            torch.cuda.synchronize(device)
            ref = plain(*args, **kw)
            max_err = float((got.float() - ref.float()).abs().max())
            ok = _within(got, ref, atol, rtol)
            print(f"[check] {name} {shape} causal={causal} mask={mask_kind} "
                  f"{dtype_name}: max_abs_err={max_err:.3e} atol={atol:g} "
                  f"rtol={rtol:g} {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"{name} disagrees with its plain version")
            worst[name] = max(worst[name], max_err)
    name = "flash_attention_allheads_bwd"
    for i, (shape, causal, mask_kind) in enumerate(BWD_CASES):
        for dtype_name in BWD_TOLERANCES:
            args, kw = bwd_inputs(i, getattr(torch, dtype_name), device)
            got = fa.flash_attention_allheads_bwd(*args, **kw)
            torch.cuda.synchronize(device)
            ref = fa.allheads_attention_bwd_reference(*args, **kw)
            label = f"{shape} causal={causal} mask={mask_kind}"
            report = _grads_within(name, got, ref, dtype_name, label, worst)
            print(f"[check] {name} {label} {dtype_name}: max_abs_err "
                  f"{report} ok")


def flash_inputs(dims, mask_kind, dtype, device, seed):
    """q, k, v (k/v with kv_heads heads), the key mask, a cotangent."""
    import torch

    b, sq, sk, h, kvh = dims
    g = torch.Generator().manual_seed(seed)
    q, dout = (torch.randn(b, sq, h, 64, generator=g) for _ in range(2))
    k, v = (torch.randn(b, sk, kvh, 64, generator=g) for _ in range(2))
    mask = torch.from_numpy(make_mask(mask_kind, b, sk, seed)).to(device)
    q, k, v, dout = (t.to(device, dtype) for t in (q, k, v, dout))
    return q, k, v, mask, dout


def bias_inputs(dims, with_bias, dtype, device, seed):
    """q (T5's scale folded in: x 1/8), k, v, a key mask with a pad hole and
    a fully masked sample, the (1, H, Sq, Sk) bias or None, a cotangent, and
    a dropout key."""
    import torch

    b, sq, sk, h = dims
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, sq, h, 64, generator=g) * 0.125
    k, v = (torch.randn(b, sk, h, 64, generator=g) for _ in range(2))
    dout = torch.randn(b, sq, h, 64, generator=g)
    bias = (torch.randn(1, h, sq, sk, generator=g) if with_bias else None)
    mask = torch.from_numpy(make_mask("gap_fully_masked", b, sk,
                                      seed)).to(device)
    seed_t = torch.tensor([seed * 7919 + 1, 2 ** 32 - seed - 1],
                          dtype=torch.int64, device=device)
    q, k, v, dout = (t.to(device, dtype) for t in (q, k, v, dout))
    if bias is not None:
        bias = bias.to(device, dtype)
    return q, k, v, mask, bias, dout, seed_t


def check_t5_kernels(fa, device, worst):
    """Phase 3, K4/K5 and K7/K8/K9: forward and gradients (through autograd,
    so the backward kernels run as training runs them) against the plain
    versions; the dropout mask bit for bit."""
    import torch

    for i, (dims, causal, mask_kind) in enumerate(FLASH_CASES):
        b, sq, sk, h, kvh = dims
        for dtype_name, (atol, rtol) in TOLERANCES.items():
            q, k, v, mask, dout = flash_inputs(
                dims, mask_kind, getattr(torch, dtype_name), device, 200 + i)
            q, k, v = (t.requires_grad_() for t in (q, k, v))
            got = fa.flash_attention(q, k, v, kv_mask=mask, causal=causal)
            grads = torch.autograd.grad(got, (q, k, v), dout)
            torch.cuda.synchronize(device)
            kx, vx = (t.detach().expand(b, sk, h, 64).contiguous()
                      for t in (k, v))
            ref = fa.flash_attention_reference(q.detach(), kx, vx,
                                               kv_mask=mask, causal=causal)
            max_err = float((got.detach().float() - ref.float()).abs().max())
            worst["flash_attention"] = max(worst["flash_attention"], max_err)
            if not _within(got.detach(), ref, atol, rtol):
                fail(f"flash_attention {dims} {dtype_name} disagrees with "
                     f"its plain version ({max_err:.3e})")
            refs = list(fa.flash_attention_bwd_reference(
                q.detach(), kx, vx, mask, got.detach(), dout, causal=causal))
            if kvh == 1:   # expand's gradient: the sum over the heads
                refs[1:] = [r.float().sum(2, keepdim=True).to(r.dtype)
                            for r in refs[1:]]
            label = f"{dims} causal={causal} mask={mask_kind}"
            report = _grads_within("flash_attention_bwd", grads, refs,
                                   dtype_name, label, worst)
            print(f"[check] flash_attention {label} {dtype_name}: forward "
                  f"{max_err:.3e} ok; flash_attention_bwd {report} ok")

    for i, (tag, dims, causal, with_bias) in enumerate(BIAS_CASES):
        for rate in (0.0, RATE):
            for dtype_name, (atol, rtol) in TOLERANCES.items():
                q, k, v, mask, bias, dout, seed = bias_inputs(
                    dims, with_bias, getattr(torch, dtype_name), device,
                    300 + i)
                wrt = [q, k, v] + ([bias] if with_bias else [])
                for t in wrt:
                    t.requires_grad_()
                got = fa.flash_attention_bias(
                    q, k, v, bias=bias, kv_mask=mask, causal=causal,
                    scale=1.0, dropout_rate=rate, dropout_seed=seed)
                grads = list(torch.autograd.grad(got, wrt, dout))
                torch.cuda.synchronize(device)
                plain_bias = None if bias is None else bias.detach()
                ref = fa.bias_attention_reference(
                    q.detach(), k.detach(), v.detach(), bias=plain_bias,
                    kv_mask=mask, causal=causal, scale=1.0,
                    dropout_rate=rate, dropout_seed=seed)
                max_err = float((got.detach().float()
                                 - ref.float()).abs().max())
                worst["flash_attention_bias"] = max(
                    worst["flash_attention_bias"], max_err)
                if not _within(got.detach(), ref, atol, rtol):
                    fail(f"flash_attention_bias {tag} {dims} rate={rate} "
                         f"{dtype_name} disagrees with its plain version "
                         f"({max_err:.3e})")
                refs = fa.bias_attention_bwd_reference(
                    q.detach(), k.detach(), v.detach(), mask, plain_bias,
                    got.detach(), dout, causal=causal, scale=1.0,
                    dropout_rate=rate, dropout_seed=seed)
                label = (f"{tag} {dims} causal={causal} bias={with_bias} "
                         f"dropout={rate}")
                report = _grads_within("flash_attention_bias_bwd", grads,
                                       refs, dtype_name, label, worst)
                print(f"[check] flash_attention_bias {label} {dtype_name}: "
                      f"forward {max_err:.3e} ok; flash_attention_bias_bwd "
                      f"{report} ok")
    keep = {}
    for tag, dims, _, _ in BIAS_CASES:
        for dtype_name in TOLERANCES:
            keep[f"{tag} {dtype_name}"] = check_dropout_mask(
                fa, dims, device, getattr(torch, dtype_name))
    check_bias_stats_path(fa, device, worst)
    return keep


def check_bias_stats_path(fa, device, worst):
    """Phase 3, at the encoder's shape with dropout, bf16: K7's row stats
    against the plain version's, and K8/K9 from them (as training runs it)
    equal to K8/K9 with its own stats pass, bit for bit: the stats-only pass
    computes K7's max and sum with K7's instructions."""
    import torch

    tag, dims, causal, with_bias = BIAS_CASES[0]
    q, k, v, mask, bias, dout, seed = bias_inputs(
        dims, with_bias, torch.bfloat16, device, 300)
    kw = dict(kv_mask=mask, causal=causal, scale=1.0, dropout_rate=RATE,
              dropout_seed=seed)
    out, m, l = fa.flash_attention_bias_stats(q, k, v, bias=bias, **kw)
    torch.cuda.synchronize(device)
    ref = fa.bias_attention_reference(q, k, v, bias=bias, with_stats=True,
                                      **kw)
    errs = [float((g.float() - r.float()).abs().max())
            for g, r in zip((out, m, l), ref)]
    worst["flash_attention_bias"] = max(worst["flash_attention_bias"],
                                        errs[0])
    label = f"{tag} {dims} bias dropout={RATE} bfloat16"
    if not (_within(out, ref[0], *TOLERANCES["bfloat16"])
            and _within(m, ref[1], *STATS_TOLERANCES)
            and _within(l, ref[2], *STATS_TOLERANCES)):
        fail(f"flash_attention_bias_stats {label} disagrees with its plain "
             f"version (out {errs[0]:.3e}, max {errs[1]:.3e}, sum "
             f"{errs[2]:.3e})")
    bkw = dict(causal=causal, scale=1.0, dropout_rate=RATE,
               dropout_seed=seed)
    saved = fa.flash_attention_bias_bwd(q, k, v, mask, bias[0], out, dout,
                                        row_max=m, row_sum=l, **bkw)
    own = fa.flash_attention_bias_bwd(q, k, v, mask, bias[0], out, dout,
                                      **bkw)
    torch.cuda.synchronize(device)
    for name, g, r in zip(("dq", "dk", "dv", "dbias"), saved, own):
        if not torch.equal(g, r):
            fail(f"K8/K9 from K7's stats differs from K8/K9 with its stats "
                 f"pass in {name} at {label} (max abs "
                 f"{float((g.float() - r.float()).abs().max()):.3e})")
    print(f"[check] flash_attention_bias_stats {label}: out {errs[0]:.3e}, "
          f"max {errs[1]:.3e}, sum {errs[2]:.3e} ok; flash_attention_bias_bwd"
          f" from them equal to its own stats pass bit for bit")


def blocked_inputs(case_index: int, dtype, device):
    """K4/K6's inputs at BLOCKED_CASES[i]: q, k, v, the key mask, a
    cotangent."""
    (b, sq, sk, h), _, mask_kind = BLOCKED_CASES[case_index]
    return flash_inputs((b, sq, sk, h, h), mask_kind, dtype, device,
                        400 + case_index)


def check_blocked_kernels(fa, device, worst):
    """Phase 3, K4 with its row stats and K6: the output and stats against
    the plain version's, K6 (from the kernel's output and stats) against
    its plain version on the same inputs, and at OPT-350M's shape K6
    against K5, which computes the same gradient with a stats pass."""
    import torch

    for i, (dims, causal, mask_kind) in enumerate(BLOCKED_CASES):
        label = f"{dims} causal={causal} mask={mask_kind}"
        for dtype_name, (atol, rtol) in TOLERANCES.items():
            q, k, v, mask, dout = blocked_inputs(i, getattr(torch, dtype_name),
                                                 device)
            out, m, l = fa.flash_attention_stats(q, k, v, kv_mask=mask,
                                                 causal=causal)
            torch.cuda.synchronize(device)
            ref = fa.flash_attention_reference(q, k, v, kv_mask=mask,
                                               causal=causal, with_stats=True)
            max_err = float((out.float() - ref[0].float()).abs().max())
            s_atol, s_rtol = STATS_TOLERANCES
            stats_err = [float((g - r).abs().max())
                         for g, r in zip((m, l), ref[1:])]
            worst["flash_attention[stats]"] = max(
                worst["flash_attention[stats]"], max_err, *stats_err)
            if not (_within(out, ref[0], atol, rtol)
                    and _within(m, ref[1], s_atol, s_rtol)
                    and _within(l, ref[2], s_atol, s_rtol)):
                fail(f"flash_attention_stats {label} {dtype_name} disagrees "
                     f"with its plain version (out {max_err:.3e}, max "
                     f"{stats_err[0]:.3e}, sum {stats_err[1]:.3e})")
            del ref
            got = fa.flash_attention_blocked_bwd(q, k, v, mask, out, dout, m,
                                                 l, causal=causal)
            torch.cuda.synchronize(device)
            refs = fa.flash_attention_blocked_bwd_reference(
                q, k, v, mask, out, dout, m, l, causal=causal)
            report = _grads_within("flash_attention_blocked_bwd", got, refs,
                                   dtype_name, label, worst)
            line = (f"[check] flash_attention_stats {label} {dtype_name}: "
                    f"out {max_err:.3e}, max {stats_err[0]:.3e}, sum "
                    f"{stats_err[1]:.3e} ok; flash_attention_blocked_bwd "
                    f"{report} ok")
            del refs
            if i == 0:
                # the same gradient: K5's stats pass computes K4's max and
                # sum with K4's code, and both run the same delta and tile
                # kernels, so bit for bit
                k5 = fa.flash_attention_bwd(q, k, v, mask, out, dout,
                                            causal=causal)
                torch.cuda.synchronize(device)
                errs = []
                for name, g, r in zip(("dq", "dk", "dv"), got, k5):
                    errs.append(float((g.float() - r.float()).abs().max()))
                    if not torch.equal(g, r):
                        fail(f"K6's {name} differs from K5's at {label} "
                             f"{dtype_name} (max abs {errs[-1]:.3e})")
                line += (f"; against flash_attention_bwd (K5): equal bit "
                         f"for bit (max abs {', '.join(f'{e:g}' for e in errs)})")
                del k5
            print(line)
            del q, k, v, mask, dout, out, m, l, got
    torch.cuda.empty_cache()


def kernel_keep_mask(fa, b, sq, sk, h, seed, device, dtype):
    """(B, H, Sq, Sk) bool: the elements K7 keeps, read off its output (in
    ``dtype``: bf16 runs the tensor-core body, fp32 the scalar one). With
    q = 0 and one 64-key window unmasked, P is 1/64 on the window's keys,
    and with v the identity on the window, out[..., d] is the keep factor
    of key window + d over 64: zero exactly where it was dropped."""
    import torch

    q = torch.zeros(b, sq, h, 64, device=device, dtype=dtype)
    keep = torch.zeros(b, h, sq, sk, dtype=torch.bool, device=device)
    for w0 in range(0, sk, 64):
        n = min(64, sk - w0)
        mask = torch.zeros(b, sk, dtype=torch.int32, device=device)
        mask[:, w0:w0 + n] = 1
        v = torch.zeros(b, sk, h, 64, device=device, dtype=dtype)
        v[:, w0:w0 + n, :, :n] = torch.eye(n, device=device)[:, None, :]
        out = fa.flash_attention_bias(q, torch.zeros_like(v), v,
                                      kv_mask=mask, scale=1.0,
                                      dropout_rate=RATE, dropout_seed=seed)
        keep[..., w0:w0 + n] = (out[..., :n] > 0).permute(0, 2, 1, 3)
    return keep


def check_dropout_mask(fa, dims, device, dtype) -> float:
    """K7's kept elements equal the plain version's bits exactly; returns
    the kept fraction (0.9 expected, within 6 sigma)."""
    import torch
    from mmgl_tpu_torch.ops import attention as att

    b, sq, sk, h = dims
    seed = torch.tensor([sq * 1000003 + sk, 7], dtype=torch.int64,
                        device=device)
    got = kernel_keep_mask(fa, b, sq, sk, h, seed, device, dtype)
    want = att.dropout_bits(seed, (b, h, sq, sk)) < att.dropout_threshold(
        RATE)[0]
    frac = float(got.float().mean())
    sigma = (RATE * (1 - RATE) / got.numel()) ** 0.5
    same = bool(torch.equal(got, want))
    print(f"[check] dropout mask of flash_attention_bias {dims} {dtype}: "
          f"{'equal to' if same else 'DIFFERS from'} the plain version's "
          f"bit for bit; kept fraction {frac:.6f} (0.9 +- 6 sigma = "
          f"{6 * sigma:.2e})")
    if not same or abs(frac - (1 - RATE)) > 6 * sigma:
        fail(f"the dropout mask of flash_attention_bias at {dims} is wrong")
    return frac


class LaunchTally:
    """Launches of each kernel inside calls of a wrapped function."""

    def __init__(self, fa, names):
        self.fa, self.names, self.calls = fa, names, []

    def wrap(self, fn):
        def counted(*a, **kw):
            before = {n: getattr(self.fa, n).launches for n in self.names}
            out = fn(*a, **kw)
            self.calls.append({n: getattr(self.fa, n).launches - before[n]
                               for n in self.names})
            return out
        return counted


def run_test_pass(cli, fa, device, argv, kernels, per_eval=None,
                  per_generate=None, tag="opt"):
    """Phases 4 and 6: the --test pass at full width; the kernels must
    launch, and, where given, exactly per_eval / per_generate times in each
    eval step / generated batch. Returns (the test pass, results, launches,
    sections/s after the warm-up batch, peak bytes)."""
    import torch

    args, dev = cli.parse_cli(argv)
    test = cli.prepare(args, dev)
    vocab = (test.fcfg.opt or test.fcfg.t5).vocab_size
    shapes = []
    evals, gens = LaunchTally(fa, KERNELS), LaunchTally(fa, KERNELS)
    test.eval_step = evals.wrap(test.eval_step)
    generate_fn = gens.wrap(test.generate_fn)

    def generate(batch):
        ids = generate_fn(batch)
        shapes.append(tuple(ids.shape))
        if not bool(((ids >= 0) & (ids < vocab)).all()):
            fail("generated ids outside the vocabulary")
        return ids

    test.generate_fn = generate
    batches = []

    def log(scalars, step):
        if "test/batch_seconds" in scalars:
            batches.append((scalars["test/batch_seconds"],
                            scalars["test/batch_sections"]))

    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches(fa)
    results = cli.evaluate_loop(test, args, args.start_epoch, log,
                                prefix="test")
    launches = {name: getattr(fa, name).launches for name in KERNELS}
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    check_bodies(fa, f"{tag} test", bf16=True)

    print(f"[{tag} test] results: {json.dumps(results, sort_keys=True)}")
    print(f"[{tag} test] launches: {launches}; generated shapes: {shapes}")
    print(f"[{tag} test] per eval step: {evals.calls}")
    print(f"[{tag} test] per generated batch: {gens.calls}")
    if not math.isfinite(results["loss"]):
        fail(f"test loss is not finite: {results['loss']}")
    if not shapes or any(s != (4, cli.MAX_NEW_TOKENS) for s in shapes):
        fail(f"generated ids have shapes {shapes}, expected (4, 32)")
    for name in kernels:
        if launches[name] <= 0:
            fail(f"{name} was not launched by the {tag} test pass")
    for want, calls, what in ((per_eval, evals.calls, "eval step"),
                              (per_generate, gens.calls, "generated batch")):
        if want is not None and any(
                {n: c[n] for n in want} != want for c in calls):
            fail(f"the {tag} {what} launched {calls}, expected {want} each")
    timed = batches[1:]                    # the first batch is the warm-up
    if not timed:
        fail("the test pass ran fewer than two batches")
    rate = sum(n for _, n in timed) / sum(t for t, _ in timed)
    print(f"[{tag} test] {rate:.3f} sections/s over {len(timed)} batches "
          f"after one warm-up batch (batch seconds "
          f"{[round(t, 4) for t, _ in batches]}); peak device memory {peak} "
          f"bytes ({peak / 2**30:.3f} GiB)")
    return test, results, launches, rate, peak


def check_model_fp32(cli, fa, test, device, argv, tag):
    """Phases 4b and 6b: one sample's fp32 eval step through the kernels on
    the card (their scalar bodies) against the same seeded model on the CPU
    (plain versions)."""
    import torch
    from mmgl_tpu_torch.models.factory import build_model
    from mmgl_tpu_torch.train.steps import losses_of

    args, _ = cli.parse_cli(argv + ["--bf16", "false"])
    batch = next(iter(test.loader))
    batch = {k: v[:1] for k, v in batch.items()}
    out = {}
    for dev in (device, torch.device("cpu")):
        model, _ = build_model(args, dev,
                               vocab_size=test.tokenizer.vocab_size,
                               tokenizer=test.tokenizer)
        reset_launches(fa)
        with torch.no_grad():
            fused = model.eval()(batch)
        if dev.type == "cuda":
            check_bodies(fa, f"{tag} model fp32", bf16=False)
        out[dev.type] = (fused["logits"].float().cpu(),
                         float(losses_of(fused, test.fcfg.decoder_only,
                                         args.max_input_length,
                                         test.tokenizer.pad_token_id)[0]))
        del model, fused
    err = float((out["cuda"][0] - out["cpu"][0]).abs().max())
    loss_err = abs(out["cuda"][1] - out["cpu"][1])
    print(f"[{tag} model] fp32 eval, card vs CPU, one sample: logits "
          f"{tuple(out['cpu'][0].shape)} max_abs_err={err:.3e}, loss "
          f"{out['cuda'][1]:.6f} vs {out['cpu'][1]:.6f} (atol={MODEL_ATOL:g})")
    if not (err <= MODEL_ATOL and loss_err <= MODEL_ATOL):
        fail(f"the fp32 {tag} model on the card disagrees with the CPU")
    return {"max_abs_logit_err": err, "loss": [out["cuda"][1],
                                               out["cpu"][1]]}


def run_training(cli, fa, device, log_dir: str, argv, kernels,
                 per_update=None, tag="opt", per_eval=None,
                 per_generate=None):
    """Phases 5, 7 and 9: the training run at full width through the entry
    point; ``kernels`` must launch inside the training steps, exactly
    ``per_update`` times in each update where given, and ``per_eval`` /
    ``per_generate`` times in each eval step (val and test) / generated
    batch.

    The CLI's model factory, train step, eval setup and checkpoint restore
    are wrapped here, not changed: the wrappers snapshot the weights, time
    each update to a device synchronize and count the kernel launches inside
    it and inside each eval step and generated batch, and record the final
    restore. Returns a summary dict."""
    import torch

    args, dev = cli.parse_cli(argv + ["--log_dir", log_dir])
    seen = {"steps": [], "restores": [], "merges": 0, "rates": []}
    evals, gens = LaunchTally(fa, KERNELS), LaunchTally(fa, KERNELS)
    originals = {name: getattr(cli, name) for name in (
        "build_model", "make_train_step", "restore_checkpoint",
        "merge_restored_params", "_eval_setup")}

    def build_model(*a, **kw):
        model, cfg = originals["build_model"](*a, **kw)
        seen["model"] = model
        seen["before"] = {n: p.detach().clone()
                          for n, p in model.named_parameters()}
        return model, cfg

    def make_train_step(*a, **kw):
        step = originals["make_train_step"](*a, **kw)

        def counted(batch, generator=None):
            before = {n: getattr(fa, n).launches for n in KERNELS}
            torch.cuda.synchronize(device)
            start = time.perf_counter()
            metrics = step(batch, generator)
            torch.cuda.synchronize(device)
            seen["steps"].append({
                "seconds": time.perf_counter() - start,
                "sections": int(batch["input_ids"].shape[0]),
                "launches": {n: getattr(fa, n).launches - before[n]
                             for n in KERNELS},
                **{k: float(v) for k, v in metrics.items()}})
            return metrics

        return counted

    def eval_setup(*a, **kw):
        setup = originals["_eval_setup"](*a, **kw)
        setup.eval_step = evals.wrap(setup.eval_step)
        setup.generate_fn = gens.wrap(setup.generate_fn)
        return setup

    def restore_checkpoint(path):
        ckpt = originals["restore_checkpoint"](path)
        seen["restores"].append((path, ckpt))
        return ckpt

    def merge_restored_params(model, params):
        originals["merge_restored_params"](model, params)
        seen["merges"] += 1

    def log(scalars, step):
        if "metrics/examples_per_sec" in scalars:
            seen["rates"].append(scalars["metrics/examples_per_sec"])

    wrappers = {"build_model": build_model,
                "make_train_step": make_train_step,
                "restore_checkpoint": restore_checkpoint,
                "merge_restored_params": merge_restored_params,
                "_eval_setup": eval_setup}
    for name, fn in wrappers.items():
        setattr(cli, name, fn)
    try:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        reset_launches(fa)
        results = cli.run(args, dev, log)
        launches = {name: getattr(fa, name).launches for name in KERNELS}
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
    finally:
        for name, fn in originals.items():
            setattr(cli, name, fn)
    bodies = check_bodies(fa, f"{tag} train", bf16=True)

    steps = seen["steps"]
    in_steps = {n: sum(s["launches"][n] for s in steps) for n in KERNELS}
    print(f"[{tag} train] results: {json.dumps(results, sort_keys=True)}")
    for i, st in enumerate(steps):
        print(f"[{tag} train] update {i + 1}: loss {st['loss']:.6f} "
              f"summary_loss {st['summary_loss']:.6f} grad_norm "
              f"{st['grad_norm']:.6f} {st['seconds']:.4f} s; launches "
              f"{st['launches']}")
    print(f"[{tag} train] launches in the run {launches}, inside the "
          f"training steps {in_steps}")
    if len(steps) != TRAIN_UPDATES or results["train_updates"] != len(steps):
        fail(f"{len(steps)} training updates, expected {TRAIN_UPDATES}")
    for name in kernels:
        if launches[name] <= 0 or in_steps[name] <= 0:
            fail(f"{name} was not launched inside the {tag} training steps")
    if per_update is not None and any(
            {n: s["launches"][n] for n in per_update} != per_update
            for s in steps):
        fail(f"the {tag} updates launched {[s['launches'] for s in steps]},"
             f" expected {per_update} each")
    for want, calls, what in ((per_eval, evals.calls, "eval step"),
                              (per_generate, gens.calls, "generated batch")):
        if want is None:
            continue
        got = [{n: c[n] for n in want} for c in calls]
        print(f"[{tag} train] launches per {what} ({len(calls)}): {got}")
        if not calls or any(g != want for g in got):
            fail(f"the {tag} {what}s launched {got}, expected {want} each")
    values = [st[k] for st in steps
              for k in ("loss", "summary_loss", "grad_norm")]
    if not all(math.isfinite(v) for v in values + [results["loss"]]):
        fail(f"a training loss or gradient norm is not finite: {values}")

    model, before = seen["model"], seen["before"]
    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    params = dict(model.named_parameters())
    still = [n for n in trainable if torch.equal(params[n], before[n])]
    moved = [n for n in frozen if not torch.equal(params[n], before[n])]
    print(f"[{tag} train] {len(trainable) - len(still)} of {len(trainable)} "
          f"trainable tensors moved; {len(moved)} of {len(frozen)} frozen "
          f"(tower) tensors moved")
    if still or moved or not frozen or not all(
            n.startswith("visual_model.") for n in frozen):
        fail(f"trainable tensors that did not move: {still[:5]}; frozen "
             f"tensors that moved: {moved[:5]}")

    ckpt_dir = os.path.join(log_dir, "default_0", "ckpt")
    final = [c for path, c in seen["restores"] if path == ckpt_dir]
    if not final or final[-1] is None or seen["merges"] != 1:
        fail(f"the best checkpoint under {ckpt_dir} was not restored for "
             f"the test pass (restores {[p for p, _ in seen['restores']]})")
    saved = final[-1]["params"]
    if any(k.startswith("visual_model.") for k in saved) or not all(
            torch.equal(params[k].detach().cpu(), v) for k, v in
            saved.items()):
        fail("the test pass did not run on the restored checkpoint")
    print(f"[{tag} train] best checkpoint of epoch {final[-1]['epoch']} "
          f"({len(saved)} tensors, no tower) restored for the test pass")

    timed = steps[1:]                       # the first update is the warm-up
    rate = sum(s["sections"] for s in timed) / sum(s["seconds"] for s in timed)
    print(f"[{tag} train] {rate:.3f} sections/s over {len(timed)} updates of "
          f"{timed[0]['sections']} sections after one warm-up update "
          f"(update seconds {[round(s['seconds'], 4) for s in steps]}; the "
          f"loop's own examples/s {[round(r, 3) for r in seen['rates']]}); "
          f"peak device memory {peak} bytes ({peak / 2**30:.3f} GiB)")
    return {"sections_per_s": rate, "peak_bytes": peak,
            "launches": launches, "in_steps": in_steps,
            "launches_tc": {n: c[1] for n, c in bodies.items()},
            "losses": [s["loss"] for s in steps],
            "grad_norms": [s["grad_norm"] for s in steps],
            "update_seconds": [s["seconds"] for s in steps],
            "test_loss": results["loss"]}


def check_train_step_fp32(cli, fa, device, tokenizer, argv, kernels, tag,
                          tol=STEP_TOL, plain_on_card=False, on_cpu=True):
    """Phases 5b, 7b and 9b: one fp32 training micro-step (loss, backward)
    of one sample on the card against the same seeded model on the CPU,
    within ``tol`` = (loss atol, gradient-norm rtol, largest gradient error
    as a fraction of the largest gradient). Eval mode: the two devices'
    dropout streams differ. ``kernels`` must launch in the card's step.
    With ``plain_on_card`` the step also runs on the card through the plain
    versions, and the kernels' gradient error against the CPU may be at
    most twice the plain versions' (the same sums in another order); without
    ``on_cpu`` the plain versions on the card are the reference. Returns the
    card step's launches and the errors."""
    import torch
    from mmgl_tpu_torch.models.factory import build_model
    from mmgl_tpu_torch.train.steps import losses_of

    args, _ = cli.parse_cli(argv + ["--bf16", "false"])
    args.decoder_only = "t5" not in args.model_name_or_path
    train_ds = cli.setup_data(args, tokenizer)[0]
    batch = next(iter(cli.PrefetchLoader(train_ds, batch_size=1,
                                         num_workers=1)))
    runs = [("card", device, False)]
    if plain_on_card:
        runs.append(("card_plain", device, True))
    if on_cpu:
        runs.append(("cpu", torch.device("cpu"), True))
    ref = runs[-1][0]
    out, launches = {}, {}
    plain = fa._plain
    try:
        for which, dev, use_plain in runs:
            fa._plain = (lambda q: True) if use_plain else plain
            model, _ = build_model(args, dev, vocab_size=tokenizer.vocab_size,
                                   tokenizer=tokenizer)
            reset_launches(fa)
            fused = model.eval()(batch)
            loss, _ = losses_of(fused, args.decoder_only,
                                args.max_input_length, tokenizer.pad_token_id)
            loss.backward()
            if which == "card":
                torch.cuda.synchronize(dev)
                launches = {n: getattr(fa, n).launches for n in KERNELS}
                check_bodies(fa, f"{tag} step fp32", bf16=False)
            grads = {n: p.grad.detach().cpu()
                     for n, p in model.named_parameters() if p.requires_grad}
            norm = math.sqrt(sum(float(g.double().pow(2).sum())
                                 for g in grads.values()))
            out[which] = (float(loss.detach()), norm, grads)
            del model, fused, loss
    finally:
        fa._plain = plain
    loss_h, norm_h, g_h = out[ref]
    scale = max(float(g.abs().max()) for g in g_h.values())
    errs = {}
    for which in out:
        if which == ref:
            continue
        per = {n: float((out[which][2][n] - g_h[n]).abs().max()) for n in g_h}
        worst = max(per, key=per.get)
        errs[which] = per[worst]
        print(f"[{tag} step] fp32 training micro-step, {which} vs {ref}, "
              f"one sample: loss {out[which][0]:.7f} vs {loss_h:.7f}; "
              f"grad_norm {out[which][1]:.6f} vs {norm_h:.6f}; max abs grad "
              f"err {per[worst]:.3e} (in {worst}) of max |grad| {scale:.3e} "
              f"over {len(g_h)} tensors")
    loss_c, norm_c, _ = out["card"]
    loss_atol, norm_rtol, grad_tol = tol
    print(f"[{tag} step] tolerance: loss atol {loss_atol:g}, norm rtol "
          f"{norm_rtol:g}, grad err <= {grad_tol:g} x max |grad|"
          + (", and at most 2x the plain versions' on the card"
             if plain_on_card and on_cpu else "")
          + f"; card launches {launches}")
    if not (abs(loss_c - loss_h) <= loss_atol
            and abs(norm_c - norm_h) <= norm_rtol * norm_h
            and errs["card"] <= grad_tol * scale
            and errs["card"] <= 2 * errs.get("card_plain", math.inf)):
        fail(f"the fp32 {tag} training step on the card disagrees with the "
             "CPU")
    for name in kernels:
        if launches[name] <= 0:
            fail(f"{name} was not launched in the {tag} fp32 micro-step")
    return {"reference": ref, "loss": [loss_c, loss_h],
            "grad_norm": [norm_c, norm_h],
            "max_abs_grad_err": errs, "max_abs_grad": scale,
            "launches": launches}


# ---- phase 8: timings and bounds -------------------------------------------

def allowed_pairs(mask, sq: int, causal: bool) -> float:
    """The (query, key) pairs whose logits the masks leave, summed over the
    batch (per head); a fully masked row needs all its keys (P uniform)."""
    import torch

    b, sk = mask.shape
    i = torch.arange(sq, device=mask.device)[:, None] + (sk - sq)
    j = torch.arange(sk, device=mask.device)[None, :]
    vis = (i >= j) if causal else torch.ones(sq, sk, dtype=torch.bool,
                                             device=mask.device)
    allowed = vis[None] & mask.bool()[:, None, :]
    per_row = allowed.sum(-1)
    per_row = torch.where(per_row == 0, torch.full_like(per_row, sk),
                          per_row)
    return float(per_row.sum())


def bound_ms(flops: float, nbytes: float):
    """(ms, "bytes" or "operations"): the larger of the two times."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def float_mask(mask, sq, causal, bias, dtype):
    """The masks (and bias) as scaled_dot_product_attention's float
    attn_mask, (B, H or 1, Sq, Sk): -1e30 where masked, as the kernels."""
    import torch

    b, sk = mask.shape
    allowed = mask.bool()[:, None, None, :].expand(b, 1, sq, sk)
    if causal:
        i = torch.arange(sq, device=mask.device)[:, None] + (sk - sq)
        allowed = allowed & (i >= torch.arange(sk, device=mask.device))
    add = torch.zeros(b, 1, sq, sk, device=mask.device, dtype=torch.float32)
    if bias is not None:
        add = add + bias.float()
    return add.masked_fill(~allowed, -1e30).to(dtype)


def median_ms(fns, device, rounds: int = 5, run: int = TIMING_RUN):
    """Median ms of each callable, in rounds of plain, kernel, library,
    library, kernel, plain (CUDA events, after a warm-up); a sample is the
    mean of ``run`` calls back to back, so that the host's time to launch a
    call overlaps the card's work on the one before, as it does on the main
    path."""
    import torch

    for fn in fns.values():
        fn()
    torch.cuda.synchronize(device)
    order = [k for k in ("plain", "kernel", "library") if k in fns]
    order = order + order[::-1]
    samples = {k: [] for k in fns}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(rounds * 2):
        for which in order:
            start.record()
            for _ in range(run):
                fns[which]()
            end.record()
            end.synchronize()
            samples[which].append(start.elapsed_time(end) / run)
    return {k: statistics.median(s) for k, s in samples.items()}, len(
        samples["kernel"])


def _bhsd(*ts):
    """BSHD tensors as scaled_dot_product_attention's (B, H, S, D)."""
    return [t.transpose(1, 2).contiguous() for t in ts]


def _sdpa_fwd(q, k, v, am, p=0.0, scale=None):
    import torch.nn.functional as F

    return lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=am, dropout_p=p, scale=scale)


def _sdpa_bwd(q, k, v, am, dout, p=0.0, scale=None, bias_grad=False):
    """The backward of one scaled_dot_product_attention call (the float
    mask's gradient too where it holds a bias), its forward run once."""
    import torch
    import torch.nn.functional as F

    ins = [t.detach().requires_grad_() for t in (q, k, v)]
    if bias_grad:
        am = am.detach().requires_grad_()
        ins.append(am)
    out = F.scaled_dot_product_attention(*ins[:3], attn_mask=am,
                                         dropout_p=p, scale=scale)
    return lambda: torch.autograd.grad(out, ins, dout, retain_graph=True)


def _opt_timing_cases(fa, device):
    """K1 (OPT eval), K2 (CLIP) and K3 (OPT training), bf16."""
    import torch

    bf16 = torch.bfloat16
    cases = []
    for name, idx in (("flash_attention_allheads", 0),
                      ("fused_heads_attention", 2)):
        (q, k, v), kw = kernel_inputs(idx, bf16, device)
        s, h, d = q.shape[1:]
        am = float_mask(kw["kv_mask"], s, kw["causal"], None, bf16)
        pairs = allowed_pairs(kw["kv_mask"], s, kw["causal"]) * h
        cases.append((
            f"{name} {tuple(q.shape)} causal={kw['causal']}", name, {
                "kernel": partial(getattr(fa, name), q, k, v, **kw),
                "plain": partial(getattr(fa, KERNELS[name][0]), q, k, v,
                                 **kw),
                "library": _sdpa_fwd(*_bhsd(q, k, v), am)},
            4 * pairs * d, 4 * q.numel() * 2 + kw["kv_mask"].numel() * 4))
    args, kw = bwd_inputs(0, bf16, device)
    q, k, v, mask, out, dout = args
    s, h, d = q.shape[1:]
    pairs = allowed_pairs(mask, s, True) * h
    cases.append((
        f"flash_attention_allheads_bwd {tuple(q.shape)} causal",
        "flash_attention_allheads_bwd", {
            "kernel": partial(fa.flash_attention_allheads_bwd, *args, **kw),
            "plain": partial(fa.allheads_attention_bwd_reference, *args,
                             **kw),
            "library": _sdpa_bwd(*_bhsd(q, k, v),
                                 float_mask(mask, s, True, None, bf16),
                                 *_bhsd(dout))},
        10 * pairs * d, 8 * q.numel() * 2 + mask.numel() * 4))
    return cases


def _flash_timing_cases(fa, device):
    """K4 and K5 at T5-base's eval cross-attention, bf16."""
    import torch

    bf16 = torch.bfloat16
    dims, causal, mask_kind = FLASH_CASES[0]
    q, k, v, mask, dout = flash_inputs(dims, mask_kind, bf16, device, 200)
    sq, h = dims[1], dims[3]
    out = fa.flash_attention(q, k, v, kv_mask=mask)
    qt, kt, vt, dot = _bhsd(q, k, v, dout)
    am = float_mask(mask, sq, False, None, bf16)
    pairs = allowed_pairs(mask, sq, False) * h
    io_fwd = (2 * q.numel() + 2 * k.numel()) * 2 + mask.numel() * 4
    io_bwd = (4 * q.numel() + 4 * k.numel()) * 2 + mask.numel() * 4
    return [
        (f"flash_attention {dims}", "flash_attention", {
            "kernel": partial(fa.flash_attention, q, k, v, kv_mask=mask),
            "plain": partial(fa.flash_attention_reference, q, k, v,
                             kv_mask=mask),
            "library": _sdpa_fwd(qt, kt, vt, am)}, 4 * pairs * 64, io_fwd),
        (f"flash_attention_bwd {dims}", "flash_attention_bwd", {
            "kernel": partial(fa.flash_attention_bwd, q, k, v, mask, out,
                              dout),
            "plain": partial(fa.flash_attention_bwd_reference, q, k, v, mask,
                             out, dout),
            "library": _sdpa_bwd(qt, kt, vt, am, dot)},
         10 * pairs * 64, io_bwd)]


def _bias_timing_cases(fa, device, i):
    """K7 at BIAS_CASES[i] in eval (no dropout; not for the cross-attention,
    which is K4's in eval) and training (dropout), and its backward from
    K7's row stats: K9 at the encoder's shape, K8 at the decoder's."""
    import torch

    bf16 = torch.bfloat16
    tag, dims, causal, with_bias = BIAS_CASES[i]
    q, k, v, mask, bias, dout, seed = bias_inputs(dims, with_bias, bf16,
                                                  device, 300 + i)
    sq, h = dims[1], dims[3]
    pairs = allowed_pairs(mask, sq, causal) * h
    bias_bytes = 0 if bias is None else bias.numel() * 2
    io_fwd = ((2 * q.numel() + 2 * k.numel()) * 2 + mask.numel() * 4
              + bias_bytes)
    # q, k, v, o, dO, mask and bias in; dq, dk, dv and dbias out
    io_bwd = ((4 * q.numel() + 4 * k.numel()) * 2 + mask.numel() * 4
              + 2 * bias_bytes)
    qt, kt, vt, dot = _bhsd(q, k, v, dout)
    am = float_mask(mask, sq, causal, bias, bf16)
    shape = f"{tag} {dims} causal={causal} bias={with_bias}"
    cases = []
    for rate in ((RATE,) if tag == "cross" else (0.0, RATE)):
        kw = dict(bias=bias, kv_mask=mask, causal=causal, scale=1.0,
                  dropout_rate=rate, dropout_seed=seed)
        cases.append((
            f"flash_attention_bias {shape} dropout={rate}",
            "flash_attention_bias", {
                "kernel": partial(fa.flash_attention_bias, q, k, v, **kw),
                "plain": partial(fa.bias_attention_reference, q, k, v, **kw),
                "library": _sdpa_fwd(qt, kt, vt, am, rate, 1.0)},
            4 * pairs * 64, io_fwd))
    # K8/K9 as training runs it: from K7's row stats
    out, m, l = fa.flash_attention_bias_stats(
        q, k, v, bias=bias, kv_mask=mask, causal=causal, scale=1.0,
        dropout_rate=RATE, dropout_seed=seed)
    bkw = dict(causal=causal, scale=1.0, dropout_rate=RATE,
               dropout_seed=seed)
    cases.append((
        f"flash_attention_bias_bwd {shape} dropout={RATE} from K7's stats",
        "flash_attention_bias_bwd[K9]" if tag == "enc"
        else "flash_attention_bias_bwd[K8]", {
            "kernel": partial(fa.flash_attention_bias_bwd, q, k, v, mask,
                              None if bias is None else bias[0], out, dout,
                              row_max=m, row_sum=l, **bkw),
            "plain": partial(fa.bias_attention_bwd_reference, q, k, v, mask,
                             bias, out, dout, **bkw),
            "library": _sdpa_bwd(qt, kt, vt, am, dot, RATE, 1.0,
                                 bias_grad=with_bias)},
        10 * pairs * 64, io_bwd + 2 * m.numel() * 4))
    return cases


def _blocked_timing_cases(fa, device):
    """K4 with its row stats, K6 and, for comparison, K5 at OPT-350M's
    training shape, bf16, and K6 against K5 again at 1024 tokens. K6 and K5
    compute the same gradient, so both are bounded by 10 * D FLOPs per
    allowed pair, K3's count; the bytes read q, k, v, dO, o, the mask (and
    K6 the stats) once and write dq, dk, dv once."""
    import torch

    bf16 = torch.bfloat16
    dims, causal, _ = BLOCKED_CASES[0]
    cases = []
    # seed 400 at 2048: phase 3's inputs (blocked_inputs(0))
    for tokens, seed in ((2048, 400), (1024, 401)):
        dims = (dims[0], tokens, tokens, *dims[3:])
        q, k, v, mask, dout = flash_inputs((*dims, dims[3]), "hole", bf16,
                                           device, seed)
        sq, h = dims[1], dims[3]
        out, m, l = fa.flash_attention_stats(q, k, v, kv_mask=mask,
                                             causal=causal)
        qt, kt, vt, dot = _bhsd(q, k, v, dout)
        am = float_mask(mask, sq, causal, None, bf16)
        pairs = allowed_pairs(mask, sq, causal) * h
        stats_bytes = 2 * m.numel() * 4
        io_fwd = 4 * q.numel() * 2 + mask.numel() * 4 + stats_bytes
        io_bwd = 8 * q.numel() * 2 + mask.numel() * 4
        shape = f"{dims} causal mask=hole"
        # the kernels line takes each name's first case: OPT-350M's shape
        tag = "" if tokens == 2048 else f"[{tokens}]"
        bwd_args = (q, k, v, mask, out, dout)
        if tokens == 2048:
            cases.append((
                f"flash_attention with stats {shape}",
                "flash_attention[stats]", {
                    "kernel": partial(fa.flash_attention_stats, q, k, v,
                                      kv_mask=mask, causal=causal),
                    "plain": partial(fa.flash_attention_reference, q, k, v,
                                     kv_mask=mask, causal=causal,
                                     with_stats=True),
                    "library": _sdpa_fwd(qt, kt, vt, am)},
                4 * pairs * 64, io_fwd))
        cases += [
            (f"flash_attention_blocked_bwd {shape}",
             f"flash_attention_blocked_bwd{tag}", {
                 "kernel": partial(fa.flash_attention_blocked_bwd, *bwd_args,
                                   m, l, causal=causal),
                 "plain": partial(fa.flash_attention_blocked_bwd_reference,
                                  *bwd_args, m, l, causal=causal),
                 "library": _sdpa_bwd(qt, kt, vt, am, dot)},
             10 * pairs * 64, io_bwd + stats_bytes),
            (f"flash_attention_bwd {shape}", f"flash_attention_bwd[{tokens}]",
             {"kernel": partial(fa.flash_attention_bwd, *bwd_args,
                                causal=causal),
              "plain": partial(fa.flash_attention_bwd_reference, *bwd_args,
                               causal=causal),
              "library": _sdpa_bwd(qt, kt, vt, am, dot)},
             10 * pairs * 64, io_bwd)]
    return cases


def timing_cases(fa, device):
    """(label, kernel name, {"kernel", "plain", "library"} callables, FLOPs,
    bytes) for every kernel at its main-path shapes, bf16."""
    cases = _opt_timing_cases(fa, device) + _flash_timing_cases(fa, device)
    for i in range(3):          # the encoder, decoder and cross shapes
        cases += _bias_timing_cases(fa, device, i)
    return cases + _blocked_timing_cases(fa, device)


def time_kernels(fa, device):
    """Phase 8: {label: (kernel name, times, bound ms, bound_by)}."""
    rows = {}
    for label, name, fns, flops, nbytes in timing_cases(fa, device):
        times, n = median_ms(fns, device)
        bound, by = bound_ms(flops, nbytes)
        rows[label] = (name, times, bound, by)
        print(f"[time] {label} bfloat16: kernel {times['kernel']:.4f} ms, "
              f"plain {times['plain']:.4f} ms, library "
              f"{times['library']:.4f} ms (kernel / library "
              f"{times['kernel'] / times['library']:.3f}; medians of {n} "
              f"runs of {TIMING_RUN}); bound {bound:.4f} ms ({by}: "
              f"{flops:.4g} FLOP, {nbytes:.4g} B)")
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from mmgl_tpu_torch import cli
    from mmgl_tpu_torch.ops import _build
    from mmgl_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True, check=True).stdout.strip()
    print(card)                            # name, power limit
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    start = time.perf_counter()
    lib = _build.load()
    print(f"[build] {lib.path.name}: nvcc {lib.seconds:.2f} s, load "
          f"{time.perf_counter() - start:.2f} s; ptxas:")
    print("\n".join("  " + line.strip() for line in lib.ptxas.splitlines()
                    if line.strip()))

    # K4 with its row stats keeps its own worst error: output, max and sum
    worst = {name: 0.0 for name in (*KERNELS, "flash_attention[stats]")}
    check_opt_kernels(fa, device, worst)
    keep = check_t5_kernels(fa, device, worst)
    check_blocked_kernels(fa, device, worst)

    test, results, opt_test, rate, peak = run_test_pass(
        cli, fa, device, OPT_TEST_ARGV, OPT_TEST_KERNELS, tag="opt")
    check_model_fp32(cli, fa, test, device, OPT_TEST_ARGV, "opt")
    tokenizer = test.tokenizer
    del test
    with tempfile.TemporaryDirectory() as log_dir:
        train = run_training(cli, fa, device, log_dir, OPT_TRAIN_ARGV,
                             OPT_TRAIN_KERNELS, tag="opt")
    step = check_train_step_fp32(cli, fa, device, tokenizer, OPT_TRAIN_ARGV,
                                 OPT_TRAIN_KERNELS, "opt")

    per_eval = {"flash_attention_bias": 2 * T5_LAYERS,
                "flash_attention": T5_LAYERS,
                "fused_heads_attention": T5_LAYERS}
    per_generate = {"flash_attention_bias": T5_LAYERS, "flash_attention": 0,
                    "fused_heads_attention": T5_LAYERS}
    t5_test, t5_results, t5_test_launches, t5_rate, t5_peak = run_test_pass(
        cli, fa, device, T5_TEST_ARGV,
        ("flash_attention_bias", "flash_attention", "fused_heads_attention"),
        per_eval, per_generate, tag="t5")
    t5_model = check_model_fp32(cli, fa, t5_test, device, T5_TEST_ARGV,
                                "t5")
    t5_tokenizer = t5_test.tokenizer
    del t5_test
    micro = TRAIN_UPDATES   # micro-batches per update (4 x 4)
    per_update = {"flash_attention_bias": 3 * T5_LAYERS * micro,
                  "flash_attention_bias_bwd": 3 * T5_LAYERS * micro,
                  "flash_attention": 0, "flash_attention_bwd": 0}
    # K8 and K9 are one wrapper: its launches are told apart by (Sq, Sk),
    # counted where the launcher runs
    bwd_shapes = {}
    launch_bias_bwd = fa._launch_bias_bwd

    def tallied(q, k, *a, **kw):
        key = (q.shape[1], k.shape[1])
        bwd_shapes[key] = bwd_shapes.get(key, 0) + 1
        return launch_bias_bwd(q, k, *a, **kw)

    fa._launch_bias_bwd = tallied
    try:
        with tempfile.TemporaryDirectory() as log_dir:
            t5_train = run_training(
                cli, fa, device, log_dir, T5_TRAIN_ARGV,
                ("flash_attention_bias", "flash_attention_bias_bwd",
                 "fused_heads_attention"), per_update, tag="t5")
    finally:
        fa._launch_bias_bwd = launch_bias_bwd
    print(f"[t5 train] K8/K9 launches by (Sq, Sk): {bwd_shapes}")
    if sum(bwd_shapes.values()) != t5_train["launches"][
            "flash_attention_bias_bwd"]:
        fail("the K8/K9 launches by shape do not add up to its count")
    t5_step = check_train_step_fp32(
        cli, fa, device, t5_tokenizer, T5_TRAIN_ARGV,
        ("flash_attention_bias", "flash_attention_bias_bwd",
         "flash_attention", "flash_attention_bwd"), "t5", tol=T5_STEP_TOL,
        plain_on_card=True)

    rows = time_kernels(fa, device)
    torch.cuda.empty_cache()    # the plain versions' (4, 16, 2048, 2048)s

    # phase 9: OPT-350M at its 2048-token window, with the blocked backward
    # selected for this phase only, through the module flag that
    # MMGL_BLOCKED_BWD=1 sets at import
    flag = fa.BLOCKED_BWD
    fa.BLOCKED_BWD = True
    per_pass = {"flash_attention": OPT350_LAYERS,
                "flash_attention_allheads": 0}
    try:
        with tempfile.TemporaryDirectory() as log_dir:
            opt350 = run_training(
                cli, fa, device, log_dir, OPT350_TRAIN_ARGV,
                ("flash_attention", "flash_attention_blocked_bwd",
                 "fused_heads_attention"),
                {"flash_attention": OPT350_LAYERS * micro,
                 "flash_attention_blocked_bwd": OPT350_LAYERS * micro,
                 "flash_attention_allheads": 0,
                 "flash_attention_allheads_bwd": 0,
                 "flash_attention_bwd": 0},
                tag="opt350m", per_eval=per_pass, per_generate=per_pass)
        opt350_step = check_train_step_fp32(
            cli, fa, device, tokenizer, OPT350_TRAIN_ARGV,
            ("flash_attention", "flash_attention_blocked_bwd"), "opt350m",
            plain_on_card=True, on_cpu=False)
    finally:
        fa.BLOCKED_BWD = flag
    if opt350["launches"]["flash_attention_allheads_bwd"]:
        fail("K3 launched in the OPT-350M run")

    print(json.dumps({"opt_test": {
        "sections_per_s": rate, "peak_bytes": peak,
        "test_loss": results["loss"], "launches": opt_test, "card": card}}))
    print(json.dumps({"opt_training": {**train, "fp32_step": step,
                                       "card": card}}))
    print(json.dumps({"t5_test": {
        "sections_per_s": t5_rate, "peak_bytes": t5_peak,
        "test_loss": t5_results["loss"], "launches": t5_test_launches,
        "fp32_eval": t5_model, "card": card}}))
    print(json.dumps({"t5_training": {**t5_train, "fp32_step": t5_step,
                                      "dropout_keep_fraction": keep,
                                      "card": card}}))
    print(json.dumps({"opt350m_training": {**opt350, "fp32_step": opt350_step,
                                           "card": card}}))

    # each kernel's launches from the path that runs it: K1-K3 the OPT
    # training run, K4 the T5 test pass, K7/K8/K9 the T5 training run, K5
    # the T5 fp32 micro-step (its gradient runs only where dropout is off)
    launches = dict(train["launches"])
    launches["flash_attention"] = t5_test_launches["flash_attention"]
    launches["flash_attention_bias"] = t5_train["launches"][
        "flash_attention_bias"]
    launches["flash_attention_bwd"] = t5_step["launches"][
        "flash_attention_bwd"]
    # K9 at the encoder's 512 x 512, K8 at the decoder's shapes
    k9 = bwd_shapes.get((512, 512), 0)
    launches["flash_attention_bias_bwd[K9]"] = k9
    launches["flash_attention_bias_bwd[K8]"] = sum(bwd_shapes.values()) - k9
    # K4 with its stats and K6: the OPT-350M training steps (its eval steps
    # and prefills run K4 without the stats)
    launches["flash_attention[stats]"] = opt350["in_steps"]["flash_attention"]
    launches["flash_attention_blocked_bwd"] = opt350["launches"][
        "flash_attention_blocked_bwd"]
    entries = []
    timed_label = {}
    for label, (name, _, _, _) in rows.items():
        # a kernel's line takes its first timed case (K7: the encoder in
        # eval); every case is printed above. K5 at OPT-350M's shape is
        # timed beside K6 only: no main path runs it there
        if name in launches:
            timed_label.setdefault(name, label)
    for name, label in timed_label.items():
        base = name.split("[")[0]
        _, replaces, source = KERNELS[base]
        if name.endswith("[K9]"):
            replaces = f"{PALLAS}:984"
        _, times, bound, by = rows[label]
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": worst.get(name, worst[base]),
            "ms": times["kernel"],
            "plain_ms": times["plain"], "bound_ms": bound, "bound_by": by,
            "library_ms": times["library"], "shape": label,
            # every timed case is bf16
            "design": DESIGNS["bias_tc" if base in BIAS_KERNELS
                              else "tc"]})
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
