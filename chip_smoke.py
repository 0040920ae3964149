#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (mmgl_tpu_torch).

    python3 chip_smoke.py

Needs one NVIDIA Hopper GPU with nvcc (on PATH or in $CUDA_HOME/bin) and
imports no JAX. Phases, each fatal on failure:

  1. the card: CUDA visible, its name and power limit from nvidia-smi;
  2. build the kernels from mmgl_tpu_torch/csrc (time, ptxas report);
  3. each kernel against its plain version on the card at the main paths'
     shapes, bf16 and fp32, with fully masked rows: K1 and K2 forward, K3
     (K1's backward) at the training shape and a ragged one;
  4. the test pass at full width: OPT-125M + CLIP ViT-B/16, task=section,
     context=all, raw neighbors, the --test pass of mmgl_tpu_torch.cli on the
     synthetic corpus with seeded random weights; K1 and K2 must launch in
     it. Then one sample's fp32 eval step on the card against the same
     model on the CPU, where the kernels' plain versions run;
  5. training at the same width through mmgl_tpu_torch.cli (bf16, batch 4 x
     4 micro-batches, 4 updates, the val passes, the best checkpoint, the
     test pass on it restored): K1, K2 and K3 must launch inside the
     training steps, every loss and gradient norm be finite, the trainable
     weights move and the tower's not. Then one fp32 micro-step (loss and
     gradients) on the card against the CPU;
  6. each kernel timed against its plain version with CUDA events.

The launch counts are set to 0 just before the test pass and just before
the training run, and read just after each. Prints a kernels JSON line (launches:
the training run's counts), then as its last line
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

MAIN_ARGV = ["--model_name_or_path", "opt-125m", "--task", "section",
             "--context", "all", "--neighbor_mode", "raw", "--test", "true",
             "--bf16", "true", "--tokenizer_path", "byte:50272",
             "--per_device_val_batch_size", "4", "--val_steps_per_epoch", "4",
             "--seed", "0", "--device", "cuda"]

TRAIN_ARGV = ["--model_name_or_path", "opt-125m", "--task", "section",
              "--context", "all", "--neighbor_mode", "raw",
              "--bf16", "true", "--tokenizer_path", "byte:50272",
              "--per_device_train_batch_size", "4",
              "--grad_accumulation_steps", "4", "--steps_per_epoch", "16",
              "--epochs", "1", "--per_device_val_batch_size", "4",
              "--val_steps_per_epoch", "2", "--print_freq", "1",
              "--seed", "0", "--device", "cuda"]
TRAIN_UPDATES = 4

FWD_SOURCE = "mmgl_tpu_torch/csrc/attention_fwd.cu"
BWD_SOURCE = "mmgl_tpu_torch/csrc/attention_bwd.cu"
# kernel wrapper -> (its plain version, the Pallas kernel it replaces, source)
KERNELS = {
    "flash_attention_allheads": ("allheads_attention_reference",
                                 "mmgl_tpu/ops/flash_attention.py:1283",
                                 FWD_SOURCE),
    "fused_heads_attention": ("fused_heads_attention_reference",
                              "mmgl_tpu/ops/flash_attention.py:1152",
                              FWD_SOURCE),
    "flash_attention_allheads_bwd": ("allheads_attention_bwd_reference",
                                     "mmgl_tpu/ops/flash_attention.py:1307",
                                     BWD_SOURCE),
}
# the main path's attention calls: (kernel, (B, S, H, D), causal, mask)
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
# the kernels of the test pass (forward only)
TEST_KERNELS = ("flash_attention_allheads", "fused_heads_attention")
# the case each kernel is timed at (bf16, as the main path runs it)
TIMED = {"flash_attention_allheads": 0, "fused_heads_attention": 2,
         "flash_attention_allheads_bwd": 0}
# (atol, rtol) by dtype name
TOLERANCES = {"bfloat16": (2e-2, 2e-2), "float32": (2e-5, 0.0)}
# K3, per gradient: (atol as a fraction of its largest entry, rtol); bf16:
# the plain version rounds P and dS to bf16 before their products, the
# kernel keeps them fp32
BWD_TOLERANCES = {"bfloat16": (2e-2, 2e-2), "float32": (1e-5, 0.0)}
# whole-model fp32 check, card vs CPU: logits and loss
MODEL_ATOL = 1e-3
# fp32 training micro-step, card vs CPU: loss (abs), gradient norm (rel),
# and the largest gradient error as a fraction of the largest gradient
# (sums of 640 tokens through 12 layers in another order; a wrong kernel is
# off by the gradient's own size)
STEP_LOSS_ATOL = 1e-3
STEP_NORM_RTOL = 1e-4
STEP_GRAD_TOL = 1e-3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def make_mask(kind: str, b: int, s: int, seed: int):
    """(B, S) int32 key mask. "hole": a decoder-only batch, prompt padded to
    512 then summary padded to 128, so the valid keys have a hole
    ("hole333": the same at S = 333, prompt 250); "prompt": right-padded
    prompts; "fully_masked": sample 0 all zero ("hole_fully_masked": with
    holes in the others)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    mask = np.ones((b, s), np.int32)
    if kind == "hole":
        for i in range(b):
            mask[i, rng.randint(100, 512):512] = 0
            mask[i, 512 + rng.randint(20, 128):] = 0
    elif kind == "prompt":
        for i in range(b):
            mask[i, rng.randint(100, s):] = 0
    elif kind == "hole333":
        for i in range(b):
            mask[i, rng.randint(50, 250):250] = 0
            mask[i, 250 + rng.randint(1, 83):] = 0
    elif kind == "hole_fully_masked":
        mask = make_mask("hole", b, s, seed)
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


def check_kernels(fa, device):
    """Phase 3: each case in each dtype; returns {kernel: max abs err}."""
    import torch

    worst = {name: 0.0 for name in KERNELS}
    for i, (name, shape, causal, mask_kind) in enumerate(CASES):
        kernel = getattr(fa, name)
        plain = getattr(fa, KERNELS[name][0])
        for dtype_name, (atol, rtol) in TOLERANCES.items():
            args, kw = kernel_inputs(i, getattr(torch, dtype_name), device)
            got = kernel(*args, **kw)
            torch.cuda.synchronize(device)
            ref = plain(*args, **kw)
            torch.cuda.synchronize(device)
            err = (got.float() - ref.float()).abs()
            ok = (bool(torch.isfinite(got).all())
                  and bool((err <= atol + rtol * ref.float().abs()).all()))
            max_err = float(err.max())
            print(f"[check] {name} {shape} causal={causal} mask={mask_kind} "
                  f"{dtype_name}: max_abs_err={max_err:.3e} atol={atol:g} "
                  f"rtol={rtol:g} {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"{name} disagrees with its plain version")
            worst[name] = max(worst[name], max_err)
    name = "flash_attention_allheads_bwd"
    for i, (shape, causal, mask_kind) in enumerate(BWD_CASES):
        for dtype_name, (atol, rtol) in BWD_TOLERANCES.items():
            args, kw = bwd_inputs(i, getattr(torch, dtype_name), device)
            got = fa.flash_attention_allheads_bwd(*args, **kw)
            torch.cuda.synchronize(device)
            ref = fa.allheads_attention_bwd_reference(*args, **kw)
            torch.cuda.synchronize(device)
            report = []
            for grad, g, r in zip(("dq", "dk", "dv"), got, ref):
                err = (g.float() - r.float()).abs()
                bound = atol * float(r.float().abs().max())
                ok = (g.dtype == r.dtype and bool(torch.isfinite(g).all())
                      and bool((err <= bound + rtol * r.float().abs()).all()))
                max_err = float(err.max())
                report.append(f"{grad} {max_err:.3e}{'' if ok else ' FAIL'}")
                if not ok:
                    print(f"[check] {name} {shape} causal={causal} "
                          f"mask={mask_kind} {dtype_name}: {', '.join(report)}")
                    fail(f"{name} {grad} disagrees with its plain version")
                worst[name] = max(worst[name], max_err)
            print(f"[check] {name} {shape} causal={causal} mask={mask_kind} "
                  f"{dtype_name}: max_abs_err {', '.join(report)} (atol "
                  f"{atol:g} x max|ref|, rtol {rtol:g}) ok")
    return worst


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


def run_main_path(cli, fa, device):
    """Phase 4: the --test pass at full width; returns (the test pass,
    results, launches, sections/s after the warm-up batch, peak bytes)."""
    import torch

    args, dev = cli.parse_cli(MAIN_ARGV)
    test = cli.prepare(args, dev)
    shapes = []
    generate_fn = test.generate_fn

    def generate(batch):
        ids = generate_fn(batch)
        shapes.append(tuple(ids.shape))
        if not bool(((ids >= 0) & (ids < test.fcfg.opt.vocab_size)).all()):
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
    for name in KERNELS:
        getattr(fa, name).launches = 0
    results = cli.evaluate_loop(test, args, args.start_epoch, log,
                                prefix="test")
    launches = {name: getattr(fa, name).launches for name in TEST_KERNELS}
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)

    print(f"[main] results: {json.dumps(results, sort_keys=True)}")
    print(f"[main] launches: {launches}; generated shapes: {shapes}")
    if not math.isfinite(results["loss"]):
        fail(f"test loss is not finite: {results['loss']}")
    if not shapes or any(s != (4, cli.MAX_NEW_TOKENS) for s in shapes):
        fail(f"generated ids have shapes {shapes}, expected (4, 32)")
    for name, n in launches.items():
        if n <= 0:
            fail(f"{name} was not launched by the main path")
    timed = batches[1:]                    # the first batch is the warm-up
    if not timed:
        fail("the main path ran fewer than two batches")
    rate = sum(n for _, n in timed) / sum(t for t, _ in timed)
    print(f"[main] {rate:.3f} sections/s over {len(timed)} batches after one "
          f"warm-up batch (batch seconds {[round(t, 4) for t, _ in batches]})"
          f"; peak device memory {peak} bytes ({peak / 2**30:.3f} GiB)")
    return test, results, launches, rate, peak


def check_model_fp32(cli, test, device):
    """Phase 4b: one sample's fp32 eval step through the kernels on the card
    against the same seeded model on the CPU (plain versions)."""
    import torch
    from mmgl_tpu_torch.models.factory import build_model
    from mmgl_tpu_torch.train.losses import causal_losses

    args, _ = cli.parse_cli(MAIN_ARGV + ["--bf16", "false"])
    batch = next(iter(test.loader))
    batch = {k: v[:1] for k, v in batch.items()}
    out = {}
    for dev in (device, torch.device("cpu")):
        model, _ = build_model(args, dev,
                               vocab_size=test.tokenizer.vocab_size,
                               tokenizer=test.tokenizer)
        with torch.no_grad():
            fused = model.eval()(batch)
        out[dev.type] = (fused["logits"].float().cpu(),
                         float(causal_losses(
                             fused["logits"], fused["labels"],
                             args.max_input_length,
                             test.tokenizer.pad_token_id)[0]))
        del model, fused
    err = float((out["cuda"][0] - out["cpu"][0]).abs().max())
    loss_err = abs(out["cuda"][1] - out["cpu"][1])
    print(f"[model] fp32 eval, card vs CPU, one sample at S=640: logits "
          f"max_abs_err={err:.3e}, loss {out['cuda'][1]:.6f} vs "
          f"{out['cpu'][1]:.6f} (atol={MODEL_ATOL:g})")
    if not (err <= MODEL_ATOL and loss_err <= MODEL_ATOL):
        fail("the fp32 model on the card disagrees with the CPU")


def run_training(cli, fa, device, log_dir: str):
    """Phase 5: the training run at full width through the entry point.

    The CLI's model factory, train step and checkpoint restore are wrapped
    here, not changed: the wrappers snapshot the weights, time each update
    to a device synchronize and count the kernel launches inside it, and
    record the final restore. Returns a summary dict."""
    import torch

    args, dev = cli.parse_cli(TRAIN_ARGV + ["--log_dir", log_dir])
    seen = {"steps": [], "restores": [], "merges": 0, "rates": []}
    originals = {name: getattr(cli, name) for name in (
        "build_model", "make_train_step", "restore_checkpoint",
        "merge_restored_params")}

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
                "merge_restored_params": merge_restored_params}
    for name, fn in wrappers.items():
        setattr(cli, name, fn)
    try:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        for name in KERNELS:
            getattr(fa, name).launches = 0
        results = cli.run(args, dev, log)
        launches = {name: getattr(fa, name).launches for name in KERNELS}
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
    finally:
        for name, fn in originals.items():
            setattr(cli, name, fn)

    steps = seen["steps"]
    in_steps = {n: sum(s["launches"][n] for s in steps) for n in KERNELS}
    print(f"[train] results: {json.dumps(results, sort_keys=True)}")
    for i, st in enumerate(steps):
        print(f"[train] update {i + 1}: loss {st['loss']:.6f} summary_loss "
              f"{st['summary_loss']:.6f} grad_norm {st['grad_norm']:.6f} "
              f"{st['seconds']:.4f} s; launches {st['launches']}")
    print(f"[train] launches in the run {launches}, inside the training "
          f"steps {in_steps}")
    if len(steps) != TRAIN_UPDATES or results["train_updates"] != len(steps):
        fail(f"{len(steps)} training updates, expected {TRAIN_UPDATES}")
    for name in KERNELS:
        if launches[name] <= 0 or in_steps[name] <= 0:
            fail(f"{name} was not launched inside the training steps")
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
    print(f"[train] {len(trainable) - len(still)} of {len(trainable)} "
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
    print(f"[train] best checkpoint of epoch {final[-1]['epoch']} "
          f"({len(saved)} tensors, no tower) restored for the test pass")

    timed = steps[1:]                       # the first update is the warm-up
    rate = sum(s["sections"] for s in timed) / sum(s["seconds"] for s in timed)
    print(f"[train] {rate:.3f} sections/s over {len(timed)} updates of "
          f"{timed[0]['sections']} sections after one warm-up update "
          f"(update seconds {[round(s['seconds'], 4) for s in steps]}; the "
          f"loop's own examples/s {[round(r, 3) for r in seen['rates']]}); "
          f"peak device memory {peak} bytes ({peak / 2**30:.3f} GiB)")
    return {"sections_per_s": rate, "peak_bytes": peak,
            "launches": launches, "in_steps": in_steps,
            "losses": [s["loss"] for s in steps],
            "grad_norms": [s["grad_norm"] for s in steps],
            "update_seconds": [s["seconds"] for s in steps],
            "test_loss": results["loss"]}


def check_train_step_fp32(cli, device, tokenizer):
    """Phase 5b: one fp32 training micro-step (loss, backward) of one
    sample on the card against the same seeded model on the CPU. Eval mode:
    the two devices' dropout streams differ."""
    import torch
    from mmgl_tpu_torch.models.factory import build_model
    from mmgl_tpu_torch.train.losses import causal_losses

    args, _ = cli.parse_cli(TRAIN_ARGV + ["--bf16", "false"])
    args.decoder_only = True
    train_ds = cli.setup_data(args, tokenizer)[0]
    batch = next(iter(cli.PrefetchLoader(train_ds, batch_size=1,
                                         num_workers=1)))
    out = {}
    for dev in (device, torch.device("cpu")):
        model, _ = build_model(args, dev, vocab_size=tokenizer.vocab_size,
                               tokenizer=tokenizer)
        fused = model.eval()(batch)
        loss, _ = causal_losses(fused["logits"], fused["labels"],
                                args.max_input_length, tokenizer.pad_token_id)
        loss.backward()
        grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()
                 if p.requires_grad}
        norm = math.sqrt(sum(float(g.double().pow(2).sum())
                             for g in grads.values()))
        out[dev.type] = (float(loss.detach()), norm, grads)
        del model, fused, loss
    (loss_c, norm_c, g_c), (loss_h, norm_h, g_h) = out["cuda"], out["cpu"]
    errs = {n: float((g_c[n] - g_h[n]).abs().max()) for n in g_h}
    worst = max(errs, key=errs.get)
    err = errs[worst]
    scale = max(float(g.abs().max()) for g in g_h.values())
    print(f"[step] fp32 training micro-step, card vs CPU, one sample at "
          f"S=640: loss {loss_c:.6f} vs {loss_h:.6f}; grad_norm "
          f"{norm_c:.6f} vs {norm_h:.6f}; max abs grad err {err:.3e} (in "
          f"{worst}) of max |grad| {scale:.3e} over {len(g_h)} tensors (loss "
          f"atol "
          f"{STEP_LOSS_ATOL:g}, norm rtol {STEP_NORM_RTOL:g}, grad err <= "
          f"{STEP_GRAD_TOL:g} x max |grad|)")
    if not (abs(loss_c - loss_h) <= STEP_LOSS_ATOL
            and abs(norm_c - norm_h) <= STEP_NORM_RTOL * norm_h
            and err <= STEP_GRAD_TOL * scale):
        fail("the fp32 training step on the card disagrees with the CPU")
    return {"loss": [loss_c, loss_h], "grad_norm": [norm_c, norm_h],
            "max_abs_grad_err": err, "max_abs_grad": scale}


def time_kernels(fa, device, rounds: int = 5):
    """Phase 6: median ms of 20 runs each, in rounds of plain, kernel,
    kernel, plain, with CUDA events."""
    import torch

    times = {}
    for name, case_index in TIMED.items():
        if name == "flash_attention_allheads_bwd":
            args, kw = bwd_inputs(case_index, torch.bfloat16, device)
            shape, causal, _ = BWD_CASES[case_index]
        else:
            args, kw = kernel_inputs(case_index, torch.bfloat16, device)
            _, shape, causal, _ = CASES[case_index]
        fns = {"kernel": lambda: getattr(fa, name)(*args, **kw),
               "plain": lambda: getattr(fa, KERNELS[name][0])(*args, **kw)}
        for fn in fns.values():           # warm up
            fn()
        torch.cuda.synchronize(device)
        samples = {"kernel": [], "plain": []}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(rounds * 2):
            for which in ("plain", "kernel", "kernel", "plain"):
                start.record()
                fns[which]()
                end.record()
                end.synchronize()
                samples[which].append(start.elapsed_time(end))
        times[name] = {w: statistics.median(s) for w, s in samples.items()}
        print(f"[time] {name} {shape} causal={causal} bfloat16: kernel "
              f"{times[name]['kernel']:.4f} ms, plain "
              f"{times[name]['plain']:.4f} ms (median of "
              f"{len(samples['kernel'])})")
    return times


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

    worst = check_kernels(fa, device)
    test, results, launches, rate, peak = run_main_path(cli, fa, device)
    check_model_fp32(cli, test, device)
    tokenizer = test.tokenizer
    del test
    with tempfile.TemporaryDirectory() as log_dir:
        train = run_training(cli, fa, device, log_dir)
    step = check_train_step_fp32(cli, device, tokenizer)
    times = time_kernels(fa, device)

    print(json.dumps({"main_path": {
        "sections_per_s": rate, "peak_bytes": peak,
        "test_loss": results["loss"], "launches": launches, "card": card}}))
    print(json.dumps({"training": {**train, "fp32_step": step,
                                   "card": card}}))
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": train["launches"][name],
         "max_abs_err": worst[name], "ms": times[name]["kernel"],
         "plain_ms": times[name]["plain"]}
        for name, (_, replaces, source) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
