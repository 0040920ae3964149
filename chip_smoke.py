#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (mmgl_tpu_torch).

    python3 chip_smoke.py

Needs one NVIDIA Hopper GPU with nvcc (on PATH or in $CUDA_HOME/bin) and
imports no JAX. Phases, each fatal on failure:

  1. the card: CUDA visible, its name and power limit from nvidia-smi;
  2. build the kernels from mmgl_tpu_torch/csrc (time, ptxas report);
  3. each kernel against its plain version on the card at the main path's
     shapes, bf16 and fp32, with fully masked rows;
  4. the main path at full width: OPT-125M + CLIP ViT-B/16, task=section,
     context=all, raw neighbors, the --test pass of mmgl_tpu_torch.cli on the
     synthetic corpus with seeded random weights; both kernels must launch
     in it. Then one sample's fp32 eval step on the card against the same
     model on the CPU, where the kernels' plain versions run;
  5. each kernel timed against its plain version with CUDA events.

Prints a kernels JSON line, then as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
fp32 comparisons run with TF32 off (cuBLAS and cuDNN), so the plain
versions compute in full fp32.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

MAIN_ARGV = ["--model_name_or_path", "opt-125m", "--task", "section",
             "--context", "all", "--neighbor_mode", "raw", "--test", "true",
             "--bf16", "true", "--tokenizer_path", "byte:50272",
             "--per_device_val_batch_size", "4", "--val_steps_per_epoch", "4",
             "--seed", "0", "--device", "cuda"]

SOURCE = "mmgl_tpu_torch/csrc/attention_fwd.cu"
# kernel wrapper -> (its plain version, the Pallas kernel it replaces)
KERNELS = {
    "flash_attention_allheads": ("allheads_attention_reference",
                                 "mmgl_tpu/ops/flash_attention.py:1283"),
    "fused_heads_attention": ("fused_heads_attention_reference",
                              "mmgl_tpu/ops/flash_attention.py:1152"),
}
# the main path's attention calls: (kernel, (B, S, H, D), causal, mask)
CASES = [
    ("flash_attention_allheads", (4, 640, 12, 64), True, "hole"),   # eval
    ("flash_attention_allheads", (4, 512, 12, 64), True, "prompt"),  # prefill
    ("fused_heads_attention", (24, 197, 12, 64), False, "ones"),    # CLIP
    ("flash_attention_allheads", (4, 640, 12, 64), False, "fully_masked"),
    ("fused_heads_attention", (24, 197, 12, 64), False, "fully_masked"),
]
# the case each kernel is timed at (bf16, as the main path runs it)
TIMED = {"flash_attention_allheads": 0, "fused_heads_attention": 2}
# (atol, rtol) by dtype name
TOLERANCES = {"bfloat16": (2e-2, 2e-2), "float32": (2e-5, 0.0)}
# whole-model fp32 check, card vs CPU: logits and loss
MODEL_ATOL = 1e-3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def make_mask(kind: str, b: int, s: int, seed: int):
    """(B, S) int32 key mask. "hole": a decoder-only batch, prompt padded to
    512 then summary padded to 128, so the valid keys have a hole;
    "prompt": right-padded prompts; "fully_masked": sample 0 all zero."""
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
    return worst


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
    launches = {name: getattr(fa, name).launches for name in KERNELS}
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
        fused = model(batch)
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


def time_kernels(fa, device, rounds: int = 5):
    """Phase 5: median ms of 20 runs each, in rounds of plain, kernel,
    kernel, plain, with CUDA events."""
    import torch

    times = {}
    for name, case_index in TIMED.items():
        args, kw = kernel_inputs(case_index, torch.bfloat16, device)
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
        _, shape, causal, _ = CASES[case_index]
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
    times = time_kernels(fa, device)

    print(json.dumps({"main_path": {
        "sections_per_s": rate, "peak_bytes": peak,
        "test_loss": results["loss"], "card": card}}))
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": worst[name], "ms": times[name]["kernel"],
         "plain_ms": times[name]["plain"]}
        for name, (_, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
