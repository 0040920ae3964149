"""Time and trace the main path's steps on the card.

    python -m mmgl_tpu_torch.profile_steps [--decode] [--train]
        [--model opt-125m|t5-base|opt-350m] [--embedding]

Both parts run at the full width of one of chip_smoke.py's paths: OPT-125M
(the default), T5-base or OPT-350M at its 2048-token window (prompt 1920 +
summary 128; run it under MMGL_BLOCKED_BWD=1 for K6, as chip_smoke.py's
phase 9 does), with CLIP ViT-B/16, task=section, context=all,
raw neighbours, bf16 compute, seeded random weights, the synthetic corpus;
with --embedding, context=section_all and the embedding neighbour mode
(the frozen Roberta-base tower; with t5-base, BASELINE config 2, as
chip_smoke.py's phase 10). Batches are staged on the card
before anything is timed, except where the loader's batches are named.

--decode  the test pass's batch of 4: the eval step, the prefill
          (``greedy_generate`` with one new token) and the 32-token
          generate, each timed to a device synchronize, 15 rounds after 2
          warm-up rounds; one decode step is (generate - prefill) / 31 of
          the medians, of the walls and of the host CPU times. Then the
          prefill and the generate once each under ``torch.profiler``.
--train   the training update (batch 4 x 4 micro-batches): update walls on
          the loader's batches and on staged ones (with their host CPU
          times), then 3 updates under ``torch.profiler``, with the device
          ms of each one's ``update``, ``forward``, ``backward`` and
          ``optimizer`` spans (utils/spans.py; forward and backward summed
          over its micro-batches).

The host CPU time of a call is the calling thread's CPU time until the
call returns, before the synchronize: the launch loop's own cost, which
other tenants of the host's cores stretch far less than they stretch the
wall (it includes any wait for the device inside the call; the thread
clock may tick in 10 ms, so read it over long calls).

A profiled run records the card's activity only (no host ops, which would
stretch the host's launch loop), and reports its own wall to a synchronize,
the device busy time (the union of the kernel and copy intervals), the idle
share 1 - busy / wall of that same run, the count of device operations,
device time by kind and the top kernels. The profiler still stretches the
host's loop, so that idle share is an upper bound; each part also gives
1 - busy / (the median unprofiled wall of the same work, same process). Prints the card's name and power
limit first, then a line and one JSON object per part. Needs a CUDA GPU;
the --decode part runs on any tree of the port that has ``cli.prepare``.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import time
from typing import Callable, Dict, List, Tuple

import torch

# the byte tokenizer padded to each model's vocabulary
VOCAB = {"opt-125m": "byte:50272", "t5-base": "byte:32128",
         "opt-350m": "byte:50272"}
# the models profiled at other than the default 512 + 128 tokens
LENGTHS = {"opt-350m": ["--max_input_length", "1920",
                        "--max_output_length", "128"]}
# (kind, substrings of a kernel's name as the profiler shows it, demangled
# without the source's namespace), first match wins
KINDS = [("K7", ("attention_bias_fwd",)),     # csrc/attention_bias_fwd.cu
         ("K8/K9", ("bias_bwd_",)),           # csrc/attention_bias_bwd.cu
         ("K1+K2+K4", ("attention_fwd",)),    # csrc/attention_fwd.cu
         # csrc/attention_bwd.cu and attention_blocked_bwd.cu, whose fp32
         # tile kernels (attention_bwd_tiles.cuh) K3, K5 and K6 share
         ("K3+K5+K6", ("attention_bwd", "attention_delta")),
         ("GEMM", ("gemm", "cutlass", "xmma", "sm90", "cublas", "nvjet")),
         ("optimizer", ("multi_tensor", "foreach")),
         ("layer_norm", ("layer_norm", "layernorm")),
         ("reductions", ("softmax", "logsumexp", "reduce")),
         ("copies and casts", ("copy", "cast", "memcpy", "memset")),
         ("rng", ("philox", "uniform", "random", "distribution")),
         ("index", ("scatter", "gather", "index"))]


# the mma.sync bodies (csrc/attention_fwd_tc.cuh, sweep/mma_sync_tiles.cuh)
# with their template arguments: the forward's <D, kStatsOnly, kWarps,
# kStages, kMinBlocks, kBias, kDropout, TB, T>, the backward tiles' <D,
# kWarps, kStages, kMinBlocks, kBias, kDropout, TB, T> (T, the element
# type, bf16 or fp16)
_TC_BODY = re.compile(r"attention_(fwd|bwd_dkdv|bwd_dq)_tc_kernel<([^>]*)>")
# the wgmma bodies (csrc/allheads_wgmma.cuh): the forward's <D, kStatsOnly,
# Shape<...>, T, kBias, kDropout, TB> (K1, K4 and, in its bias form, K7;
# stats-only, the stats passes of K3, K5 and K8/K9), the dK/dV and dQ
# bodies' <D, Shape<...>, T, kBias, kDropout, TB> (K3's, K5's and K6's; in
# their bias form K8/K9's) and both in one grid, <D, Shape<...>,
# Shape<...>, T, kBias, kDropout, TB> (K5's and, in the bias form, K8/K9's)
_WG_FWD = re.compile(r"allheads_fwd_kernel<\d+, (true|false), [^<>]*<[^<>]*>, "
                     r"[^,<>]+, (true|false), (true|false)")
_WG_BWD = re.compile(r"allheads_(dkdv|dq|dq_dkdv)_kernel<")
_WG_BWD_FLAGS = re.compile(r"allheads_(dkdv|dq|dq_dkdv)_kernel<\d+, "
                           r"(?:[^<>]*<[^<>]*>, )+"
                           r"[^,<>]+, (true|false), (true|false)")


def _kind(name: str) -> str:
    wg = _WG_FWD.search(name)
    if wg:
        stats_only = wg.group(1) == "true"
        if "true" in wg.group(2, 3):
            return "K8/K9" if stats_only else "K7"
        return "K3+K5+K6" if stats_only else "K1+K2+K4"
    if _WG_BWD.search(name):
        flags = _WG_BWD_FLAGS.search(name)
        return ("K8/K9" if flags and "true" in flags.group(2, 3)
                else "K3+K5+K6")
    body = _TC_BODY.search(name)
    if body:
        args = [a.strip() for a in body.group(2).split(",")]
        # the bias form (kBias or kDropout) is K7's forward, and in its
        # stats-only form and the backward tiles K8/K9's (whose stats pass
        # without a bias is K5's code, counted there)
        flags = args[5:7] if body.group(1) == "fwd" else args[4:6]
        if "true" in flags:
            return ("K7" if body.group(1) == "fwd" and args[1] == "false"
                    else "K8/K9")
    n = name.lower()
    return next((k for k, subs in KINDS if any(s in n for s in subs)),
                "elementwise and other")


def busy_us(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def device_profile(fn: Callable[[], object], device, top: int = 12) -> Dict:
    """Run fn once under torch.profiler with CUDA activity only; see the
    module docstring for what is returned."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - start) * 1e3
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    if not events:
        raise RuntimeError("the profiler recorded no device activity")
    ranges = [(e.time_range.start, e.time_range.end) for e in events]
    busy_ms = busy_us(ranges) / 1e3
    kinds: Dict[str, float] = {}
    names: Dict[str, float] = {}
    for e in events:
        us = e.time_range.end - e.time_range.start
        kinds[_kind(e.name)] = kinds.get(_kind(e.name), 0.0) + us / 1e3
        names[e.name] = names.get(e.name, 0.0) + us / 1e3
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms, "device_ops": len(events),
            "ms_by_kind": dict(sorted(kinds.items(), key=lambda kv: -kv[1])),
            "top_kernels_ms": dict(sorted(names.items(),
                                          key=lambda kv: -kv[1])[:top])}


def _timed_ms(fn: Callable[[], object], device) -> Tuple[float, float]:
    """(wall ms to a device synchronize, host CPU ms of the call)."""
    torch.cuda.synchronize(device)
    start, cpu = time.perf_counter(), time.thread_time()
    fn()
    cpu_ms = (time.thread_time() - cpu) * 1e3
    torch.cuda.synchronize(device)
    return (time.perf_counter() - start) * 1e3, cpu_ms


def _staged(batch: Dict, device) -> Dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def main_argv(model: str, embedding: bool = False) -> List[str]:
    neighbors = (["--context", "section_all", "--neighbor_mode", "embedding",
                  "--position_type", "none"] if embedding
                 else ["--context", "all", "--neighbor_mode", "raw"])
    return ["--model_name_or_path", model, "--task", "section", *neighbors,
            "--bf16", "true", "--tokenizer_path", VOCAB[model], "--seed",
            "0", "--device", "cuda"] + LENGTHS.get(model, [])


def profile_decode(cli, device, model: str, rounds: int = 15,
                   embedding: bool = False) -> Dict:
    from mmgl_tpu_torch.train.generate import greedy_generate

    args, _ = cli.parse_cli(main_argv(model, embedding) + [
        "--test", "true", "--per_device_val_batch_size", "4"])
    test = cli.prepare(args, device)
    batch = _staged(next(iter(test.loader)), device)
    steps = cli.MAX_NEW_TOKENS - 1
    parts = {"eval_step": lambda: test.eval_step(batch),
             "prefill": lambda: greedy_generate(test.model, batch,
                                                max_new_tokens=1),
             "generate": lambda: greedy_generate(
                 test.model, batch, max_new_tokens=cli.MAX_NEW_TOKENS)}
    walls = {name: [] for name in parts}
    cpus = {name: [] for name in parts}
    for r in range(2 + rounds):
        for name, fn in parts.items():
            ms, cpu_ms = _timed_ms(fn, device)
            if r >= 2:
                walls[name].append(ms)
                cpus[name].append(cpu_ms)
    med = {name: statistics.median(w) for name, w in walls.items()}
    med_cpu = {name: statistics.median(c) for name, c in cpus.items()}
    prefill = device_profile(parts["prefill"], device)
    generate = device_profile(parts["generate"], device)
    for name, prof in (("prefill", prefill), ("generate", generate)):
        prof["idle_share_of_median_wall"] = 1.0 - prof["busy_ms"] / med[name]
    return {"batch": 4, "rounds": rounds, "wall_ms": walls,
            "median_ms": med, "host_cpu_ms": cpus,
            "median_host_cpu_ms": med_cpu,
            "decode_step_ms": (med["generate"] - med["prefill"]) / steps,
            "decode_step_host_cpu_ms":
                (med_cpu["generate"] - med_cpu["prefill"]) / steps,
            "device_ops_per_decode_step":
                (generate["device_ops"] - prefill["device_ops"]) / steps,
            "profile_prefill": prefill, "profile_generate": generate}


def profile_train(cli, device, model_name: str,
                  embedding: bool = False) -> Dict:
    from mmgl_tpu_torch.train.optim import build_optimizer
    from mmgl_tpu_torch.train.steps import make_train_step
    from mmgl_tpu_torch.utils import spans

    args, _ = cli.parse_cli(main_argv(model_name, embedding) + [
        "--per_device_train_batch_size", "4", "--grad_accumulation_steps",
        "4"])
    tok, model, _, (train_ds, _, _) = cli._build(args, device)
    optimizer, scheduler = build_optimizer(args, model)
    step = make_train_step(model, optimizer, scheduler, args.decoder_only,
                           args.max_input_length, tok.pad_token_id, 4,
                           args.grad_clip)
    loader = cli.PrefetchLoader(train_ds, batch_size=16, num_workers=2)
    batches = list(loader)[:8]
    gen = cli.dropout_generator(0, 0, device)
    for b in batches[:3]:                              # warm-up
        step(b, gen)
    loader_ms = [_timed_ms(lambda: step(b, gen), device) for b in batches[3:]]
    staged = [_staged(b, device) for b in batches[:4]]
    staged_ms = [_timed_ms(lambda: step(b, gen), device) for b in staged]
    host_cpu = {"update_host_cpu_ms_loader": [c for _, c in loader_ms],
                "update_host_cpu_ms_staged": [c for _, c in staged_ms]}
    loader_ms, staged_ms = [w for w, _ in loader_ms], [w for w, _ in staged_ms]

    def three_updates():
        for b in staged[:3]:
            step(b, gen)

    prof = device_profile(three_updates, device, top=25)
    split: Dict[str, Dict[int, float]] = {}
    for span in spans.drain()["spans"]:
        if span.device_ms is not None:
            per = split.setdefault(span.name, {})
            per[span.update] = per.get(span.update, 0.0) + span.device_ms
    prof["idle_share_of_median_wall"] = 1.0 - prof["busy_ms"] / 3 / (
        statistics.median(staged_ms))
    torch.cuda.synchronize(device)
    return {"sections_per_update": 16, "update_ms_loader": loader_ms,
            "update_ms_staged": staged_ms, **host_cpu,
            "span_device_ms": {k: list(v.values()) for k, v in split.items()},
            "profile_3_updates": prof,
            "peak_bytes": torch.cuda.max_memory_allocated(device)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--decode", action="store_true")
    parser.add_argument("--train", action="store_true")
    parser.add_argument("--model", default="opt-125m", choices=sorted(VOCAB))
    parser.add_argument("--embedding", action="store_true")
    ns = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_steps: no CUDA device is visible")
    from mmgl_tpu_torch import cli

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True, check=True).stdout.strip())
    device = torch.device("cuda", 0)
    if ns.decode:
        got = profile_decode(cli, device, ns.model, embedding=ns.embedding)
        print(f"[decode] median ms {got['median_ms']}, host CPU ms "
              f"{got['median_host_cpu_ms']}; one decode step "
              f"{got['decode_step_ms']:.4f} ms, host CPU "
              f"{got['decode_step_host_cpu_ms']:.4f} ms, "
              f"{got['device_ops_per_decode_step']:.1f} device ops; idle "
              f"share of generate {got['profile_generate']['idle_share']:.4f}"
              f" (of the median wall "
              f"{got['profile_generate']['idle_share_of_median_wall']:.4f})")
        print(json.dumps({"decode": got, "model": ns.model,
                          "embedding": ns.embedding}))
    if ns.train:
        got = profile_train(cli, device, ns.model, embedding=ns.embedding)
        prof = got["profile_3_updates"]
        print(f"[train] update ms on loader batches {got['update_ms_loader']}"
              f", staged {got['update_ms_staged']}; host CPU ms "
              f"{got['update_host_cpu_ms_loader']}, staged "
              f"{got['update_host_cpu_ms_staged']}; 3 profiled updates: wall "
              f"{prof['wall_ms']:.2f} ms, busy {prof['busy_ms']:.2f} ms, idle "
              f"share {prof['idle_share']:.4f} (of the median staged wall "
              f"{prof['idle_share_of_median_wall']:.4f}); device ms of "
              f"each profiled update's spans {got['span_device_ms']}")
        print(json.dumps({"train": got, "model": ns.model,
                          "embedding": ns.embedding}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
