"""The host's cost of launching K1 and K3 on the card, and their bodies'
device time.

    python -m mmgl_tpu_torch.launch_cost [--calls 200]

At K1's and K3's shapes of PERF.md §6, bf16 with a pad hole in the int32
key mask: the main path's attention (4, 640, 12, 64) causal, Roberta's
(44, 512, 12, 64), family 7's (4, 205, 32, 80), OPT-2.7B's (4, 640, 32,
80) and OPT-6.7B's (4, 640, 32, 128), causal but Roberta's, it times:
  * ``k1``: ``flash_attention_allheads`` without autograd (the eval pass);
  * ``k1_grad``: the same with q, k, v requiring a gradient (the training
    forward: the autograd node and, in the wgmma design, the row stats);
  * ``k3``: ``flash_attention_allheads_bwd`` called directly;
  * ``k1_k3``: one forward and its backward through autograd.
For each, the host's microseconds a call (the loop's enqueue time over
``--calls`` calls, the card's queue never full where the bodies are shorter
than the host's work; the median of 5 loops) and the wall's (to a
synchronize), and under
``torch.profiler`` (CPU and CUDA activity) the host ops of a call by self
time and the device time of each kernel a call. Prints the card's name and
power limit, and one JSON line a case. Imports nothing beyond the port's
public wrappers, so the script runs unchanged in an earlier tree of the
port (copy it into that tree's ``mmgl_tpu_torch/``), to compare the two in
one chip call.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

from mmgl_tpu_torch.ops import flash_attention as fa

# (B, S, H, D), causal
SHAPES = [((4, 640, 12, 64), True), ((44, 512, 12, 64), False),
          ((4, 205, 32, 80), True), ((4, 640, 32, 80), True),
          ((4, 640, 32, 128), True)]


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"


def inputs(shape, device):
    b, s, h, d = shape
    g = torch.Generator().manual_seed(s + h + d)
    q, k, v, dout = (torch.randn(b, s, h, d, generator=g).to(
        device, torch.bfloat16) for _ in range(4))
    mask = torch.ones(b, s, dtype=torch.int32)
    cut = s * 4 // 5
    for i in range(b):
        mask[i, cut // 2 + 7 * i:cut] = 0
        mask[i, cut + 20 + 5 * i:] = 0
    return q, k, v, dout, mask.to(device)


def cases(shape, causal, device):
    q, k, v, dout, mask = inputs(shape, device)
    out = fa.flash_attention_allheads(q, k, v, kv_mask=mask, causal=causal)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

    def k1():
        fa.flash_attention_allheads(q, k, v, kv_mask=mask, causal=causal)

    def k1_grad():
        fa.flash_attention_allheads(qg, kg, vg, kv_mask=mask, causal=causal)

    def k3():
        fa.flash_attention_allheads_bwd(q, k, v, mask, out, dout,
                                        causal=causal)

    def k1_k3():
        o = fa.flash_attention_allheads(qg, kg, vg, kv_mask=mask,
                                        causal=causal)
        torch.autograd.backward(o, dout)

    return {"k1": k1, "k1_grad": k1_grad, "k3": k3, "k1_k3": k1_k3}


def host_and_wall_us(fn, calls, device, repeats=5):
    """(host us a call, wall us a call), each the median of ``repeats``
    loops of ``calls`` calls back to back, after a warm-up (a shared host's
    time varies from loop to loop)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize(device)
    host, wall = [], []
    for _ in range(repeats):
        start = time.perf_counter()
        for _ in range(calls):
            fn()
        enqueued = time.perf_counter()
        torch.cuda.synchronize(device)
        done = time.perf_counter()
        host.append((enqueued - start) / calls * 1e6)
        wall.append((done - start) / calls * 1e6)
    return statistics.median(host), statistics.median(wall)


def profile(fn, calls, device):
    """(host ops {name: self us a call}, kernels {name: device us a call})
    of ``calls`` calls under torch.profiler."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize(device)
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize(device)
    host, kernels = {}, {}
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0))
        if e.self_cpu_time_total > 0:
            host[e.key] = round(e.self_cpu_time_total / calls, 2)
        if dev > 0 and e.device_type.name == "CUDA":
            kernels[e.key] = round(dev / calls, 2)
    top = dict(sorted(host.items(), key=lambda kv: -kv[1])[:12])
    return top, kernels


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--calls", type=int, default=200)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("launch_cost: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    print(f"card: {card()}")
    for shape, causal in SHAPES:
        for name, fn in cases(shape, causal, device).items():
            host, wall = host_and_wall_us(fn, args.calls, device)
            ops, kernels = profile(fn, 50, device)
            row = {"case": name, "shape": list(shape), "causal": causal,
                   "host_us": host,
                   "wall_us": wall, "host_ops_us": ops,
                   "kernels_us": kernels,
                   "device": torch.cuda.get_device_name(0)}
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
