"""The host's cost of launching K1, K3, K4 and K7 on the card, and their
bodies' device time.

    python -m mmgl_tpu_torch.launch_cost [--calls 200] [--only k1,k4,k7]

At K1's and K3's shapes of PERF.md §6, bf16 with a pad hole in the int32
key mask: the main path's attention (4, 640, 12, 64) causal, Roberta's
(44, 512, 12, 64), family 7's (4, 205, 32, 80), OPT-2.7B's (4, 640, 32,
80) and OPT-6.7B's (4, 640, 32, 128), causal but Roberta's, it times:
  * ``k1``: ``flash_attention_allheads`` without autograd (the eval pass);
  * ``k1_grad``: the same with q, k, v requiring a gradient (the training
    forward: the autograd node and, in the wgmma design, the row stats);
  * ``k3``: ``flash_attention_allheads_bwd`` called directly;
  * ``k1_k3``: one forward and its backward through autograd.
At K4's rows of PERF.md §6 (the cross-attention of T5-base, q (4, 128,
12, 64) against 512 keys, of MPT-2.7B, q (4, 640, 32, 80), and family 7,
q (4, 205, 32, 80), against a 64-token memory, and at D 128, q (4, 640,
32, 128); prefix tuning's 704 queries against 724 keys, causal; causal
self-attention with the row stats at (4, 2048, 16, 64) and (4, 1024, 32,
80 / 128)):
  * ``k4``: ``flash_attention`` without autograd (T5's test pass), or
    ``flash_attention_stats`` at the rows with the stats.
At K7's (T5-base's encoder (4, 512, 12, 64) and config 2's at 576 tokens
with their bias, its decoder, 128 queries against 128 keys, and its
prefixed decoder, against 20 + 128 keys, causal with their bias, each
without and with dropout 0.1; its training cross-attention, 128 queries
against 512 keys, no bias, dropout 0.1), the bias as the tree's T5 stack
hands it (rows padded to a multiple of 8 by ``padded_bias`` where the tree
has it, else contiguous):
  * ``k7``: ``flash_attention_bias`` without autograd (the test pass);
  * ``k7_grad``: the same with q, k, v and the bias requiring a gradient
    (the training forward).
``--only`` takes the kinds to run (k1 runs K1's and K3's cases).
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
# K4: (B, Sq, Sk, H, D), causal, with the row stats
K4_SHAPES = [((4, 128, 512, 12, 64), False, False),
             ((4, 640, 64, 32, 80), False, False),
             ((4, 205, 64, 32, 80), False, False),
             ((4, 640, 64, 32, 128), False, False),
             ((4, 704, 724, 12, 64), True, False),
             ((4, 2048, 2048, 16, 64), True, True),
             ((4, 1024, 1024, 32, 80), True, True),
             ((4, 1024, 1024, 32, 128), True, True)]
# K7: (B, Sq, Sk, H), causal, bias, dropout rate
K7_SHAPES = [((4, 512, 512, 12), False, True, rate) for rate in (0.0, 0.1)]
K7_SHAPES += [((4, 576, 576, 12), False, True, rate) for rate in (0.0, 0.1)]
K7_SHAPES += [((4, 128, 128, 12), True, True, rate) for rate in (0.0, 0.1)]
K7_SHAPES += [((4, 128, 148, 12), True, True, rate) for rate in (0.0, 0.1)]
K7_SHAPES += [((4, 128, 512, 12), False, False, 0.1)]


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


def k4_cases(dims, causal, stats, device):
    b, sq, sk, h, d = dims
    g = torch.Generator().manual_seed(sq + sk + d)
    q, k, v = (torch.randn(b, s, h, d, generator=g).to(device, torch.bfloat16)
               for s in (sq, sk, sk))
    mask = torch.ones(b, sk, dtype=torch.int32)
    for i in range(b):
        mask[i, sk - 1 - 3 * i:] = 0
    mask = mask.to(device)

    def k4():
        if stats:
            fa.flash_attention_stats(q, k, v, kv_mask=mask, causal=causal)
        else:
            fa.flash_attention(q, k, v, kv_mask=mask, causal=causal)

    return {"k4_stats" if stats else "k4": k4}


def k7_cases(dims, causal, with_bias, rate, device):
    b, sq, sk, h = dims
    g = torch.Generator().manual_seed(sq + sk)
    q = (torch.randn(b, sq, h, 64, generator=g) * 0.125).to(
        device, torch.bfloat16)
    k, v = (torch.randn(b, sk, h, 64, generator=g).to(device, torch.bfloat16)
            for _ in range(2))
    bias = None
    if with_bias:
        bias = torch.randn(1, h, sq, sk, generator=g).to(device,
                                                         torch.bfloat16)
        bias = getattr(fa, "padded_bias", lambda t: t)(bias)
    mask = torch.ones(b, sk, dtype=torch.int32)
    for i in range(b):
        mask[i, sk - 1 - 3 * i:] = 0
    mask = mask.to(device)
    seed = torch.tensor([12345, 678], dtype=torch.int64, device=device)
    kw = dict(kv_mask=mask, causal=causal, scale=1.0, dropout_rate=rate,
              dropout_seed=seed)
    qg, kg, vg, bg = (None if t is None else t.detach().requires_grad_()
                      for t in (q, k, v, bias))

    def k7():
        fa.flash_attention_bias(q, k, v, bias=bias, **kw)

    def k7_grad():
        fa.flash_attention_bias(qg, kg, vg, bias=bg, **kw)

    return {"k7": k7, "k7_grad": k7_grad}


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
    parser.add_argument("--only", default="k1,k4,k7",
                        help="the kinds to run: k1 (K1 and K3), k4, k7")
    args = parser.parse_args(argv)
    only = set(args.only.split(","))
    if not torch.cuda.is_available():
        print("launch_cost: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    print(f"card: {card()}")
    runs = []
    if "k1" in only:
        runs += [(shape, causal, None, cases(shape, causal, device))
                 for shape, causal in SHAPES]
    if "k4" in only:
        runs += [(dims, causal, None, k4_cases(dims, causal, stats, device))
                 for dims, causal, stats in K4_SHAPES]
    if "k7" in only:
        runs += [(dims, causal, rate,
                  k7_cases(dims, causal, with_bias, rate, device))
                 for dims, causal, with_bias, rate in K7_SHAPES]
    for shape, causal, rate, fns in runs:
        for name, fn in fns.items():
            host, wall = host_and_wall_us(fn, args.calls, device)
            ops, kernels = profile(fn, 50, device)
            row = {"case": name, "shape": list(shape), "causal": causal,
                   "dropout": rate, "host_us": host,
                   "wall_us": wall, "host_ops_us": ops,
                   "kernels_us": kernels,
                   "device": torch.cuda.get_device_name(0)}
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
