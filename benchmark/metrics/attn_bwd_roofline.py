"""Attention kernels: the attention backwards' (K3, K5, K6) summed bound
time (benchmark/kernels/attn_bwd.py) over their summed device time, in
percent."""

from benchmark.roofline import share


def read(ctx):
    return share(ctx, "attn_bwd")
