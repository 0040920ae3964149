"""Attention kernels: the attention forwards' (K1, K2, K4) summed bound
time (benchmark/kernels/attn_fwd.py at the card's peaks, over the
launches the configuration's families count in the profiled updates and
the pairs their masks leave) over their summed device time, in
percent."""

from benchmark.roofline import share


def read(ctx):
    return share(ctx, "attn_fwd")
