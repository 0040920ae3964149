"""Model compute: device milliseconds an update between the CUDA events of
the program's ``backward`` spans (each micro-batch's backward), mean
over the profiled updates; None off the card."""

from benchmark.spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "backward", device=True)
