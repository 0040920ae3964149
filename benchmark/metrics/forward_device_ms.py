"""Model compute: device milliseconds an update between the CUDA events of
the program's ``forward`` spans (each micro-batch's forward and loss),
mean over the profiled updates; None off the card."""

from benchmark.spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "forward", device=True)
