"""Device step: device milliseconds an update between the CUDA events of
the program's ``optimizer`` spans (everything after the last backward),
mean over the profiled updates; None off the card."""

from benchmark.spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "optimizer", device=True)
