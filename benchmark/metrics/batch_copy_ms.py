"""Loop and loader: the host's milliseconds an update inside the
program's ``batch_to_device`` spans (each micro-batch's fields moved to
the device), mean over the profiled updates."""

from benchmark.spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "batch_to_device")
