"""Model compute: megabytes (1e6 bytes) an update written by the norm
layers' input and output casts where the dtype changes (the program's
``norm_cast`` counter), mean over the profiled updates."""

from benchmark.spans import counted_mb


def read(ctx):
    return counted_mb(ctx, "norm_cast")
