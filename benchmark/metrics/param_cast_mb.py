"""Model compute: megabytes (1e6 bytes) an update written by the casts
``layers.cast_at_use`` makes, a kept cast made again included (the
program's ``param_cast`` counter), mean over the profiled updates."""

from benchmark.spans import counted_mb


def read(ctx):
    return counted_mb(ctx, "param_cast")
