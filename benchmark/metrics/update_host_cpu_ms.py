"""Launch path: the calling thread's CPU milliseconds per update
(time.thread_time around the update and its loss read), mean over the
window."""

import statistics


def read(ctx):
    cpus = ctx["cpus"]
    return statistics.fmean(cpus) * 1e3 if cpus else None
