"""Loop and loader: the host's milliseconds in the loader's next() per
update of the window (the harness's clock around it), mean."""

import statistics


def read(ctx):
    waits = ctx["waits"]
    return statistics.fmean(waits) * 1e3 if waits else None
