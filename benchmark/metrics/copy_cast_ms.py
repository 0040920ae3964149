"""Model compute: device milliseconds per update in copies and casts
(benchmark/trace.py's frozen kinds), over the profiled updates."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not tr.updates:
        return None
    s = tr.seconds_by_kind().get("copies and casts")
    return None if s is None else 1e3 * s / tr.updates
