"""Device step: the device's idle milliseconds an update in the gaps of
the profiled updates' trace that begin while the update's thread is
inside a ``batch_to_device`` span (benchmark/spans.py), mean over the
profiled updates."""

from benchmark.spans import idle_by_span, recorded, updates


def read(ctx):
    records, tr = recorded(ctx), ctx.get("trace")
    if records is None or tr is None or not tr.events:
        return None
    n = len(updates(records))
    if not n:
        return None
    return 1e3 * idle_by_span(tr, records).get("batch_to_device", 0.0) / n
