"""Readings of the program's own spans and counters, set against the
device trace on the epoch clock they share.

``recorded(ctx)`` drains the program's recorder (``adapters/spans.py``)
once, at the first reader of a traced run, when ``trace.profile`` has
synchronized, and keeps what it drained in ``ctx["spans"]`` for the
readers after it: ``{"spans": [...], "counts": {(update id, counter):
bytes}}``.
Each span carries ``name``, ``id``, ``parent``, ``update`` (the id of the
update span it lies in, which is that span's own id), ``thread``,
``start_ns`` and ``end_ns`` (``time.time_ns()``) and ``device_ms`` (the
interval of its CUDA events; None for a host span or off the card). A
program that records no spans leaves ``ctx["spans"]`` None, and every
reader here then returns None.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Tuple

from benchmark.adapters.spans import drain
from benchmark.trace import Trace, union


def recorded(ctx: Dict) -> Optional[Dict]:
    """The profiled updates' spans and counts: drained from the program at
    the first call of a traced run and kept in ``ctx["spans"]``; None
    where the program records none or the run was not traced."""
    if "spans" not in ctx:
        ctx["spans"] = drain() if "trace" in ctx else None
    return ctx["spans"]


def updates(records: Dict) -> List:
    """The update spans: each is its own update."""
    return [s for s in records["spans"] if s.id == s.update]


def per_update_ms(records: Dict, name: str,
                  device: bool = False) -> Optional[List[float]]:
    """For each update span, the summed milliseconds of the spans ``name``
    inside it: on the host's clock, or (``device``) between their CUDA
    events. None where no update was recorded or a span has no device
    time."""
    sums = {u.id: 0.0 for u in updates(records)}
    if not sums:
        return None
    for s in records["spans"]:
        if s.name != name or s.update not in sums:
            continue
        if device:
            if s.device_ms is None:
                return None
            sums[s.update] += s.device_ms
        else:
            sums[s.update] += (s.end_ns - s.start_ns) / 1e6
    return list(sums.values())


def mean_ms(ctx: Dict, name: str, device: bool = False) -> Optional[float]:
    """Milliseconds an update in the spans ``name``, mean over the traced
    updates."""
    got = recorded(ctx)
    ms = None if got is None else per_update_ms(got, name, device)
    return None if ms is None else statistics.fmean(ms)


def counted_mb(ctx: Dict, counter: str) -> Optional[float]:
    """The counter's bytes an update, mean over the traced updates, in
    MB (1e6 bytes); 0 where the program counted none."""
    got = recorded(ctx)
    ids = set() if got is None else {u.id for u in updates(got)}
    if not ids:
        return None
    total = sum(b for (u, name), b in got["counts"].items()
                if name == counter and u in ids)
    return total / len(ids) / 1e6


def innermost(records: Dict, thread: int, t_ns: int):
    """The innermost span open on ``thread`` at ``t_ns``: of those whose
    interval holds it, the last begun; None where none does."""
    best = None
    for s in records["spans"]:
        if (s.thread == thread and s.start_ns <= t_ns < s.end_ns
                and (best is None or s.start_ns > best.start_ns)):
            best = s
    return best


def gaps(trace: Trace) -> List[Tuple[float, float]]:
    """The device's idle gaps between consecutive busy intervals of the
    trace (seconds on the epoch clock)."""
    busy = union([(s, e) for _, s, e in trace.events])
    return [(a[1], b[0]) for a, b in zip(busy, busy[1:])]


def idle_by_span(trace: Trace, records: Dict) -> Dict[str, float]:
    """Idle seconds of the trace's gaps, summed by the innermost span open
    on the updates' thread when each gap began ("outside the updates"
    where none was)."""
    ups = updates(records)
    thread = ups[0].thread if ups else None
    out: Dict[str, float] = {}
    for s, e in gaps(trace):
        span = innermost(records, thread, int(s * 1e9))
        label = "outside the updates" if span is None else span.name
        out[label] = out.get(label, 0.0) + (e - s)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))
