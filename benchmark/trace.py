"""The traced sub-window: the device's activity under ``torch.profiler``.

Only CUDA activity is recorded (host activity would stretch the host's
launch loop). Busy time is the union of the kernel and copy intervals; each
idle gap is named by what the host was doing when it began, from the marks
the harness sets on the host's clock (the profiler's timestamps are on the
same clock since the epoch, which ``trace_start_ns`` anchors).

``kind`` sorts kernel names into the kinds ``mmgl_tpu_torch/
profile_steps.py`` uses (K1+K2+K4 for the attention forwards, K3+K5+K6 for
their backwards, GEMM, copies and casts, ...); it is a frozen copy, so
that a later rename in the program does not move the benchmark's
yardstick.
"""

from __future__ import annotations

import re
import time
from bisect import bisect_right
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

KINDS = [("K7", ("attention_bias_fwd",)),
         ("K8/K9", ("bias_bwd_",)),
         ("K1+K2+K4", ("attention_fwd",)),
         ("K3+K5+K6", ("attention_bwd", "attention_delta")),
         ("GEMM", ("gemm", "cutlass", "xmma", "sm90", "cublas", "nvjet")),
         ("optimizer", ("multi_tensor", "foreach")),
         ("layer_norm", ("layer_norm", "layernorm")),
         ("reductions", ("softmax", "logsumexp", "reduce")),
         ("copies and casts", ("copy", "cast", "memcpy", "memset")),
         ("rng", ("philox", "uniform", "random", "distribution")),
         ("index", ("scatter", "gather", "index"))]
OTHER = "elementwise and other"

_TC_BODY = re.compile(r"attention_(fwd|bwd_dkdv|bwd_dq)_tc_kernel<([^>]*)>")
_WG_FWD = re.compile(r"allheads_fwd_kernel<\d+, (true|false), [^<>]*<[^<>]*>, "
                     r"[^,<>]+, (true|false), (true|false)")
_WG_BWD = re.compile(r"allheads_(dkdv|dq|dq_dkdv)_kernel<")
_WG_BWD_FLAGS = re.compile(r"allheads_(dkdv|dq|dq_dkdv)_kernel<\d+, "
                           r"(?:[^<>]*<[^<>]*>, )+"
                           r"[^,<>]+, (true|false), (true|false)")


def kind(name: str) -> str:
    wg = _WG_FWD.search(name)
    if wg:
        stats_only = wg.group(1) == "true"
        if "true" in wg.group(2, 3):
            return "K8/K9" if stats_only else "K7"
        return "K3+K5+K6" if stats_only else "K1+K2+K4"
    if _WG_BWD.search(name):
        flags = _WG_BWD_FLAGS.search(name)
        return ("K8/K9" if flags and "true" in flags.group(2, 3)
                else "K3+K5+K6")
    body = _TC_BODY.search(name)
    if body:
        args = [a.strip() for a in body.group(2).split(",")]
        flags = args[5:7] if body.group(1) == "fwd" else args[4:6]
        if "true" in flags:
            return ("K7" if body.group(1) == "fwd" and args[1] == "false"
                    else "K8/K9")
    n = name.lower()
    return next((k for k, subs in KINDS if any(s in n for s in subs)), OTHER)


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


@dataclass
class Trace:
    """What the profiled sub-window recorded. Times in seconds; ``events``
    (name, start, end) on the host's epoch clock."""
    wall_s: float
    events: List[Tuple[str, float, float]]
    marks: List[Tuple[float, str]] = field(default_factory=list)
    updates: int = 0

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in union([(s, e) for _, s, e in
                                            self.events]))

    def seconds_by_kind(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, s, e in self.events:
            k = kind(name)
            out[k] = out.get(k, 0.0) + (e - s)
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def idle_by_host(self, start: float, end: float) -> Dict[str, float]:
        """Idle seconds of [start, end], summed by the host's phase at each
        gap's start."""
        busy = union([(s, e) for _, s, e in self.events])
        gaps, t = [], start
        for s, e in busy:
            if s > t:
                gaps.append((t, min(s, end)))
            t = max(t, e)
        if t < end:
            gaps.append((t, end))
        times = [m[0] for m in self.marks]
        out: Dict[str, float] = {}
        for s, e in gaps:
            i = bisect_right(times, s) - 1
            label = self.marks[i][1] if i >= 0 else "before the first mark"
            out[label] = out.get(label, 0.0) + (e - s)
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def profile(run: Callable[[Callable[[str], None]], int],
            device: torch.device) -> Tuple[Trace, float, float]:
    """(trace, start, end): ``run(mark)`` under the profiler with CUDA
    activity only, between two device synchronizes; ``run`` returns the
    updates it ran and calls ``mark(phase)`` as the host changes phase.
    On a CPU device (the tests) the host's operations stand in for the
    device's."""
    from torch.profiler import ProfilerActivity

    marks: List[Tuple[float, str]] = []
    cuda = device.type == "cuda"
    activity = ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU

    def mark(phase: str) -> None:
        marks.append((time.time_ns() / 1e9, phase))

    def sync() -> None:
        if cuda:
            torch.cuda.synchronize(device)

    sync()
    with torch.profiler.profile(activities=[activity]) as prof:
        start_wall = time.perf_counter()
        start = time.time_ns() / 1e9
        updates = run(mark)
        mark("synchronizing")
        sync()
        wall = time.perf_counter() - start_wall
        end = start + wall
    base = prof.profiler.kineto_results.trace_start_ns() / 1e9
    events = [(e.name, base + e.time_range.start / 1e6,
               base + e.time_range.end / 1e6)
              for e in prof.events()
              if e.device_type.name == ("CUDA" if cuda else "CPU")]
    return Trace(wall, events, marks, updates), start, end

