"""Spans and counters of the training update, kept in memory while a
``torch.profiler`` session is on.

The switch is the profiler's own enabled flag, read once a span or count:
with no profiler on, ``span`` returns one shared no-op context and
``count`` returns at once, so an unprofiled run records nothing. A
profiled one (``cli``'s ``--profile_dir``, the benchmark's traced
updates, ``profile_steps``) records every span and count.

A span holds its name, its own id, its parent's id (the span open on the
same thread when it began), the id of the update it belongs to (a root
span's own id, shared by every span and count opened inside it), its
thread, and its start and end in ``time.time_ns()``: the epoch clock on
which the profiler's events lie once placed through its
``trace_start_ns``, so every device gap of a trace can be set against the
spans open when it began. Each span is also a
``torch.profiler.record_function`` range, which a Chrome trace shows. A
device span also records a CUDA event at its start and end on the current
stream; ``drain``, called after a device synchronize, reads their
milliseconds and returns and clears the records.

A counter sums bytes under the current update's id. The program's spans
and counters:

- ``update`` (the root, ``train/steps.py``), ``micro_batch``, ``forward``
  (the model's forward and loss of one micro-batch), ``batch_to_device``
  (``models/fusion.py``: the batch's fields moved to the device, inside
  ``forward``), ``backward``, ``optimizer`` (everything after the last
  backward). ``update``, ``forward``, ``backward`` and ``optimizer`` are
  device spans.
- ``param_cast``: bytes written by each cast ``layers.cast_at_use``
  makes, a kept cast made again included; ``norm_cast``: bytes written by
  the norm layers' input and output casts where the dtype changes.
"""

from __future__ import annotations

import itertools
import threading
import time
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler

_NOOP = nullcontext()


@dataclass
class Span:
    """One recorded span; times on the epoch clock (``time.time_ns()``),
    ``device_ms`` the CUDA events' interval of a device span."""
    name: str
    id: int
    parent: Optional[int]
    update: Optional[int]
    thread: int
    start_ns: int
    end_ns: int = 0
    device_ms: Optional[float] = None


class _Open:
    """A span while it is open."""

    def __init__(self, recorder: "Recorder", name: str, device: bool,
                 root: bool):
        self.recorder, self.name = recorder, name
        self.device, self.root = device, root

    def __enter__(self) -> Span:
        rec = self.recorder
        stack = rec._stack()
        sid = next(rec._ids)
        self.outer_update = rec.update
        if self.root:
            rec.update = sid
        self.span = Span(self.name, sid, stack[-1].id if stack else None,
                         rec.update, threading.get_ident(), time.time_ns())
        stack.append(self.span)
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.events = None
        if self.device and torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        return self.span

    def __exit__(self, *exc) -> bool:
        rec = self.recorder
        if self.events is not None:
            self.events[1].record()
        self.range.__exit__(*exc)
        self.span.end_ns = time.time_ns()
        rec._stack().pop()
        rec.update = self.outer_update
        rec._done.append((self.span, self.events))
        return False


class Recorder:
    """The process's spans and counts, recorded while a profiler is on."""

    def __init__(self):
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._done: List[Tuple[Span, Optional[Tuple]]] = []
        self._counts: Dict[Tuple[Optional[int], str], int] = {}
        self.update: Optional[int] = None

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, *, device: bool = False, root: bool = False):
        """A context that records the span ``name`` (``device``: with CUDA
        events; ``root``: it opens an update, whose id is its own)."""
        if not _profiler._is_profiler_enabled:
            return _NOOP
        return _Open(self, name, device, root)

    def count(self, name: str, written: torch.Tensor) -> None:
        """Add the bytes of ``written`` to the counter ``name`` of the
        current update."""
        if not _profiler._is_profiler_enabled:
            return
        key = (self.update, name)
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + written.nbytes

    def drain(self) -> Dict:
        """{"spans": the closed spans in the order they closed, "counts":
        {(update id, counter): bytes}}, and clear both. Call it after a
        device synchronize: it reads the device spans' events."""
        done, counts = self._done, self._counts
        self._done, self._counts = [], {}
        for span, events in done:
            if events is not None:
                span.device_ms = events[0].elapsed_time(events[1])
        return {"spans": [span for span, _ in done], "counts": counts}


_RECORDER = Recorder()
span = _RECORDER.span
count = _RECORDER.count
drain = _RECORDER.drain
