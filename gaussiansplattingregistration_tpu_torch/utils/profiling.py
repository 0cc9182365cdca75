"""Tracing of the port: spans and counters where the work happens, on
`torch.profiler`'s clock.

Tracing is on while a `torch.profiler` session records, or inside
`recording()`. Off, `span` and `count` cost one check each and record
nothing. On, a span

- opens a profiler range of its name, so that the Chrome trace of
  `trace(log_dir)` and a profiler's `events()` show it as a host operation
  (and device idle during it falls to it, not to bare Python);
- records its name, its parent span, a request id and its host start and
  end (`time.perf_counter_ns`);
- once CUDA is initialised, records a pair of timing events on the current
  stream. Their interval is the span's device time: from the stream
  reaching the span's start until it passes its end, device idle inside
  the span included.

The range is a function-scope record (the profiler's own
`_RecordFunctionFast`), not `torch.profiler.record_function`: a user-scope
record also puts a `gpu_user_annotation` on the device timeline, which a
reduction of the trace would count as device work. It also costs less.

Spans nest through a thread-local stack. A span without a parent starts a
new request id and the spans below it share it; work that runs on another
thread (autograd's backward) passes the id on (`request_id()` in the
forward, `span(name, request=...)` in the backward).

On the card a span costs tens of microseconds while tracing is on, most of
it the two event records; off, well under one.

`count(name, n)` adds a value the host already holds (a shape, a loop
count), never a device read. `snapshot()` sums by span name, reading the
events' intervals where they have completed, and never synchronizes.

    with profiling.trace("traces/"):       # Chrome trace with the spans
        ...
    profiling.reset()
    with profiling.recording():            # no profiler: spans only
        ...
    torch.cuda.synchronize()
    profiling.snapshot()["spans"]["raster.frame"]["device_s"]
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import NamedTuple, Optional

import torch

_RANGE = torch._C._profiler._RecordFunctionFast
_profiler_enabled = torch.autograd._profiler_enabled

MAX_PENDING = 100_000   # event pairs waiting for `snapshot()`; more are dropped
MAX_RECORDS = 100_000   # the newest span records kept for `records()`


class Record(NamedTuple):
    """One closed span: its name, its parent's name (None at a root), its
    request id and its host start and end in `perf_counter_ns`."""

    name: str
    parent: Optional[str]
    request: int
    start_ns: int
    end_ns: int


class Tracer:
    """What the spans and counters of a process record: per-name totals
    (count, host ns, self host ns, resolved device s), counters, the event
    pairs not yet resolved, and the newest records."""

    def __init__(self):
        self.lock = threading.Lock()
        self.forced = 0
        self.local = threading.local()
        self.max_pending = MAX_PENDING
        self.records = collections.deque(maxlen=MAX_RECORDS)
        self.next_request = 0
        self.totals: dict = {}
        self.counters: dict = {}
        self.pending: list = []
        self.dropped = 0

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def reset(self) -> None:
        with self.lock:
            self.totals = {}
            self.counters = {}
            self.pending = []
            self.dropped = 0
            self.records.clear()

    def close(self, sp: "_Span", end_ns: int) -> None:
        host = end_ns - sp.start_ns
        with self.lock:
            t = self.totals.get(sp.name)
            if t is None:
                t = self.totals[sp.name] = [0, 0, 0, 0.0]
            t[0] += 1
            t[1] += host
            t[2] += host - sp.child_ns
            if sp.events is not None:
                self.pending.append((sp.name,) + sp.events)
            self.records.append(Record(sp.name, sp.parent, sp.request, sp.start_ns, end_ns))

    def snapshot(self) -> dict:
        with self.lock:
            waiting = []
            for name, start, end in self.pending:
                if start.query() and end.query():
                    self.totals[name][3] += start.elapsed_time(end) * 1e-3
                else:
                    waiting.append((name, start, end))
            self.pending = waiting
            return {
                "spans": {name: {"count": c, "host_s": h * 1e-9, "self_host_s": s * 1e-9,
                                 "device_s": d}
                          for name, (c, h, s, d) in self.totals.items()},
                "counters": dict(self.counters),
                "unresolved": dict(collections.Counter(name for name, _, _ in waiting)),
                "dropped": self.dropped,
            }


_TRACER = Tracer()


class _Span:
    """An open span (see the module docstring)."""

    __slots__ = ("name", "request", "parent", "child_ns", "range", "events", "start_ns")

    def __init__(self, name: str, request: Optional[int]):
        self.name = name
        self.request = request

    def __enter__(self):
        tr = _TRACER
        stack = tr.stack()
        up = stack[-1] if stack else None
        self.parent = up.name if up is not None else None
        if self.request is None:
            if up is not None:
                self.request = up.request
            else:
                with tr.lock:
                    tr.next_request += 1
                    self.request = tr.next_request
        self.child_ns = 0
        self.range = _RANGE(self.name)
        self.range.__enter__()
        self.events = None
        if torch.cuda.is_initialized():
            if len(tr.pending) < tr.max_pending:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
                self.events = (start, torch.cuda.Event(enable_timing=True))
            else:
                with tr.lock:
                    tr.dropped += 1
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        stack = _TRACER.stack()
        if stack and stack[-1] is self:
            stack.pop()
        if stack:
            stack[-1].child_ns += end_ns - self.start_ns
        self.range.__exit__(None, None, None)
        _TRACER.close(self, end_ns)
        return False


class _Off:
    """The span of tracing off: enters and exits, records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def enabled() -> bool:
    """Whether tracing is on: a profiler session records, or `recording()`."""
    return bool(_TRACER.forced or _profiler_enabled())


def span(name: str, request: Optional[int] = None):
    """A context manager marking a stage named `name`; `request` gives the
    request id of work that runs on another thread (see `request_id`)."""
    if _TRACER.forced or _profiler_enabled():
        return _Span(name, request)
    return _OFF


def request_id() -> Optional[int]:
    """The request id of this thread's innermost open span, or None."""
    stack = getattr(_TRACER.local, "stack", None)
    return stack[-1].request if stack else None


def count(name: str, n) -> None:
    """Adds `n`, a value the host holds, to the counter `name` while
    tracing is on."""
    if _TRACER.forced or _profiler_enabled():
        with _TRACER.lock:
            _TRACER.counters[name] = _TRACER.counters.get(name, 0) + n


def snapshot() -> dict:
    """The spans by name (`count`, `host_s`, `self_host_s` (less the
    children's host time) and `device_s`, the sum of the resolved event
    intervals), `counters`, `unresolved` (event pairs not yet completed,
    by span name) and `dropped` (spans past `MAX_PENDING` recorded without
    events). Never synchronizes: synchronize first for complete device
    times."""
    return _TRACER.snapshot()


def records() -> list:
    """The newest closed spans (at most `MAX_RECORDS`), oldest first."""
    with _TRACER.lock:
        return list(_TRACER.records)


def reset() -> None:
    """Clears the totals, the counters, the pending events and the records."""
    _TRACER.reset()


@contextlib.contextmanager
def recording():
    """Tracing on for the block without a profiler session."""
    with _TRACER.lock:
        _TRACER.forced += 1
    try:
        yield
    finally:
        with _TRACER.lock:
            _TRACER.forced -= 1


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """A `torch.profiler` trace of the block (CPU, and CUDA when a card is
    present) exported to `log_dir` as a Chrome/TensorBoard trace file,
    holding the program's spans; no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ):
        yield
