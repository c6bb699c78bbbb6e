"""The port's spans and counters, and its device trace.

`span(name)` marks a part of the program (a train step, MANO, a mask, a
sampler step) and `count(name, value)` adds to a named counter. Both record
only while a torch.profiler session runs: off, a span costs one read of the
flag torch sets for that session and returns a shared no-op context, and a
count does nothing. On, a span enters `torch.profiler.record_function(name)`,
so the session's own trace shows it, and keeps one record: its name, its
host start and end on `time.time_ns()` (the clock of the profiler's events),
its parent span and its request id (the train step's number or the
`generate` call's, given to the top-level span and inherited by its
children). A span made with `device=True` also records a pair of CUDA events
on the current stream, so its device time is the stream's time between
them; on a CPU device its device time is its host time. Each session starts
a fresh record, and `report()` reads the newest (after the session ended
too): per span name the count and the host and device seconds, inclusive
and self (the duration less what the child spans cover), per counter its
sum, and the raw records. At most MAX_SPANS records are kept: a longer
session drops its oldest.

`DeviceTrace` writes a session (CPU and, on a CUDA device, CUDA activity) as
Chrome-trace JSON, which shows the spans beside the operators and kernels.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import threading
import time

import torch
import torch.autograd.profiler as _ap

MAX_SPANS = 1 << 20
_NO_SPAN = contextlib.nullcontext()
_FOLD = 1024  # a counter's pending device sums are folded into one at this many


class DeviceTrace:
    """A torch.profiler trace from start() to stop(); stop() writes
    `log_dir/trace_<pid>_<ns>.json` and returns its path. On a CUDA device
    the device is synchronised first, so the trace holds every kernel
    launched inside the span."""

    def __init__(self, log_dir: str, device: str | torch.device = "cuda"):
        self.log_dir = log_dir
        self.device = torch.device(device)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=activities)
        self.path: str | None = None

    def start(self) -> "DeviceTrace":
        self._prof.start()
        return self

    def stop(self) -> str:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.stop()
        os.makedirs(self.log_dir, exist_ok=True)
        self.path = os.path.join(self.log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        self._prof.export_chrome_trace(self.path)
        return self.path


# ---------------------------------------------------------------------------
# Spans and counters
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SpanRecord:
    """One span: `id` counts the session's spans from 0 in the order they
    opened; `parent` is the enclosing span's id (None at the top);
    `end_ns` is None while open; `device_s` is filled by report()."""

    id: int
    name: str
    parent: int | None
    request: int | None
    start_ns: int
    end_ns: int | None = None
    device: bool = False
    events: tuple | None = None  # (start, end) torch.cuda.Event
    device_s: float | None = None


@dataclasses.dataclass
class SpanTotals:
    """A span name's closed spans: their number and their seconds, host and
    device, inclusive and self. Device seconds are None for host-only spans."""

    n: int = 0
    host_s: float = 0.0
    host_self_s: float = 0.0
    device_s: float | None = None
    device_self_s: float | None = None


@dataclasses.dataclass
class Report:
    spans: dict[str, SpanTotals]
    counters: dict[str, int]
    records: list[SpanRecord]  # the closed spans, in the order they opened


class _Session:
    """The records of one profiler session."""

    def __init__(self, number: int, free_events: list):
        self.number = number
        self.spans: collections.deque[SpanRecord] = collections.deque(maxlen=MAX_SPANS)
        self.next_id = 0
        self.ints: dict[str, int] = {}
        self.tensors: dict[str, list[torch.Tensor]] = {}
        self.free_events = free_events  # CUDA events to reuse


class _Recorder:
    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()  # this thread's open spans
        self.started = 0  # profiler sessions started in this process
        self.session = _Session(0, [])

    def current(self) -> _Session:
        """The session record, fresh when a profiler session started since."""
        s = self.session
        if s.number != self.started:
            free = s.free_events
            for r in s.spans:
                if r.events is not None and r.end_ns is not None:  # an open span still records its end
                    free.extend(r.events)
            s = self.session = _Session(self.started, free)
        return s

    def open(self, name: str, device: bool, request: int | None) -> SpanRecord:
        stack = self.local.__dict__.setdefault("stack", [])
        parent = stack[-1] if stack else None
        with self.lock:
            s = self.current()
            rec = SpanRecord(s.next_id, name, parent.id if parent is not None else None,
                             request if request is not None or parent is None else parent.request,
                             0, device=device)
            s.next_id += 1
            s.spans.append(rec)
            if device and torch.cuda.is_initialized():
                free = s.free_events
                rec.events = tuple(free.pop() if free else torch.cuda.Event(enable_timing=True) for _ in range(2))
        stack.append(rec)
        rec.start_ns = time.time_ns()
        if rec.events is not None:
            rec.events[0].record()
        return rec

    def close(self, rec: SpanRecord) -> None:
        if rec.events is not None:
            rec.events[1].record()
        rec.end_ns = time.time_ns()
        self.local.stack.pop()

    def add(self, name: str, value) -> None:
        with self.lock:
            s = self.current()
            if isinstance(value, torch.Tensor):
                parts = s.tensors.setdefault(name, [])
                parts.append(value.detach().sum(dtype=torch.int64))
                if len(parts) >= _FOLD:
                    parts[:] = [torch.stack(parts).sum()]
            else:
                s.ints[name] = s.ints.get(name, 0) + int(value)

    def report(self) -> Report:
        with self.lock:
            s = self.current()
            records = [r for r in s.spans if r.end_ns is not None]
            ints = dict(s.ints)
            tensors = {k: list(v) for k, v in s.tensors.items()}
        if torch.cuda.is_initialized() and (tensors or any(r.events is not None for r in records)):
            torch.cuda.synchronize()
        for r in records:
            if r.events is not None:
                r.device_s = r.events[0].elapsed_time(r.events[1]) * 1e-3
            elif r.device:
                r.device_s = (r.end_ns - r.start_ns) * 1e-9
        child_host: dict[int, float] = collections.defaultdict(float)
        child_dev: dict[int, float] = collections.defaultdict(float)
        for r in records:
            if r.parent is not None:
                child_host[r.parent] += (r.end_ns - r.start_ns) * 1e-9
                if r.device_s is not None:
                    child_dev[r.parent] += r.device_s
        spans: dict[str, SpanTotals] = {}
        for r in records:
            t = spans.setdefault(r.name, SpanTotals())
            host = (r.end_ns - r.start_ns) * 1e-9
            t.n += 1
            t.host_s += host
            t.host_self_s += host - child_host[r.id]
            if r.device_s is not None:
                t.device_s = (t.device_s or 0.0) + r.device_s
                t.device_self_s = (t.device_self_s or 0.0) + r.device_s - child_dev[r.id]
        counters = dict(ints)
        for k, parts in tensors.items():
            counters[k] = counters.get(k, 0) + sum(int(p) for p in parts)
        return Report(spans, counters, records)


_RECORDER = _Recorder()


def _on_profiler_start(_start=_ap._run_on_profiler_start):
    """torch's hook at the start of every profiler session (it sets the flag
    `span` reads), also counting the sessions for the recorder."""
    _RECORDER.started += 1
    _start()


if getattr(_ap._run_on_profiler_start, "__module__", None) != __name__:
    _ap._run_on_profiler_start = _on_profiler_start


class _Span:
    __slots__ = ("name", "device", "request", "rec", "fn")

    def __init__(self, name: str, device: bool, request: int | None):
        self.name, self.device, self.request = name, device, request

    def __enter__(self):
        self.rec = _RECORDER.open(self.name, self.device, self.request)
        self.fn = torch.profiler.record_function(self.name)
        self.fn.__enter__()
        return self.rec

    def __exit__(self, *exc):
        self.fn.__exit__(*exc)
        _RECORDER.close(self.rec)


def span(name: str, *, device: bool = False, request: int | None = None):
    """A context manager that records the block as span `name` while a
    profiler session runs (module docstring); `request` sets the request id
    of a top-level span."""
    if not _ap._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name, device, request)


def recording() -> bool:
    """Whether spans and counts are being recorded: the caller of `count`
    skips work that only feeds a count when they are not."""
    return _ap._is_profiler_enabled


def count(name: str, value: int | torch.Tensor) -> None:
    """Add `value` (an int, or a tensor whose elements are summed on its
    device, with no synchronise) to counter `name` while a profiler session
    runs."""
    if _ap._is_profiler_enabled:
        _RECORDER.add(name, value)


def report() -> Report:
    """The newest session's spans and counters; synchronises the device once."""
    return _RECORDER.report()
