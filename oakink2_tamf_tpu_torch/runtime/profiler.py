"""Tracing and step timing (port of oakink2_tamf_tpu/runtime/profiler.py).

`trace(log_dir)` records a device trace around a block with
torch.profiler (CPU activity and, on a CUDA device, CUDA activity) and
writes it as Chrome-trace JSON under `log_dir` when the block ends;
`DeviceTrace` is the same as start/stop calls, for a span of a loop.
`annotate(name)` names a region in the trace."""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from typing import Iterator, Optional

import torch


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


@contextlib.contextmanager
def trace(log_dir: str, device: str | torch.device = "cuda") -> Iterator[DeviceTrace]:
    """Capture a device trace around a code block (written when it ends)."""
    tr = DeviceTrace(log_dir, device).start()
    try:
        yield tr
    finally:
        tr.stop()


def annotate(name: str):
    """Named region visible in profiler traces."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Rolling wall-clock step timer with throughput accounting. The clock is
    the host's: a caller that wants device time synchronises before tick()."""

    def __init__(self, window: int = 50):
        self.times: deque[float] = deque(maxlen=window)
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        """Call once per step; returns the last step duration (or None)."""
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self.times.append(dt)
        self._last = now
        return dt

    @property
    def mean_step_time(self) -> float:
        return sum(self.times) / len(self.times) if self.times else float("nan")

    def throughput(self, items_per_step: int) -> float:
        m = self.mean_step_time
        return items_per_step / m if m == m and m > 0 else float("nan")
