"""Step timing (port of oakink2_tamf_tpu/runtime/profiler.py `StepTimer`)."""

from __future__ import annotations

import time
from collections import deque
from typing import Optional


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
