"""The timed window and, with `--trace 1`, its device trace.

The trace is torch.profiler's CUDA activity (the device's kernels, copies and
sets, and the host's CUDA runtime calls; the host's operators are not
recorded, which would slow a host-bound window several-fold) started just
before the window and stopped after its closing synchronise. The window is
the host clock's span from its start to that synchronise (the profiler's
timestamps are on the same clock), so the arithmetic reads the timed window
and not the first and last events of the trace. The busy share is the
union of the kernel, memcpy and memset intervals inside the window over its
length (chip_smoke.py's `_busy_share`, with the window fixed). The reader
keeps per-kernel device time and counts, and the idle time between device
activities summed by the CUDA runtime call the host was in (a launch, a
copy, a synchronise), or "host code" where it was in none.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: dict  # name -> [device seconds, count]
    device_ops: list  # [[name, seconds], ...] most time first
    idle_gaps: list  # [[host op, seconds], ...] longest first
    n_kernels: int

    def kernel_time(self, needle: str) -> tuple[float, int]:
        """Device seconds and launches of the kernels whose name holds `needle`."""
        t = n = 0
        for name, (s, c) in self.kernels.items():
            if needle in name:
                t += s
                n += c
        return t, n


def _kind(e) -> str:
    k = e.activity_type() if callable(getattr(e, "activity_type", None)) else ""
    return str(k).lower().rsplit(".", 1)[-1]


def _on_device(e) -> bool:
    return not str(e.device_type()).endswith("CPU")


def device_kind(e) -> str | None:
    """"kernel", "gpu_memcpy" or "gpu_memset" for a device activity, else None."""
    if not _on_device(e) or "annotation" in _kind(e):
        return None
    name = e.name()
    if name.startswith("Memcpy") or "memcpy" in _kind(e):
        return "gpu_memcpy"
    if name.startswith("Memset") or "memset" in _kind(e):
        return "gpu_memset"
    return "kernel"


def _union(starts: np.ndarray, ends: np.ndarray, lo: int, hi: int):
    """Busy ns of the union of [start, end) clipped to [lo, hi), and the gaps
    between the merged intervals as (start, end) arrays."""
    s = np.clip(starts, lo, hi)
    e = np.clip(ends, lo, hi)
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > run_end[:-1]
    seg_start = s[new]
    seg_end = np.append(run_end[np.flatnonzero(new)[1:] - 1], run_end[-1])
    busy = int(np.sum(seg_end - seg_start))
    gap_s = np.concatenate([[lo], seg_end])
    gap_e = np.concatenate([seg_start, [hi]])
    keep = gap_e > gap_s
    return busy, gap_s[keep], gap_e[keep]


def summarize(prof, lo: int, hi: int, top: int = 10, kinds=DEVICE_KINDS) -> TraceSummary:
    """The trace read over the window [lo, hi) (host clock, ns). `kinds`: the
    activity types that count as device work (the tests' CPU rehearsal
    passes cpu_op, and its host operators then stand for the device's)."""
    events = prof.profiler.kineto_results.events()
    if kinds == DEVICE_KINDS:
        dev = [e for e in events if device_kind(e) is not None]
    else:
        dev = [e for e in events if _kind(e) in kinds]
    if not dev:
        seen = sorted({(str(e.device_type()), _kind(e)) for e in events})
        raise RuntimeError(f"the trace holds no device activity (CUPTI saw no kernel); kinds seen: {seen}")
    starts = np.array([e.start_ns() for e in dev], np.int64)
    ends = np.array([e.end_ns() for e in dev], np.int64)
    inside = (ends > lo) & (starts < hi)
    kernels: dict[str, list] = {}
    n_kernels = 0
    for e, ok in zip(dev, inside):
        if not ok:
            continue
        rec = kernels.setdefault(e.name(), [0.0, 0])
        rec[0] += (min(e.end_ns(), hi) - max(e.start_ns(), lo)) * 1e-9
        rec[1] += 1
        n_kernels += (device_kind(e) if kinds == DEVICE_KINDS else _kind(e)) in ("kernel", "cpu_op")
    busy, gs, ge = _union(starts[inside], ends[inside], lo, hi)
    device_ops = [[n, v[0]] for n, v in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]]
    return TraceSummary(
        window_s=(hi - lo) * 1e-9, busy_s=busy * 1e-9, kernels=kernels, device_ops=device_ops,
        idle_gaps=_label_gaps(events, gs, ge, top), n_kernels=n_kernels,
    )


def _label_gaps(events, gs, ge, top: int) -> list:
    """The idle time summed by the host call that overlapped each of the 200
    longest gaps most (the outermost on a tie), "host code" where none did."""
    ops = [e for e in events if not _on_device(e) and "annotation" not in _kind(e)]
    if len(gs) == 0:
        return []
    if not ops:
        return [["host code", float(np.sum(ge - gs)) * 1e-9]]
    s = np.array([e.start_ns() for e in ops], np.int64)
    e_ = np.array([e.end_ns() for e in ops], np.int64)
    names = [e.name() for e in ops]
    by_label: dict[str, float] = {}
    for i in np.argsort(gs - ge)[:200]:
        a, b = gs[i], ge[i]
        ov = np.minimum(e_, b) - np.maximum(s, a)
        j = int(np.argmax(ov))
        label = names[j] if ov[j] > 0 else "host code"
        by_label[label] = by_label.get(label, 0.0) + (b - a) * 1e-9
    return [[k, v] for k, v in sorted(by_label.items(), key=lambda kv: -kv[1])[:top]]


class Window:
    """start() / stop() around the timed work. stop() synchronises the device
    first and reads the allocator's peak since start() (`memory_peak`);
    with `trace`, the profiler runs from just before start() to just after
    stop(), and `summary` holds its reading."""

    def __init__(self, device, trace: bool):
        self.device = torch.device(device)
        self.trace = trace
        self.summary: TraceSummary | None = None
        self.memory_peak = 0
        self._prof = None

    def start(self) -> float:
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        if self.trace:
            act = torch.profiler.ProfilerActivity.CUDA if cuda else torch.profiler.ProfilerActivity.CPU
            self._prof = torch.profiler.profile(activities=[act])
            self._prof.start()
        self._ns = time.time_ns()
        self.t0 = time.perf_counter()
        return self.t0

    def stop(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t1 = time.perf_counter()
        if self.device.type == "cuda":
            self.memory_peak = torch.cuda.max_memory_allocated(self.device)
        if self.trace:
            hi = time.time_ns()
            self._prof.stop()
            kinds = DEVICE_KINDS if self.device.type == "cuda" else ("cpu_op",)
            self.summary = summarize(self._prof, self._ns, hi, kinds=kinds)
            self._prof = None
        return self.t1

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0
