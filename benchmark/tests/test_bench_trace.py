"""The trace arithmetic: the union of device intervals inside the window, the
gaps between them, and the reading of a profile."""

import numpy as np
import torch

from benchmark.lib import trace


def test_union_clips_to_the_window_and_merges_overlaps():
    s = np.array([0, 5, 12, 14, 30], np.int64)
    e = np.array([8, 10, 16, 15, 40], np.int64)
    busy, gs, ge = trace._union(s, e, 2, 35)
    assert busy == (10 - 2) + (16 - 12) + (35 - 30)
    assert list(zip(gs, ge)) == [(10, 12), (16, 30)]


def test_a_cpu_profile_reads_its_window():
    w = trace.Window("cpu", True)
    w.start()
    x = torch.randn(64, 64)
    for _ in range(20):
        x = torch.tanh(x @ x)
    w.stop()
    s = w.summary
    assert 0 < s.busy_s <= s.window_s <= w.seconds * 1.5
    assert s.n_kernels > 20 and s.device_ops and len(s.device_ops) <= 10
    assert all(v >= 0 for _, v in s.idle_gaps)
