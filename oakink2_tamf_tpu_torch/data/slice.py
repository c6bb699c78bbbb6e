"""Segment slicing (copy of oakink2_tamf_tpu/data/slice.py): resample a
mocap-rate segment into fixed-length clips.

The reference algorithm (dataset/setment_slice.py:10-35): choose a stride
("gap") so the sliced length lands in [min_len, max_len], emit `gap`
phase-shifted strided copies, zero-pad each to max_len.
"""

from __future__ import annotations

import numpy as np


def segment_slice_from_gap(
    traj: np.ndarray, gap: int, max_len: int, min_len: int
) -> tuple[list[np.ndarray], list[int]]:
    """Slice `traj` (first axis = time) into phase-shifted strided copies.

    Returns (list of [max_len, ...] zero-padded arrays, list of true lengths).
    """
    traj_len = int(traj.shape[0])
    if traj_len < min_len * gap:
        gap = traj_len // min_len
    elif traj_len > max_len * gap:
        gap = (traj_len + max_len - 1) // max_len
    gap = max(gap, 1)

    res, res_len = [], []
    for offset in range(gap):
        sliced = traj[offset::gap]
        n = int(sliced.shape[0])
        if not min_len <= n <= max_len:
            raise ValueError(f"slice of {n} frames outside [{min_len}, {max_len}] "
                             f"(gap {gap}, {traj_len} frames)")
        if n < max_len:
            pad = np.zeros((max_len - n, *sliced.shape[1:]), dtype=sliced.dtype)
            sliced = np.concatenate([sliced, pad], axis=0)
        res.append(sliced)
        res_len.append(n)
    return res, res_len


class SegmentSlice:
    from_gap = staticmethod(segment_slice_from_gap)
