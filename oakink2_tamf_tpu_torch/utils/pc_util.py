"""Point-cloud helpers (copy of oakink2_tamf_tpu/utils/pc_util.py; the
reference dev_fn/util/pc_util.py role)."""

from __future__ import annotations

import numpy as np


def depth_to_pointcloud(
    depth: np.ndarray, cam_intr: np.ndarray, depth_scale: float = 1.0,
    mask: np.ndarray | None = None,
) -> np.ndarray:
    """depth [H, W] + intrinsics [3, 3] -> points [N, 3] (float32) in the
    camera frame, one per pixel of positive depth (and inside `mask`), in
    row-major pixel order; arithmetic in float64."""
    H, W = depth.shape
    fx, fy = cam_intr[0, 0], cam_intr[1, 1]
    cx, cy = cam_intr[0, 2], cam_intr[1, 2]
    ys, xs = np.mgrid[0:H, 0:W]
    z = depth.astype(np.float64) * depth_scale
    valid = z > 0
    if mask is not None:
        valid &= mask.astype(bool)
    x = (xs - cx) * z / fx
    y = (ys - cy) * z / fy
    return np.stack([x[valid], y[valid], z[valid]], axis=-1).astype(np.float32)


def spatial_sort_indices(points: np.ndarray, leaf: int = 128) -> np.ndarray:
    """Permutation making contiguous `leaf`-sized blocks spatially compact
    (balanced recursive median split along the widest axis).

    Same `np.argpartition` calls as the JAX package, so the permutation is
    identical. Used on the canonical object clouds at collate time and on the
    MANO template (core/mano.hand_template_perm): the culled h2o kernel's
    region/tile bounds are tight only on compact blocks. Correctness never
    depends on it, only speed."""
    points = np.asarray(points)
    n = points.shape[0]
    out: list[np.ndarray] = []

    def rec(ids: np.ndarray) -> None:
        if len(ids) <= leaf:
            out.append(ids)
            return
        p = points[ids]
        ax = int(np.argmax(p.max(axis=0) - p.min(axis=0)))
        # split at a multiple of `leaf` so blocks never straddle the cut
        half = max(leaf, (len(ids) // 2 // leaf) * leaf)
        part = np.argpartition(p[:, ax], half)
        rec(ids[part[:half]])
        rec(ids[part[half:]])

    rec(np.arange(n))
    return np.concatenate(out)
